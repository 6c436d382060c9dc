"""The ``smoke`` campaign of the port (counterpart of
``repro/experiments/cells/smoke_cells.py``, ported as written) — three
tiny cells (seconds each) exercising every campaign-runner code path: a
spec-graph sweep, a measure-mode sweep, and a dependent compute report.
Run twice, the second pass must be 100% cache hits (the
content-addressed caching contract).

Not part of the ``paper`` campaign: results land wherever
``--results-dir`` points and are never checked in.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import (Cell, derived_claims, emit,
                                              load_envelope, register_cell)
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.sweep import Sweep

_LRS = (0.02, 0.1)
_SEEDS = (0, 1)
_NS = (1, 4)


def _grid_specs(steps: int = 12):
    base = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=8,
                      minibatch=4, base_lr=0.05,
                      lr_policy="staleness_inverse", optimizer="momentum",
                      seed=0),
        problem="mlp_teacher", steps=steps)
    return list(Sweep.over(base, base_lr=list(_LRS), seed=list(_SEEDS)))


def _grid_derive(results, params, device=None):
    errs = {r.tag: r.metrics["test_error"] for r in results}
    mean = float(np.mean(list(errs.values())))
    emit("smoke_grid/mean_test_error", f"{mean:.4f}",
         f"{len(results)} grid points")
    return {"test_errors": errs, "mean_test_error": mean,
            "claims": {"all_errors_finite":
                       all(np.isfinite(v) for v in errs.values())}}


def _measure_specs(steps: int = 200):
    base = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=8,
                      minibatch=4, seed=0),
        steps=steps)
    return list(Sweep.over(base, n_softsync=list(_NS)))


def _measure_derive(results, params, device=None):
    sig = {f"n={n}": r.staleness["mean"] for n, r in zip(_NS, results)}
    for k, v in sig.items():
        emit(f"smoke_measure/{k}/mean_staleness", f"{v:.2f}", "")
    return {"mean_staleness": sig,
            "claims": {"staleness_grows_with_n":
                       sig[f"n={_NS[-1]}"] > sig[f"n={_NS[0]}"]}}


def _report(results_dir: str = None, device=None):
    grid = (load_envelope("smoke_grid", results_dir) or {}).get("derived", {})
    meas = (load_envelope("smoke_measure", results_dir) or {}).get(
        "derived", {})
    out = {
        "grid_mean_test_error": grid.get("mean_test_error"),
        "measure_staleness": meas.get("mean_staleness", {}),
        "claims": {"deps_present": bool(grid) and bool(meas)},
    }
    emit("smoke_report/deps_present", out["claims"]["deps_present"], "")
    return [], out


register_cell(Cell(
    name="smoke_grid", result="smoke_grid",
    title="Smoke: tiny LR x seed spec-graph sweep",
    specs=_grid_specs, derive=_grid_derive,
    claims=derived_claims("all_errors_finite"),
    campaigns=("smoke",),
    params={"steps": 12}, quick_params={"steps": 6},
    checkpoint_every=2))

register_cell(Cell(
    name="smoke_measure", result="smoke_measure",
    title="Smoke: measure-mode staleness sweep",
    specs=_measure_specs, derive=_measure_derive,
    claims=derived_claims("staleness_grows_with_n"),
    campaigns=("smoke",),
    params={"steps": 200}, quick_params={"steps": 100}))

register_cell(Cell(
    name="smoke_report", result="smoke_report",
    title="Smoke: dependent report over the other smoke cells",
    compute=_report, deps=("smoke_grid", "smoke_measure"),
    needs_results_dir=True, campaigns=("smoke",),
    claims=derived_claims("deps_present")))
