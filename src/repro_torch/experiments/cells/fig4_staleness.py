"""Cell ``fig4`` of the port (counterpart of
``repro/experiments/cells/fig4_staleness.py``, ported as written) — paper
Fig. 4: ⟨σ⟩ per update and the σ distribution.

Measure-mode spec-graph (``problem=None``): the schedule pass alone carries
the Fig.-4 statistics (host numpy, bitwise the reference's; no kernel
launches).  Claims: ⟨σ⟩ ≈ n for the n-softsync protocol and P(σ > 2n)
stays below 1e-3; a scenario sweep exercises the beyond-paper duration
models (two-speed, Pareto stragglers) at fixed (λ, n).
"""

from __future__ import annotations

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import Cell, Claim, emit, register_cell
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.sweep import Sweep

_LAM = 30
_NS = (1, 2, 4, _LAM)
_SCEN_N = 4
_CASES = (
    {"duration_model": "homogeneous", "tag": "homogeneous"},
    {"duration_model": "two_speed", "slow_fraction": 0.25,
     "slow_factor": 4.0, "tag": "two_speed"},
    {"duration_model": "pareto", "pareto_alpha": 1.5,
     "pareto_scale": 1.0, "tag": "pareto"},
)


def specs(steps: int = 4000):
    base = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_learners=_LAM, minibatch=128,
                      seed=11),
        steps=steps)
    main = list(Sweep.over(base, n_softsync=list(_NS)))
    scen = list(Sweep.over(
        base.replace(run=base.run.replace(n_softsync=_SCEN_N)),
        cases=[dict(c) for c in _CASES]))
    return main + scen


def derive(results, params, device=None):
    """Records → the Fig.-4 rows (pure in the records; ``device`` unused)."""
    out = {}
    for n, res in zip(_NS, results[:len(_NS)]):
        st = res.staleness
        row = {
            "n": n,
            "mean_staleness": st["mean"],
            "sigma_min": st["min"],
            "sigma_max": st["max"],
            "ring_buffer_K": st["ring_buffer_K"],
            "frac_exceeding_2n": st["frac_exceeding_2n"],
            "series_head": st["series_head"],
            "histogram": st["histogram"],
        }
        out[f"softsync_{n}"] = row
        claim = (abs(row["mean_staleness"] - n) <= max(0.6, 0.15 * n)
                 and row["frac_exceeding_2n"] < 1e-3)
        emit(f"fig4/softsync_n={n}/mean_staleness",
             f"{row['mean_staleness']:.2f}",
             f"claim<sigma>≈n:{'PASS' if claim else 'FAIL'}")
        emit(f"fig4/softsync_n={n}/frac_sigma>2n",
             f"{row['frac_exceeding_2n']:.5f}", "paper:<1e-4")
    for res in results[len(_NS):]:
        model = res.tag
        st = res.staleness
        row = {
            "mean_staleness": st["mean"],
            "sigma_max": st["max"],
            "frac_exceeding_2n": st["frac_exceeding_2n"],
            "simulated_time": res.runtime["simulated_time"],
        }
        out[f"scenario_{model}"] = row
        emit(f"fig4scenario/{model}/mean_staleness",
             f"{row['mean_staleness']:.2f}",
             f"sigma_max={row['sigma_max']:.0f} "
             f"time={row['simulated_time']:.0f}s")
    return out


register_cell(Cell(
    name="fig4", result="fig4_staleness",
    title="Fig. 4: staleness distribution per n-softsync",
    specs=specs, derive=derive,
    claims=(
        Claim("mean_staleness_tracks_n",
              lambda d: all(abs(d[f"softsync_{n}"]["mean_staleness"] - n)
                            <= max(0.6, 0.15 * n) for n in _NS)),
        Claim("staleness_tail_bounded",
              lambda d: all(d[f"softsync_{n}"]["frac_exceeding_2n"] < 1e-3
                            for n in _NS)),
    ),
    params={"steps": 4000}, quick_params={"steps": 1000}))
