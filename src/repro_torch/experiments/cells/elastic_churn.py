"""Cell ``elastic`` of the port (counterpart of
``repro/experiments/cells/elastic_churn.py``, ported as written) — elastic
clusters on the calibrated Table-1 workload
(DESIGN.md §7): accuracy/runtime curves for (no churn | 10% crash-restart |
backup-b hardsync, b ∈ {0, 1, 4}), multi-seed.

Spec construction runs a dry measure-mode schedule to size the churn
window off the no-churn horizon — deterministic, so the spec-graph (and
its content hashes) are stable across sessions; the dry run is memoized
per epochs value because it costs a schedule pass.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import (Cell, derived_claims, emit,
                                        register_cell)
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.sweep import Sweep
from repro_torch.membership import MembershipTimeline

LAM = 16
MU = 4
MODEL_MB = 300            # Table-1 adversarial model size
DURATION = f"calibrated:base:{MODEL_MB}mb"
SEEDS = (0, 1, 2)
BACKUPS = (0, 1, 4)
CRASH_FRACTION = 0.10     # 10% of λ crash-restarts
EVAL_EVERY = 32

_SCENARIOS = ("none", "crash_restart") + tuple(
    f"hardsync_b{b}" for b in BACKUPS)
_SETUP_MEMO = {}


def _steps(run_cfg: RunConfig, epochs: float) -> int:
    from repro_torch.experiments.problems import get_problem, updates_for_epochs
    dataset = get_problem("mlp_teacher").dataset_size
    return updates_for_epochs(epochs, MU, run_cfg.gradients_per_update,
                              dataset, group_size=run_cfg.group_size)


def _crash_timeline(horizon: float) -> MembershipTimeline:
    n_crash = max(1, int(round(CRASH_FRACTION * LAM)))
    victims = range(n_crash)
    return MembershipTimeline.crash_restart(
        victims, crash_at=0.25 * horizon, restart_after=0.20 * horizon)


def _setup(epochs: float):
    if epochs not in _SETUP_MEMO:
        from repro_torch.experiments.driver import run as run_spec
        soft = RunConfig(protocol="softsync", n_softsync=1, n_learners=LAM,
                         minibatch=MU, base_lr=0.05,
                         lr_policy="staleness_inverse", optimizer="momentum")
        soft_steps = _steps(soft, epochs)
        dry = run_spec(ExperimentSpec(run=soft, steps=soft_steps,
                                      duration=DURATION))
        churn = _crash_timeline(dry.runtime["simulated_time"])
        hard = RunConfig(protocol="hardsync", n_learners=LAM, minibatch=MU,
                         base_lr=0.05, lr_policy="sqrt_scale",
                         optimizer="momentum")
        hard_steps = _steps(hard, epochs)
        _SETUP_MEMO[epochs] = (soft, hard, soft_steps, hard_steps, churn)
    return _SETUP_MEMO[epochs]


def _spec(run_cfg: RunConfig, steps: int, tag: str) -> ExperimentSpec:
    return ExperimentSpec(run=run_cfg, problem="mlp_teacher", steps=steps,
                          duration=DURATION, eval_every=EVAL_EVERY, tag=tag)


def _sweeps(epochs: float):
    soft, hard, soft_steps, hard_steps, churn = _setup(epochs)
    return {
        "none": Sweep.over(_spec(soft, soft_steps, "none"), seed=SEEDS),
        "crash_restart": Sweep.over(
            _spec(soft.replace(membership=churn), soft_steps,
                  "crash_restart"), seed=SEEDS),
        **{f"hardsync_b{b}": Sweep.over(
            _spec(hard.replace(backup=b), hard_steps, f"hardsync_b{b}"),
            seed=SEEDS)
           for b in BACKUPS},
    }


def specs(epochs: float = 2.0):
    return [s for sweep in _sweeps(epochs).values() for s in sweep]


def _mean_std(rows):
    errs = [r.metrics["test_error"] for r in rows]
    times = [r.runtime["simulated_time"] for r in rows]
    return {"test_error_mean": float(np.mean(errs)),
            "test_error_std": float(np.std(errs)),
            "train_s_mean": float(np.mean(times)),
            "train_s_std": float(np.std(times)),
            "curve": rows[0].curve}


def derive(results, params, device=None):
    """Records → curves and claims (pure in the records; ``device`` unused)."""
    epochs = params["epochs"]
    _, _, soft_steps, hard_steps, churn = _setup(epochs)
    stats = {}
    for i, name in enumerate(_SCENARIOS):
        rows = results[i * len(SEEDS):(i + 1) * len(SEEDS)]
        stats[name] = _mean_std(rows)
        emit(f"elastic_churn/{name}",
             f"err={stats[name]['test_error_mean']:.4f}",
             f"train_s={stats[name]['train_s_mean']:.0f} "
             f"std={stats[name]['test_error_std']:.4f}")

    t = {b: stats[f"hardsync_b{b}"]["train_s_mean"] for b in BACKUPS}
    e = {b: stats[f"hardsync_b{b}"]["test_error_mean"] for b in BACKUPS}
    noise = 2.0 * max(stats["hardsync_b0"]["test_error_std"],
                      stats["hardsync_b1"]["test_error_std"],
                      stats["none"]["test_error_std"], 1e-3)
    claims = {
        "backup_runtime_strictly_decreasing":
            t[4] < t[1] < t[0],
        "backup1_buys_most_of_the_gap":
            (t[0] - t[1]) >= 0.35 * (t[0] - t[4]),
        "backup1_accuracy_within_noise":
            abs(e[1] - e[0]) <= noise,
        "crash_restart_converges":
            (stats["crash_restart"]["test_error_mean"]
             <= stats["none"]["test_error_mean"] + 0.05),
    }
    for k, v in claims.items():
        emit(f"elastic_churn/claims/{k}", v)

    return {
        "lambda": LAM, "mu": MU, "epochs": epochs, "model_mb": MODEL_MB,
        "seeds": list(SEEDS), "backups": list(BACKUPS),
        "updates": {"softsync": soft_steps, "hardsync": hard_steps},
        "churn_timeline": [{"t": ev.t, "learner": ev.learner,
                            "kind": ev.kind} for ev in churn.events],
        "scenarios": stats, "claims": claims,
        "noise_band": noise,
    }


register_cell(Cell(
    name="elastic", result="elastic_churn",
    title="Elastic churn + backup-hardsync curves",
    specs=specs, derive=derive,
    claims=derived_claims("backup_runtime_strictly_decreasing",
                          "backup1_buys_most_of_the_gap",
                          "backup1_accuracy_within_noise",
                          "crash_restart_converges"),
    params={"epochs": 2.0}, quick_params={"epochs": 0.5}))
