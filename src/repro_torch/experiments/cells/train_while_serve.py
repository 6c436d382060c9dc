"""Cell ``serve`` of the port (counterpart of
``repro/experiments/cells/train_while_serve.py``, ported as written) —
train-while-serve on the calibrated Table-1 workload
(DESIGN.md §14): serving accuracy × staleness budget × tail latency, under
replica churn.

Spec construction runs a dry measure-mode schedule to size the fleet's
traffic and churn window off the training horizon — deterministic and
memoized per (epochs, requests).  The separate :func:`measure` cell feeds
the ``serving_requests_per_s`` CI floor in the ``bench_guard`` cell.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import (Cell, derived_claims, emit,
                                        register_cell)
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.sweep import Sweep
from repro_torch.serve.fleet import FleetConfig
from repro_torch.serve.publication import PublicationPolicy

LAM = 16
MU = 4
MODEL_MB = 300            # Table-1 adversarial model size
DURATION = f"calibrated:base:{MODEL_MB}mb"
SEEDS = (0, 1, 2)
BUDGETS = (1, 4, 16, 64)
REQUEST_SAMPLES = 32

_SCENARIOS = tuple(f"budget{b}" for b in BUDGETS) + ("on_demand",
                                                     "budget4_churn")
_SETUP_MEMO = {}


def _steps(run_cfg: RunConfig, epochs: float) -> int:
    from repro_torch.experiments.problems import get_problem, updates_for_epochs
    dataset = get_problem("mlp_teacher").dataset_size
    return updates_for_epochs(epochs, MU, run_cfg.gradients_per_update,
                              dataset, group_size=run_cfg.group_size)


def _fleet(horizon: float, requests: int, policy: PublicationPolicy,
           membership=()) -> FleetConfig:
    """Fleet sized to the calibrated horizon: traffic covers the whole run,
    a publication blocks ~H/640, service times keep the queue subcritical
    so p99 reflects publication stalls, not saturation."""
    return FleetConfig(replicas=2, policy=policy,
                       request_rate=requests / horizon,
                       request_samples=REQUEST_SAMPLES,
                       publish_cost_s=horizon / 640.0,
                       service_base_s=2.5e-4 * horizon,
                       service_per_sample_s=1e-6 * horizon,
                       membership=membership)


def _setup(epochs: float, requests: int):
    key = (epochs, requests)
    if key not in _SETUP_MEMO:
        from repro_torch.experiments.driver import run as run_spec
        soft = RunConfig(protocol="softsync", n_softsync=1, n_learners=LAM,
                         minibatch=MU, base_lr=0.05,
                         lr_policy="staleness_inverse", optimizer="momentum")
        steps = _steps(soft, epochs)
        dry = run_spec(ExperimentSpec(run=soft, steps=steps,
                                      duration=DURATION))
        _SETUP_MEMO[key] = (soft, steps, dry.runtime["simulated_time"])
    return _SETUP_MEMO[key]


def _scenarios(epochs: float, requests: int):
    soft, steps, horizon = _setup(epochs, requests)

    def spec(fleet: FleetConfig, tag: str) -> ExperimentSpec:
        return ExperimentSpec(run=soft.replace(serving=fleet),
                              problem="mlp_teacher", steps=steps,
                              duration=DURATION, tag=tag)

    churn = ((0.30 * horizon, 1, "crash"), (0.55 * horizon, 1, "join"))
    return {
        **{f"budget{b}": spec(_fleet(horizon, requests,
                                     PublicationPolicy(max_version_lag=b)),
                              f"budget{b}")
           for b in BUDGETS},
        "on_demand": spec(_fleet(horizon, requests,
                                 PublicationPolicy(kind="on_demand")),
                          "on_demand"),
        "budget4_churn": spec(_fleet(horizon, requests,
                                     PublicationPolicy(max_version_lag=4),
                                     membership=churn),
                              "budget4_churn"),
    }


def specs(epochs: float = 2.0, requests: int = 1024):
    return [s for sp in _scenarios(epochs, requests).values()
            for s in Sweep.over(sp, seed=SEEDS)]


def _stats(rows) -> dict:
    acc = [r.metrics["serving_accuracy"] for r in rows]
    errs = [r.metrics["test_error"] for r in rows]
    summaries = [r.runtime["serving"] for r in rows]
    return {
        "serving_accuracy_mean": float(np.mean(acc)),
        "serving_accuracy_std": float(np.std(acc)),
        "test_errors": [float(e) for e in errs],
        "staleness_mean": float(np.mean(
            [s["staleness_mean"] for s in summaries])),
        "staleness_max": int(max(s["staleness_max"] for s in summaries)),
        "latency_p50_s": float(np.mean(
            [s["latency_p50_s"] for s in summaries])),
        "latency_p99_s": float(np.mean(
            [s["latency_p99_s"] for s in summaries])),
        "refreshes_mean": float(np.mean(
            [s["n_refreshes"] for s in summaries])),
        "n_dropped": int(sum(s["n_dropped"] for s in summaries)),
    }


def derive(results, params, device=None):
    """Records → curves and claims (pure in the records; ``device`` unused)."""
    epochs, requests = params["epochs"], params["requests"]
    _, steps, horizon = _setup(epochs, requests)
    stats = {}
    for i, name in enumerate(_SCENARIOS):
        rows = results[i * len(SEEDS):(i + 1) * len(SEEDS)]
        stats[name] = _stats(rows)
        emit(f"train_while_serve/{name}",
             f"acc={stats[name]['serving_accuracy_mean']:.4f}",
             f"stale={stats[name]['staleness_mean']:.1f} "
             f"p99={stats[name]['latency_p99_s']:.2f}s "
             f"refreshes={stats[name]['refreshes_mean']:.0f}")

    acc = {b: stats[f"budget{b}"]["serving_accuracy_mean"] for b in BUDGETS}
    p99 = {b: stats[f"budget{b}"]["latency_p99_s"] for b in BUDGETS}
    ref = {b: stats[f"budget{b}"]["refreshes_mean"] for b in BUDGETS}
    noise = max(max(stats[f"budget{b}"]["serving_accuracy_std"]
                    for b in BUDGETS), 1e-3)
    pairs = list(zip(BUDGETS, BUDGETS[1:]))
    claims = {
        "accuracy_monotone_in_budget":
            all(acc[a] >= acc[b] - noise for a, b in pairs)
            and acc[BUDGETS[0]] > acc[BUDGETS[-1]] + noise,
        "refreshes_strictly_decreasing":
            all(ref[a] > ref[b] for a, b in pairs),
        "fresh_serving_pays_latency":
            p99[BUDGETS[0]] > p99[BUDGETS[-1]],
        "on_demand_is_freshest":
            stats["on_demand"]["staleness_mean"] == 0.0
            and (stats["on_demand"]["serving_accuracy_mean"]
                 >= acc[BUDGETS[0]] - noise),
        "budget_holds_under_churn":
            stats["budget4_churn"]["staleness_max"] <= 4
            and stats["budget4_churn"]["n_dropped"] == 0,
        "training_unperturbed_by_serving":
            all(s["test_errors"] == stats["budget1"]["test_errors"]
                for s in stats.values()),
    }
    for k, v in claims.items():
        emit(f"train_while_serve/claims/{k}", v)

    return {
        "lambda": LAM, "mu": MU, "epochs": epochs, "model_mb": MODEL_MB,
        "seeds": list(SEEDS), "budgets": list(BUDGETS),
        "updates": steps, "horizon_s": horizon, "requests": requests,
        "scenarios": stats, "claims": claims, "noise_band": noise,
    }


def measure(updates: int = 48, requests: int = 1024,
            repeats: int = 3, device="cuda") -> dict:
    """The throughput probe of the serving lane on ``device`` (snapshot
    capture in the event loop + the chunked batched request evaluation),
    requests sized to dominate the tiny training replay.  The reference's
    ``bench_guard`` cell reads it; the port's bench cells wait for ROADMAP.md
    item 6.3."""
    import time

    import torch

    from repro_torch.core.engine import replay, resolve_device
    from repro_torch.core.trace import schedule
    from repro_torch.experiments.problems import get_problem

    prob = get_problem("mlp_teacher")
    base = RunConfig(protocol="softsync", n_softsync=1, n_learners=16,
                     minibatch=4, base_lr=0.05,
                     lr_policy="staleness_inverse", optimizer="momentum",
                     seed=17)
    horizon = schedule(base, updates).simulated_time
    cfg = base.replace(serving=FleetConfig(
        replicas=2, policy=PublicationPolicy(max_version_lag=4),
        request_rate=requests / horizon, request_samples=32))
    trace = schedule(cfg, updates)
    batches = prob.stage_requests(trace.serving, cfg.serving, seed=cfg.seed)
    dev = resolve_device(device)
    init = prob.init(dev)
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = replay(trace, cfg, grad_fn=prob.grad_fn, init_params=init,
                     batch_fn=prob.batch_fn_for(cfg.minibatch),
                     serve_batches=batches,
                     serve_eval_fn=prob.request_metric, device=dev)
        # the request metric comes back to the host: the run has ended
        assert sim.serving.request_metric.shape[0] == trace.serving.n_requests
        best = min(best, time.perf_counter() - t0)
    n = trace.serving.n_requests
    return {"updates": updates, "requests": n, "seconds": best,
            "requests_per_s": n / best}


register_cell(Cell(
    name="serve", result="train_while_serve",
    title="Train-while-serve: staleness-budget serving fleet",
    specs=specs, derive=derive,
    claims=derived_claims("accuracy_monotone_in_budget",
                          "refreshes_strictly_decreasing",
                          "fresh_serving_pays_latency",
                          "on_demand_is_freshest",
                          "budget_holds_under_churn",
                          "training_unperturbed_by_serving"),
    params={"epochs": 2.0, "requests": 1024},
    quick_params={"epochs": 0.5, "requests": 256}))
