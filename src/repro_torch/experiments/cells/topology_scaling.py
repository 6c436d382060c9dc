"""Cell ``topology`` of the port (counterpart of
``repro/experiments/cells/topology_scaling.py``, ported as written) —
Rudra-base vs adv vs adv* runtime-vs-learners curves
(paper §3.2/3.3, Table 1 / Fig. 8 story) on the topology-aware simulator.

Measure-mode spec-graph: for each architecture and λ a fixed two-epoch
workload in the paper's adversarial communication scenario (μ = 4, 300 MB
model) runs through the calibrated per-minibatch cost model with the
matching structural topology; ``simulated_time`` of the last update is the
training-time axis.  ``derive`` also times the sharded+grouped replay
against the trivial replay (``engine_overhead_cell`` — a wall-clock
measurement, re-timed on every execution, not derivable from records).
"""

from __future__ import annotations

from repro_torch.config import RunConfig
from repro_torch.core.topology import RUDRA_ARCHS, Topology
from repro_torch.experiments.registry import (Cell, derived_claims, emit,
                                        register_cell)
from repro_torch.experiments.spec import ExperimentSpec

LAMBDAS = (4, 16, 32, 60)
MU = 4
DATASET = 50_000          # the paper's CIFAR epoch (tradeoff.WorkloadModel)
MODEL_MB = 300            # Table-1 adversarial model size
PULL_JITTER = 0.02


def _spec_for(arch: str, lam: int, epochs: float) -> ExperimentSpec:
    from repro_torch.experiments.problems import updates_for_epochs
    topo = Topology.for_arch(arch, lam,
                             jitter=PULL_JITTER if arch == "adv*" else 0.0)
    run = RunConfig(protocol="softsync", n_softsync=1, n_learners=lam,
                    minibatch=MU, shards=topo.shards, groups=topo.groups,
                    shard_pull_jitter=topo.pull_jitter, seed=29)
    steps = updates_for_epochs(epochs, MU, run.gradients_per_update,
                               DATASET, group_size=run.group_size)
    return ExperimentSpec(run=run, steps=steps,
                          duration=f"calibrated:{arch}:{MODEL_MB}mb",
                          tag=f"{arch}/lambda={lam}")


def specs(epochs: float = 2.0):
    return [_spec_for(arch, lam, epochs)
            for arch in RUDRA_ARCHS for lam in LAMBDAS]


def _engine_overhead_cell(device, updates: int = 40) -> dict:
    """Wall-clock of the sharded+grouped replay vs the trivial replay on
    the same step count (mlp_teacher, tiny shape), on ``device``."""
    import time

    import torch

    from repro_torch.experiments.driver import run as run_spec

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    base = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=8,
                      minibatch=4, base_lr=0.05,
                      lr_policy="staleness_inverse", optimizer="momentum",
                      seed=17),
        problem="mlp_teacher", steps=updates)
    star = base.replace(run=base.run.replace(shards=4,
                                             shard_pull_jitter=0.1))

    def _time(spec):
        run_spec(spec, device=device)                # warm-up
        sync()
        t0 = time.perf_counter()
        run_spec(spec, device=device)
        sync()
        return time.perf_counter() - t0

    t_base, t_star = _time(base), _time(star)
    return {"updates": updates, "trivial_s": t_base, "topology_s": t_star,
            "overhead_x": t_star / t_base}


def derive(results, params, device="cuda"):
    curves = {arch: {} for arch in RUDRA_ARCHS}
    it = iter(results)
    for arch in RUDRA_ARCHS:
        for lam in LAMBDAS:
            res = next(it)
            seconds = res.runtime["simulated_time"]
            curves[arch][lam] = seconds
            emit(f"topology_scaling/{arch}/lambda={lam}/train_s",
                 f"{seconds:.0f}",
                 f"updates={res.runtime['updates']} "
                 f"<sigma>={res.staleness['mean']:.2f}")
    speedup_vs_base = {
        arch: {lam: curves["base"][lam] / curves[arch][lam]
               for lam in LAMBDAS}
        for arch in RUDRA_ARCHS}
    lam0, lam1 = LAMBDAS[0], LAMBDAS[-1]
    claims = {
        "adv_faster_than_base_at_scale":
            curves["adv"][lam1] < curves["base"][lam1],
        "adv_star_fastest_at_scale":
            curves["adv*"][lam1] <= curves["adv"][lam1],
        "base_scaling_saturates":
            curves["base"][lam0] / curves["base"][lam1] < 0.7 * lam1 / lam0,
    }
    overhead = _engine_overhead_cell(device)
    emit("topology_scaling/engine_overhead",
         f"{overhead['overhead_x']:.2f}x",
         f"trivial={overhead['trivial_s']:.3f}s "
         f"topology={overhead['topology_s']:.3f}s")
    return {"lambdas": list(LAMBDAS), "mu": MU, "epochs": params["epochs"],
            "train_seconds": curves, "speedup_vs_base": speedup_vs_base,
            "claims": claims, "engine_overhead_cell": overhead}


register_cell(Cell(
    name="topology", result="topology_scaling",
    title="Rudra base/adv/adv* runtime-vs-learners curves",
    specs=specs, derive=derive,
    claims=derived_claims("adv_faster_than_base_at_scale",
                          "adv_star_fastest_at_scale",
                          "base_scaling_saturates"),
    params={"epochs": 2.0}, quick_params={"epochs": 0.5}))
