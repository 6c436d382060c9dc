"""Cell ``distributed`` of the port (counterpart of
``repro/experiments/cells/distributed_replay.py``) — distributed-replay
throughput: ``placement="spmd"`` on a mesh of up to 8 ranks (DESIGN.md
§13).

The cell replays the calibrated adv workload — the what-if quadratic at
multi-million D under ``duration_model="calibrated:adv:300mb"`` — with the
PS ring sharded over S ∈ {1, 2, 4} "ps" ranks, and reports updates/s per
S plus the S=4/S=1 scaling ratio.  The what-if body is the per-shard-
parallel showcase: closed-form gradients are shard-local, so each rank
touches only its (K, ⌈D/S⌉) ring slice, runs no collective per event, and
per-event work drops ∝ 1/S.  ``ring_impl="fused"``: the plain ring body,
as the reference's ``fused`` is its jnp body.  A ``placement="single"``
row at S=4 (the staged sharded replay, in this process) anchors the
comparison.

``measure`` raises the mesh's rank capacity to 8
(``launch.mesh.ensure_host_devices``; ``devices`` reports it) and spawns
one world per shard count (``launch.mesh.shard_map``), each rank a
process; rank 0's time is the row.  On one card every rank shares the
device, so wall-clock scaling with S is not expected there: the card's
name and power limit (``card``), the ranks of each row (``ranks``) and
``cpu_count`` ride in the results beside the rates.
"""

from __future__ import annotations

import os
import time

from repro_torch.experiments.registry import (Cell, Claim, emit,
                                              register_cell)

DEVICES = 8
SHARDS = (1, 2, 4)


def _run_config(shards: int, placement: str):
    from repro_torch.config import RunConfig
    return RunConfig(protocol="softsync", n_softsync=4, n_learners=16,
                     minibatch=4, base_lr=0.05,
                     lr_policy="staleness_inverse", optimizer="momentum",
                     duration_model="calibrated:adv:300mb", shards=shards,
                     placement=placement, ring_impl="fused", seed=0)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _updates_per_s(cfg, d: int, updates: int, repeats: int, dev) -> float:
    """Best-of-``repeats`` replay throughput of ``cfg`` after one warm-up
    replay; inside a world every rank runs it (rank 0's time is kept)."""
    from repro_torch.core.engine import replay
    from repro_torch.core.trace import schedule_cached
    from repro_torch.experiments.problems import QuadraticProblem

    prob = QuadraticProblem(d=d)
    trace = schedule_cached(cfg, updates)
    flat_grad = prob.flat_grad(dev)
    batches = prob.stage_minibatches(trace.learner, trace.mb_index,
                                     cfg.minibatch)

    def once() -> float:
        _sync(dev)
        t0 = time.perf_counter()
        replay(trace, cfg, grad_fn=prob.grad_fn, init_params=prob.init(dev),
               batches=batches, flat_grad=flat_grad, device=dev)
        _sync(dev)
        return time.perf_counter() - t0

    once()                                       # warm
    return updates / min(once() for _ in range(repeats))


def _measure_world(shards: int, d: int, updates: int, repeats: int,
                   device: str) -> float:
    """A world's rank: the spmd row at ``shards``."""
    from repro_torch.core.engine import resolve_device
    return _updates_per_s(_run_config(shards, "spmd"), d, updates, repeats,
                          resolve_device(device))


def measure(updates: int = 48, d: int = 2_000_000, repeats: int = 3,
            shards=SHARDS, devices: int = DEVICES, device="cuda") -> dict:
    """Spawn one world per shard count and return the measurement dict."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.core.trace import schedule_cached
    from repro_torch.experiments.cells.bench_guard import card_line
    from repro_torch.launch import mesh

    dev = resolve_device(device)
    mesh.ensure_host_devices(devices)
    rows, ranks = {}, {}
    for s in shards:
        # the what-if replay plans one learner rank: S ranks
        rows[f"spmd_s{s}"] = mesh.shard_map(
            _measure_world, s, s, d, updates, repeats, str(dev))
        ranks[f"spmd_s{s}"] = s
    s_lo, s_hi = min(shards), max(shards)
    rows[f"single_s{s_hi}"] = _updates_per_s(
        _run_config(s_hi, "single"), d, updates, repeats, dev)
    ranks[f"single_s{s_hi}"] = 1
    # per-"ps"-rank ring residency: K rows of the ⌈D/S⌉ shard slice
    K = schedule_cached(_run_config(1, "single"), updates).max_staleness + 1
    return {
        "devices": mesh.device_count(),
        "cpu_count": os.cpu_count(),
        "d": d,
        "updates": updates,
        "updates_per_s": rows,
        "per_device_ring_bytes": {f"spmd_s{s}": K * (-(-d // s)) * 4
                                  for s in shards},
        "scaling_s%d_over_s%d" % (s_hi, s_lo):
            rows[f"spmd_s{s_hi}"] / rows[f"spmd_s{s_lo}"],
        "card": card_line() if dev.type == "cuda" else None,
        "ranks": ranks,
    }


def compute(updates: int = 48, d: int = 2_000_000, repeats: int = 3,
            device="cuda"):
    out = measure(updates=updates, d=d, repeats=repeats, device=device)
    for key, ups in sorted(out["updates_per_s"].items()):
        emit(f"distributed_replay/{key}", f"{ups:.1f}up/s",
             f"D={d} updates={updates} ranks={out['ranks'][key]} "
             f"devices={out['devices']}")
    s_lo, s_hi = min(SHARDS), max(SHARDS)
    ratio_key = "scaling_s%d_over_s%d" % (s_hi, s_lo)
    emit(f"distributed_replay/{ratio_key}", f"{out[ratio_key]:.2f}x",
         f"cpu_count={out['cpu_count']} card={out['card']} (the ranks "
         f"share one card)")
    return [], out


register_cell(Cell(
    name="distributed", result="distributed_replay",
    title="SPMD distributed replay on a mesh of torch.distributed ranks",
    compute=compute,
    claims=(
        Claim("emulated_mesh_has_8_devices",
              lambda d: d["devices"] == DEVICES),
        Claim("all_shard_counts_measured",
              lambda d: all(f"spmd_s{s}" in d["updates_per_s"]
                            for s in SHARDS)),
    ),
    params={"updates": 48, "d": 2_000_000, "repeats": 3},
    quick_params={"updates": 32, "d": 1_000_000, "repeats": 2}))
