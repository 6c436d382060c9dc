"""Cell ``bench_guard`` of the port (counterpart of
``repro/experiments/cells/bench_guard.py``) — the perf-trajectory guard:
tiny-shape engine + sweep benchmarks on ``device`` against the port's own
floor file (``experiments/ci_floor_h100.json``, measured on an H100; the
reference's ``benchmarks/ci_floor.json`` holds CPU floors and is not read
here).

    PYTHONPATH=src python -m repro_torch.experiments.bench_guard

Runs the ``sim_engine`` single-run cell (legacy vs replay) and the
``sweep_batched_vs_sequential`` cell on a tiny shape, then fails (exit 1)
if any guarded metric regresses more than ``tolerance`` (default 30%)
below its floor.

Guarded metrics:

* ``compiled_updates_per_s``  — absolute replay throughput (one
  ``ring_apply`` launch per event on the card).  Wide margin: catches
  collapse-scale regressions, not noise.
* ``engine_speedup``          — replay vs legacy loop on the same trace.
* ``batched_sweep_speedup``   — one batched replay vs sequential replays
  for a shape-compatible grid cell.
* ``elastic_schedule_updates_per_s`` — host-side throughput of the
  membership-resolution pass in ``core/trace.schedule`` on a churny
  timeline.  Absolute, wide margin.
* ``megakernel_vs_xla_ratio``  — the CUDA ``ring_apply`` event vs the
  stock gather → update → row-write chain on the same trace and staged
  batches (the reference's megakernel-vs-XLA row, under its name).
* ``distributed_replay_updates_per_s`` — ``placement="spmd"`` what-if
  replay throughput at S = 4 "ps" ranks (the ``distributed`` cell's
  ``measure`` at D = 1 M, shards 1 and 4; DESIGN.md §13).  Absolute, wide
  margin: the four ranks share one card.
* ``serving_requests_per_s`` — serving-lane throughput (DESIGN.md §14).
  Absolute, wide margin.

To demonstrate the gate trips::

    PYTHONPATH=src python -m repro_torch.experiments.bench_guard --floor-scale 100

multiplies every floor 100× and must exit 1.  ``--write-floor`` rewrites
the floor file from fresh measurements × per-metric safety margins; run
it on the card (``--floor PATH`` writes elsewhere, to be copied over
``experiments/ci_floor_h100.json``); its note records the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from repro_torch.experiments.registry import Cell, Claim, emit, register_cell

FLOOR_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ci_floor_h100.json")

# floor = measured × margin when --write-floor regenerates the file.
# Absolute throughput gets a wide margin (the card's power limit and the
# host's load vary); ratios are machine-relative and stay tighter.
FLOOR_MARGINS = {
    "compiled_updates_per_s": 0.25,
    "engine_speedup": 0.55,
    "batched_sweep_speedup": 0.55,
    "elastic_schedule_updates_per_s": 0.25,
    "megakernel_vs_xla_ratio": 0.55,
    "distributed_replay_updates_per_s": 0.25,
    "serving_requests_per_s": 0.25,
}


def _bench_elastic_schedule(updates: int = 600, repeats: int = 3) -> dict:
    """Host-side wall clock of ``schedule()`` with a churny membership
    timeline (the membership-resolution pass: event interleaving, dropped
    pushes, λ(t) threshold refreshes, mask assembly).  Deliberately calls
    the uncached ``schedule`` — ``schedule_cached`` would return the same
    trace object after the first repeat and time a dict lookup."""
    import time

    from repro_torch.config import RunConfig
    from repro_torch.core.trace import schedule
    from repro_torch.membership import MembershipTimeline

    churn = MembershipTimeline(tuple(
        [(2.0 + 1.5 * i, i % 12, "crash") for i in range(8)]
        + [(3.0 + 1.5 * i, i % 12, "join") for i in range(8)]
        + [(30.0, 13, "leave"), (45.0, 13, "join")]))
    cfg = RunConfig(protocol="softsync", n_softsync=2, n_learners=16,
                    minibatch=4, seed=17, membership=churn)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        trace = schedule(cfg, updates)
        best = min(best, time.perf_counter() - t0)
    assert trace.valid is not None          # the elastic path actually ran
    return {"updates": updates, "seconds": best,
            "updates_per_s": updates / best}


def measure(device="cuda") -> dict:
    """The tiny-shape measurement cell on ``device``."""
    from repro_torch.config import RunConfig
    from repro_torch.experiments.cells.distributed_replay import \
        measure as _measure_dist
    from repro_torch.experiments.cells.sim_engine_bench import (
        _bench_megakernel, _bench_one, _bench_sweep)
    from repro_torch.experiments.cells.train_while_serve import \
        measure as _measure_serve

    cfg = RunConfig(protocol="softsync", n_softsync=1, n_learners=16,
                    minibatch=4, base_lr=0.05,
                    lr_policy="staleness_inverse", optimizer="momentum",
                    seed=17)
    row = _bench_one(cfg, updates=48, repeats=3, device=device)
    sweep = _bench_sweep(updates=30, lam=16, seeds=3, repeats=3,
                         device=device)
    elastic = _bench_elastic_schedule()
    mk = _bench_megakernel(updates=48, lam=16, repeats=3, device=device)
    dist = _measure_dist(updates=32, d=1_000_000, repeats=2, shards=(1, 4),
                         device=device)
    serve = _measure_serve(updates=32, requests=512, repeats=2,
                           device=device)
    return {
        "metrics": {
            "compiled_updates_per_s": row["compiled_updates_per_s"],
            "engine_speedup": row["speedup"],
            "batched_sweep_speedup": sweep["speedup"],
            "elastic_schedule_updates_per_s": elastic["updates_per_s"],
            "megakernel_vs_xla_ratio": mk["megakernel_vs_xla_ratio"],
            "distributed_replay_updates_per_s":
                dist["updates_per_s"]["spmd_s4"],
            "serving_requests_per_s": serve["requests_per_s"],
        },
        "engine_cell": row,
        "sweep_cell": sweep,
        "elastic_schedule_cell": elastic,
        "megakernel_cell": mk,
        "distributed_replay_cell": dist,
        "serving_cell": serve,
    }


def check(metrics: dict, floor: dict, floor_scale: float = 1.0) -> list:
    """Each guarded metric vs floor·scale·(1 − tolerance); returns rows."""
    tol = float(floor.get("tolerance", 0.30))
    rows = []
    for name, value in metrics.items():
        bound = floor["floors"][name] * floor_scale * (1.0 - tol)
        rows.append({"metric": name, "measured": value,
                     "floor": floor["floors"][name] * floor_scale,
                     "min_allowed": bound, "ok": value >= bound})
    return rows


def compute(floor_scale: float = 1.0, floor_path: str = None,
            device="cuda"):
    measured = measure(device)
    metrics = measured["metrics"]
    for name, value in metrics.items():
        emit(f"bench_guard/{name}", f"{value:.2f}")
    with open(floor_path or FLOOR_PATH) as f:
        floor = json.load(f)
    rows = check(metrics, floor, floor_scale)
    for r in rows:
        status = "ok" if r["ok"] else "REGRESSED"
        print(f"[bench-guard] {r['metric']}: measured={r['measured']:.2f} "
              f"min_allowed={r['min_allowed']:.2f} -> {status}")
    return [], {"measured": measured, "floor": floor,
                "floor_scale": floor_scale, "checks": rows}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    """CLI gate: run the cell, write its envelope, exit 1 on any floor
    trip."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--floor", default=FLOOR_PATH,
                    help="floor file (default experiments/ci_floor_h100.json)")
    ap.add_argument("--floor-scale", type=float, default=1.0,
                    help="multiply floors (e.g. 100 to prove the gate "
                         "trips; see module docstring)")
    ap.add_argument("--write-floor", action="store_true",
                    help="rewrite the floor file from fresh measurements "
                         "x safety margins (on the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions; the floors are the card's)")
    args = ap.parse_args(argv)

    if args.write_floor:
        measured = measure(args.device)
        metrics = measured["metrics"]
        where = card_line() if args.device != "cpu" else "the host CPU"
        floor = {
            "tolerance": 0.30,
            "floors": {k: round(v * FLOOR_MARGINS[k], 3)
                       for k, v in metrics.items()},
            "measured": metrics,
            "note": f"bench-guard floors of the port, measured on {where} "
                    f"(nvidia-smi name, power limit): fail if a metric "
                    f"drops >30% below its floor. Floor = measured x "
                    f"margin (0.25 for absolute throughputs, 0.55 for "
                    f"ratios). Regenerate on the card: python -m "
                    f"repro_torch.experiments.bench_guard "
                    f"--write-floor",
        }
        with open(args.floor, "w") as f:
            json.dump(floor, f, indent=1)
            f.write("\n")
        print(f"[bench-guard] wrote floors to {args.floor}")

    # only non-default params enter the cell hash: the default invocation
    # stays content-addressed identically across machines (an absolute
    # --floor path would poison the hash)
    params = {"floor_scale": args.floor_scale}
    if args.floor != FLOOR_PATH:
        params["floor_path"] = args.floor

    from repro_torch.experiments.campaign import run_cell
    derived = run_cell("bench_guard", params=params, force=True,
                       device=args.device)
    failed = [r for r in derived["checks"] if not r["ok"]]
    if failed:
        print(f"[bench-guard] FAIL: {len(failed)} metric(s) below the "
              f"floor", file=sys.stderr)
        return 1
    print("[bench-guard] all perf floors hold")
    return 0


register_cell(Cell(
    name="bench_guard", result="bench_guard",
    title="Perf floors on the card: engine/sweep/schedule/ring event/serving",
    compute=compute, deps=("sim_engine",), skip_quick=True,
    claims=(
        Claim("all_perf_floors_hold",
              lambda d: all(r["ok"] for r in d["checks"]),
              detail=lambda d: " ".join(r["metric"] for r in d["checks"]
                                        if not r["ok"])),
    ),
    params={"floor_scale": 1.0}))
