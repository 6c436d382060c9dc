"""Readings that set the limits of ``correct``: the control and the
planted faults, each put in the program's place and compared with the
plain reference by the cell's own numbers, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \
        [--events N | --rounds N] [--out chiprun_out/control.jsonl]

Training cells (the reference rounds of ``drivers/train.py``, over every
round of a run whose window trains ``--rounds`` rounds):

* ``control``: for a configuration trained in fp32, the reference with
  every matrix product's operands (and the gradients flowing back through
  them) rounded to TF32, the precision below fp32 (a bf16 configuration's
  control, fp8, is not written yet);
* ``half_batch``: the reference with the second half of every event's
  rows left out, the mean taken over the rest;
* ``altered``: the reference with the first leaf's gradient scaled by
  1.01 where it is produced.

The replay cell (``reference/whatif.py`` over ``check_columns`` sampled
columns of an ``--events`` replay):

* ``control``: the event's arithmetic in bf16, the residue dropped;
* ``half_batch``: the second half of each event's slots left out, the
  mean over the rest;
* ``unchanged``: events that leave the ring as it was;
* ``altered``: every 97th sampled column's result off by 1e-3.

With ``--program`` it runs the cell's program side instead, as
``run.py`` does, with a ``--seconds`` window and, given ``--dtype``, the
configuration trained in that type: the readings of a cell that
``BENCHMARK.json`` holds back (``with_cell``), and of the program's other
precision as a witness.

One JSON line per seed and reading.  The benchmark's runs do not run
this; ``portbench/tests/test_portbench_control.py`` runs it small.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def _ctx(root, cell, seed, device, bench, bench_dir):
    from portbench import harness
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    mix = harness.load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return SimpleNamespace(
        root=root, name=cell, config=harness.load_json(
            bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=mix["params"], driver=mix["driver"], seed=int(seed),
        device=device, stamps={})


def train_readings(ctx, rounds):
    """The readings of a run whose window trained ``rounds`` rounds."""
    from portbench.drivers import train
    from portbench.reference.lowprec import tf32_operand

    t = ctx.traffic
    ref = train.reference_readings(ctx, rounds)
    out = {}
    if ctx.config["torch_dtype"] == "float32":
        out["control"] = train.gaps(
            train.reference_readings(ctx, rounds, tf32_operand), ref)

    n = 1 if t["protocol"] == "hardsync" else t["n_softsync"]
    per = t["n_learners"] * t["minibatch"] // n
    keep = [r for j in range(n) for r in range(j * per, j * per + per // 2)]
    out["half_batch"] = train.gaps(train.reference_readings(
        ctx, rounds, rows=lambda b: {k: v[keep] for k, v in b.items()},
        block_rows=max(1, t["reference_block_rows"] // 2)), ref)

    from portbench.reference import dense_lm
    orig = dense_lm.DenseLM.loss_and_grad

    def altered(self, wt, batch):
        loss, g = orig(self, wt, batch)
        first = next(iter(g))
        g[first] = g[first] * 1.01
        return loss, g

    dense_lm.DenseLM.loss_and_grad = altered
    try:
        out["altered"] = train.gaps(train.reference_readings(ctx, rounds),
                                    ref)
    finally:
        dense_lm.DenseLM.loss_and_grad = orig
    return out


def replay_readings(ctx, events):
    import torch
    from portbench.drivers import replay
    from portbench.reference import whatif

    t = ctx.traffic
    D = replay.param_count(ctx.config)
    cols = whatif.sample_columns(D, t["check_columns"], ctx.seed, ctx.device)
    sched = replay.reference_schedule(ctx, events)
    kw = dict(seed=replay.problem_seed(ctx.seed), lr=t["base_lr"],
              ring_dtype=t["ring_dtype"])
    ref = whatif.replay(cols, sched["pulled"], **kw)
    half = sched["pulled"][:, : sched["pulled"].shape[1] // 2]
    bad = ref.clone()
    bad[::97] += 1e-3
    return {kind: {"w_gap": whatif.w_gap(w, ref)} for kind, w in (
        ("control", whatif.replay(cols, sched["pulled"], arith="bf16", **kw)),
        ("half_batch", whatif.replay(cols, half, **kw)),
        ("unchanged", torch.zeros_like(ref)),
        ("altered", bad))}


def readings(cell, seed, device, events=None, rounds=None, root=ROOT,
             bench=None, bench_dir=None):
    from portbench import harness
    bench = with_cell(bench or harness.load_json(root / "BENCHMARK.json"),
                      cell, bench_dir or harness.BENCH)
    ctx = _ctx(root, cell, seed, device, bench, bench_dir or harness.BENCH)
    if ctx.driver == "train":
        return train_readings(ctx, int(rounds))
    return replay_readings(ctx, int(events))


def with_cell(bench, cell, bench_dir):
    """``bench`` with ``cell`` among its workloads: a cell that
    ``BENCHMARK.json`` does not list (one held back, with its files under
    ``portbench/``) is ``<config>.<traffic>`` on one chip, and reports its
    driver's end-to-end metric."""
    from portbench import harness
    if any(w["name"] == cell for w in bench["workloads"]):
        return bench
    config, traffic = cell.split(".", 1)
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": cell, "config": config, "traffic": traffic, "chips": 1,
         "why": "held back"}])
    driver = harness.load_json(bench_dir / "traffic" / f"{traffic}.json")[
        "driver"]
    if driver == "train":
        bench["end_to_end"] = bench["end_to_end"] + [
            {"name": "train_tokens_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.03, "source": "host_clock",
             "workloads": [cell]}]
    return bench


def program_run(cell, seed, seconds, dtype=None, trace=False):
    """One run of ``cell``'s program side as ``run.py`` makes it, on the
    card, with the configuration's ``torch_dtype`` (and the program's
    ``dtype``) set to ``dtype`` when given; returns the result line."""
    import time

    from portbench import harness
    bench = with_cell(harness.load_json(ROOT / "BENCHMARK.json"), cell,
                      harness.BENCH)
    config = None
    if dtype:
        entry = next(w for w in bench["workloads"] if w["name"] == cell)
        config = harness.load_json(harness.BENCH / "configs"
                                   / f"{entry['config']}.json")
        config["torch_dtype"] = dtype
        config["port_model_config"]["dtype"] = dtype
    return harness.run_cell(ROOT, cell, seed, seconds, trace, "cuda",
                            time.perf_counter(), bench, config=config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--events", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        if args.program:
            r = program_run(args.workload, seed, args.seconds, args.dtype)
            found = [{"reading": "program", "dtype": args.dtype,
                      "correct": r["correct"], "attempted": r["attempted"],
                      **{k: c["value"] for k, c in r["checks"].items()},
                      "metrics": r["metrics"], "notes": r["notes"],
                      "memory_peak_bytes": r["device"]["memory_peak_bytes"]}]
        else:
            found = [{"reading": kind, **gaps} for kind, gaps in readings(
                args.workload, seed, dev, args.events,
                args.rounds).items()]
        for entry in found:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               **entry})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
