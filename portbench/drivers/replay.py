"""Replay driver: the parameter server's what-if replay at a model's
parameter count, through the port's experiment surface.

The problem is ``quadratic_whatif`` sized to the configuration's parameter
count (the benchmark's own count of its weight layout), its seed drawn
from ``--seed``; the ``RunConfig`` is the traffic's n-softsync protocol,
its arrival schedule drawn from the traffic's ``schedule_seed``: every
seed replays the same arrivals, since the kernel's time follows the
pattern of the rows the slots pull.
Set-up runs ``repro_torch.experiments.driver.run`` over short replays of
``warmup_events`` until the last three take the same time (within
``warmup_agree``); the window is ONE ``run`` call over as many events as
fill ``--seconds`` at the warm-up's rate.  The rate counts every event
over the call's whole time, its staging and final loss included.

The check samples ``check_columns`` columns of the final weights from the
seed, frees the program's state and replays those columns through the
plain reference (``reference/schedule.py`` schedules the arrivals anew,
``reference/whatif.py`` replays the events), then compares:

* ``schedule_mismatches``: the replay's reported schedule (ring size,
  staleness mean, max and histogram, updates, minibatches, simulated
  time) against the reference's, entry by entry; exact;
* ``w_gap``: the widest gap of the sampled final weights, as a share of
  the largest reference weight.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import inputs
from portbench.reference import schedule as ref_schedule
from portbench.reference import whatif as ref_whatif


def param_count(cfg) -> int:
    return int(sum(int(np.prod(shape))
                   for _, shape, _, _ in inputs.dense_layout(cfg)))


def problem_seed(seed: int) -> int:
    return int(seed) % 1009


def _spec(ctx, steps):
    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec
    t = ctx.traffic
    run = RunConfig(protocol="softsync", n_softsync=t["n_softsync"],
                    n_learners=t["n_learners"], minibatch=t["minibatch"],
                    base_lr=t["base_lr"], lr_policy="const",
                    optimizer=t["optimizer"], seed=t["schedule_seed"],
                    ring_dtype=t["ring_dtype"], ring_impl=t["ring_impl"])
    return ExperimentSpec(
        run=run, problem="quadratic_whatif",
        problem_args={"d": param_count(ctx.config),
                      "seed": problem_seed(ctx.seed)},
        steps=int(steps))


def _timed_run(ctx, steps):
    from repro_torch.experiments.driver import run
    t0 = time.perf_counter()
    res = run(_spec(ctx, steps), device=ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return res, t0, time.perf_counter()


def setup(ctx):
    t = ctx.traffic
    e, times = int(t["warmup_events"]), []
    while len(times) < int(t["warmup_max_calls"]):
        res, t0, t1 = _timed_run(ctx, e)
        del res
        gc.collect()
        times.append(t1 - t0)
        last = times[-3:]
        if len(last) == 3 and (max(last) - min(last)
                               <= t["warmup_agree"] * min(last)):
            break
    per_event = statistics.median(times[-3:]) / e
    events = max(e, int(ctx.seconds / per_event))
    ctx.notes.update(warmup_call_s=times, window_events=events)
    return {"events": events}


def window(ctx, state):
    n = state["events"]
    res, t0, t1 = _timed_run(ctx, n)
    state["result"] = res
    ctx.stamps.update(kind="replay", events=n)
    w = res.params["w"]
    failed = 0 if bool(torch.isfinite(w).all()) else n
    return {"t0": t0, "t1": t1, "work": n, "failed": failed,
            "metrics": {"replay_events_per_s": n / (t1 - t0)}}


def reported_schedule(res):
    s, r = res.staleness, res.runtime
    return {"ring_buffer_K": s["ring_buffer_K"], "mean": s["mean"],
            "max": s["max"], "histogram": list(s["histogram"]),
            "updates": r["updates"], "minibatches": r["minibatches"],
            "simulated_time": r["simulated_time"]}


def reference_schedule(ctx, events):
    t = ctx.traffic
    return ref_schedule.nsoftsync(t["schedule_seed"], t["n_learners"],
                                  t["n_softsync"], t["minibatch"], events)


def event_shapes(ctx, sched):
    """Per event: distinct ring rows read (the previous row and the rows
    the slots pulled) and distinct rows pulled, for the cost readers."""
    pulled = sched["pulled"]
    steps = pulled.shape[0]
    K = int((np.arange(steps)[:, None] - pulled).max()) + 1
    ts_rows = np.array([len(np.unique(r % K)) for r in pulled])
    read = np.array([len(np.unique(np.append(r % K, j % K)))
                     for j, r in enumerate(pulled)])
    return {"K": K, "c": pulled.shape[1], "ts_rows": ts_rows,
            "read_rows": read}


def sampled_program_weights(ctx, state):
    """The sampled columns and the program's final weights there; frees
    the program's state."""
    res = state.pop("result")
    w = res.params["w"]
    cols = ref_whatif.sample_columns(w.numel(), ctx.traffic["check_columns"],
                                     ctx.seed, w.device)
    got = w[cols].clone()
    reported = reported_schedule(res)
    del res, w
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return cols, got, reported


def check(ctx, state):
    cols, got, reported = sampled_program_weights(ctx, state)
    sched = reference_schedule(ctx, state["events"])
    ctx.stamps["event_shapes"] = event_shapes(ctx, sched)
    ctx.stamps["D"] = param_count(ctx.config)
    ctx.stamps["ring_bytes"] = 2 if ctx.traffic["ring_dtype"] == "bf16" \
        else 4
    ctx.stamps["optimizer"] = ctx.traffic["optimizer"]
    want = ref_schedule.statistics(sched)
    mismatches = sum(reported[k] != want[k] for k in want)
    ref = ref_whatif.replay(cols, sched["pulled"],
                            seed=problem_seed(ctx.seed),
                            lr=ctx.traffic["base_lr"],
                            ring_dtype=ctx.traffic["ring_dtype"])
    lim = ctx.workload["limits"]
    return {"schedule_mismatches": (float(mismatches),
                                    lim["schedule_mismatches"]),
            "w_gap": (ref_whatif.w_gap(got, ref), lim["w_gap"])}
