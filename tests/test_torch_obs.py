"""The port's spans and counters (``repro_torch.obs``) on the CPU.

* Off (no profile active): a span enters no ``record_function`` and keeps
  no record.
* On, under a CPU ``torch.profiler`` over a small what-if ``driver.run``:
  the span tree ``run`` ⊃ ``problem``, ``schedule``, ``stage``, ``events``,
  ``result`` under one run id, the counts taken at their boundaries, each
  span a ``user_annotation`` of the profiler's Chrome trace.
* A ``schedule_cached`` hit records no ``schedule`` span.
* Counters only grow; ``reset_launches()`` zeroes the launch groups, which
  are the registry's own dicts.
* The what-if kernel's ``whatif_path`` group is registered, and the CPU's
  plain version leaves it untouched.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import json

import pytest
import torch

from repro_torch import obs
from repro_torch.config import RunConfig
from repro_torch.experiments import ExperimentSpec
from repro_torch.experiments.driver import run
from repro_torch.kernels import (flash_attention, mamba_glue, moe_route,
                                 ps_update, replay_ring, rms_norm, ssm_scan,
                                 wkv6)

LEARNERS = 8


def _spec(steps, seed=1):
    cfg = RunConfig(protocol="softsync", n_softsync=1, n_learners=LEARNERS,
                    minibatch=1, base_lr=0.01, lr_policy="const",
                    optimizer="sgd", seed=seed, ring_dtype="bf16",
                    ring_impl="auto")
    return ExperimentSpec(run=cfg, problem="quadratic_whatif",
                          problem_args={"d": 4096, "seed": 3}, steps=steps)


def _profiled(spec):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = run(spec, device="cpu")
    return res, prof


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"][len(obs.PREFIX):], []).append(r)
    return out


def test_off_enters_no_record_function_and_keeps_nothing(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before, last = obs.records(), obs.last_run()
    res = run(_spec(5, seed=101), device="cpu")
    assert res.runtime["updates"] == 5
    assert entered == []
    assert obs.records() == before and obs.last_run() == last


def test_span_tree_counts_and_chrome_trace(tmp_path):
    steps = 7
    res, prof = _profiled(_spec(steps, seed=102))
    recs = obs.last_run()
    assert recs == obs.records()
    root = recs[-1]
    assert root["name"] == obs.RUN and root["parent"] is None
    assert root["run"] == root["id"]
    spans = _by_name(recs[:-1])
    # result twice: the engine's (the final weights), the driver's (the
    # record)
    assert {k: len(v) for k, v in spans.items()} == {
        "problem": 1, "schedule": 1, "stage": 1, "events": 1, "result": 2}
    for r in recs[:-1]:
        assert r["parent"] == root["id"] and r["run"] == root["id"]
        assert root["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= root["t1_ns"]
    order = [spans[k][0]["t0_ns"] for k in ("schedule", "problem", "stage",
                                            "events")]
    assert order == sorted(order)
    assert spans["events"][0]["t1_ns"] <= min(r["t0_ns"]
                                              for r in spans["result"])

    # arrivals: the schedule's heap pops, every committed minibatch here
    arrivals = spans["schedule"][0]["counts"]["arrivals"]
    assert arrivals == res.trace.minibatches == res.runtime["minibatches"]
    assert arrivals == steps * LEARNERS
    assert spans["events"][0]["counts"] == {"events": steps}
    assert root["counts"]["arrivals"] == arrivals
    assert root["counts"]["events"] == steps
    # the CPU runs the plain versions, which launch nothing
    assert "launch.ring_apply_whatif" not in root["counts"]

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(obs.PREFIX)}
    assert names == {obs.PREFIX + n for n in
                     ("run", "problem", "schedule", "stage", "events",
                      "result")}


def test_schedule_cache_hit_records_no_schedule_span():
    spec = _spec(6, seed=103)
    _profiled(spec)
    assert "schedule" in _by_name(obs.last_run())
    _profiled(spec)
    spans = _by_name(obs.last_run())
    assert "schedule" not in spans
    assert "arrivals" not in spans["run"][0]["counts"]


def test_records_clear_when_a_new_run_starts():
    _profiled(_spec(5, seed=104))
    first = obs.last_run()
    _profiled(_spec(5, seed=105))
    second = obs.last_run()
    assert first[-1]["id"] != second[-1]["id"]
    assert {r["run"] for r in second} == {second[-1]["id"]}


def test_whatif_path_counters_registered_and_untouched_on_cpu():
    """The what-if kernel's variant counters are the registry's; the CPU's
    plain version launches nothing, so a replay there (and the engine's
    read of the device tallies in its ``result`` span) leaves them as they
    were."""
    names = ("whatif_path.walk", "whatif_path.slots")
    assert set(replay_ring.whatif_path) == {"walk", "slots"}
    before = obs.counters()
    assert set(names) <= set(before)
    _profiled(_spec(6, seed=107))
    after = obs.counters()
    assert [after[n] for n in names] == [before[n] for n in names]
    assert not any(n in r["counts"] for r in obs.last_run() for n in names)


def test_counters_grow_and_reset_zeroes_the_launch_groups():
    before = obs.counters()
    run(_spec(5, seed=106), device="cpu")
    after = obs.counters()
    assert set(before) <= set(after)
    assert all(after[k] >= n for k, n in before.items())
    assert after["arrivals"] - before.get("arrivals", 0) == 5 * LEARNERS
    assert after["events"] - before.get("events", 0) == 5

    groups = {"launch.ring_apply": (replay_ring.launches, "ring_apply"),
              "launch.ring_apply_whatif": (replay_ring.launches,
                                           "ring_apply_whatif"),
              "lane_events.ring_apply": (replay_ring.lane_events,
                                         "ring_apply"),
              "whatif_path.walk": (replay_ring.whatif_path, "walk"),
              "whatif_path.slots": (replay_ring.whatif_path, "slots"),
              "launch.ps_apply": (ps_update.launches, "ps_apply"),
              "launch.flash_attention": (flash_attention.launches,
                                         "flash_attention"),
              "launch.flash_attention.sm90": (flash_attention.launches_by_path,
                                              "sm90"),
              "launch.flash_attention.tf32x3": (
                  flash_attention.launches_by_path, "tf32x3"),
              "launch.ssm_scan": (ssm_scan.launches, "ssm_scan"),
              "launch.wkv6": (wkv6.launches, "wkv6"),
              "launch.mamba_in": (mamba_glue.launches, "mamba_in"),
              "launch.mamba_out": (mamba_glue.launches, "mamba_out"),
              "launch.rms_norm": (rms_norm.launches, "rms_norm"),
              "launch.moe_dispatch": (moe_route.launches, "moe_dispatch"),
              "launch.moe_combine": (moe_route.launches, "moe_combine")}
    for full, (group, name) in groups.items():
        group[name] += 3
        assert obs.counters()[full] == group[name] >= 3
    for mod in (replay_ring, ps_update, flash_attention, ssm_scan, wkv6,
                mamba_glue, rms_norm, moe_route):
        mod.reset_launches()
    now = obs.counters()
    assert all(now[full] == 0 for full in groups)
    assert replay_ring.launches == {"ring_apply": 0, "ring_apply_whatif": 0}
    assert flash_attention.launches_by_path == {"sm90": 0, "tf32x3": 0}
    assert now["events"] == after["events"]
    with pytest.raises(ValueError, match="already registered"):
        obs.counter_group("launch", ("ring_apply",))
