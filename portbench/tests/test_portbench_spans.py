"""The readers of the port's spans (``portbench/spans.py`` and the four
metrics that use it) on a hand-made trace and hand-made ``obs`` records:
their values, and nothing where the spans, the counts or the device's
operations are missing."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.devtrace import DEVICE_CATS, Trace
from portbench.tests.conftest import ROOT
from repro_torch import obs

KERNEL = "void ring_apply_whatif_kernel<__nv_bfloat16>"
METRICS = ("replay_schedule_s", "replay_schedule_us_per_arrival",
           "replay_stage_s", "replay_tail_s")


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events(spans=True):
    """A window of 10 s (µs on the profiler's clock): the schedule 1.5 s,
    the problem with a kernel, the stage 0.25 s with a copy, three what-if
    kernels ending at 9.6 s, the engine's result and the driver's, ending
    at 9.75 s."""
    ev = [_x("portbench.window", "user_annotation", 0, 10_000_000),
          _x("aten::empty", "cpu_op", 1_700_000, 10),
          _x("fill_kernel", "kernel", 1_550_000, 200_000),
          _x("Memcpy DtoD", "gpu_memcpy", 1_850_000, 150_000),
          _x(KERNEL, "kernel", 2_100_000, 2_500_000),
          _x(KERNEL, "kernel", 4_600_000, 2_500_000),
          _x(KERNEL, "kernel", 7_100_000, 2_500_000),
          _x("elementwise_kernel", "kernel", 9_600_100, 20_000)]
    if spans:
        ev += [_x("repro_torch.run", "user_annotation", 100, 9_800_000),
               _x("repro_torch.schedule", "user_annotation", 1_000, 1_500_000),
               _x("repro_torch.problem", "user_annotation", 1_501_000,
                  300_000),
               _x("repro_torch.stage", "user_annotation", 1_801_000, 250_000),
               _x("repro_torch.events", "user_annotation", 2_051_000, 30_000),
               _x("repro_torch.result", "user_annotation", 2_081_000,
                  7_550_000),
               _x("repro_torch.result", "user_annotation", 9_650_000,
                  100_000)]
    return ev


def _records(arrivals=110_080):
    rec = [{"name": "repro_torch.schedule", "id": 2, "parent": 1, "run": 1,
            "t0_ns": 0, "t1_ns": 1, "counts": {"arrivals": arrivals}},
           {"name": "repro_torch.events", "id": 3, "parent": 1, "run": 1,
            "t0_ns": 1, "t1_ns": 2,
            "counts": {"events": 860, "launch.ring_apply_whatif": 860}}]
    return rec + [{"name": "repro_torch.run", "id": 1, "parent": None,
                   "run": 1, "t0_ns": 0, "t1_ns": 3,
                   "counts": {"arrivals": arrivals, "events": 860,
                              "launch.ring_apply_whatif": 860}}]


def _read(name, trace):
    reader = harness.load_module(ROOT / "portbench" / "metrics"
                                 / f"{name}.py", "portbench_metric_" + name)
    return reader.read(SimpleNamespace(trace=trace, stamps={}))


@pytest.fixture
def recs(monkeypatch):
    held = _records()
    monkeypatch.setattr(obs, "last_run", lambda: list(held))
    return held


def test_readers_on_a_hand_made_trace(recs):
    tr = Trace(_events())
    assert _read("replay_schedule_s", tr) == pytest.approx(1.5)
    assert _read("replay_schedule_us_per_arrival", tr) == pytest.approx(
        1.5e6 / 110_080)
    assert _read("replay_stage_s", tr) == pytest.approx(0.25)
    # the last kernel ends at 9.6 s, the driver's result at 9.75 s
    assert _read("replay_tail_s", tr) == pytest.approx(0.15)


def test_the_spans_name_the_idle_time(recs):
    gaps = dict(Trace(_events()).idle_gaps())
    # each gap goes to the span running at its middle
    assert gaps["repro_torch.schedule"] == pytest.approx(1.55)
    assert gaps["repro_torch.problem"] == pytest.approx(0.1)
    assert gaps["repro_torch.stage"] == pytest.approx(0.1)
    gaps = dict(Trace(_events(spans=False)).idle_gaps())
    assert gaps["host: between operations"] > 1.5


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_the_spans(recs, name):
    assert _read(name, Trace(_events(spans=False))) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_the_device(recs, name):
    """A CPU run's trace has no device operations: no number is read."""
    ev = [e for e in _events() if e["cat"] not in DEVICE_CATS]
    assert _read(name, Trace(ev)) is None


def test_no_count_without_the_records(monkeypatch):
    monkeypatch.setattr(obs, "last_run", lambda: [])
    tr = Trace(_events())
    assert _read("replay_schedule_us_per_arrival", tr) is None
    assert _read("replay_schedule_s", tr) == pytest.approx(1.5)


def test_no_count_on_a_program_without_obs(monkeypatch):
    """An older program has no ``repro_torch.obs``: the count reads
    nothing and raises nothing."""
    import builtins
    real = builtins.__import__

    def no_obs(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and fromlist and "obs" in fromlist:
            raise ImportError("cannot import name 'obs'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_obs)
    assert _read("replay_schedule_us_per_arrival", Trace(_events())) is None
