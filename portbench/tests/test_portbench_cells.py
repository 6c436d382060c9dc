"""Each driver against the plain reference at small sizes on the CPU, the
result line's shape, a cell and a metric added from files alone, and the
faults ``correct`` has to catch, planted under the timed path."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import MIXES, ROOT, dump, load, run_small


@pytest.mark.parametrize("mix", MIXES)
def test_driver_agrees_with_the_reference(small, mix):
    r = run_small(small, mix)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    for name, c in r["checks"].items():
        # at these sizes the two sides differ by rounding alone
        assert c["value"] <= 1e-4, (name, c)
    if mix == "whatif_replay":
        assert r["checks"]["w_gap"]["value"] == 0.0
        assert r["checks"]["schedule_mismatches"]["value"] == 0.0


@pytest.mark.parametrize("mix, rate", [("whatif_replay", "replay_events_per_s"),
                                       ("train_hardsync", "train_tokens_per_s")])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(small, trace, mix, rate, capsys):
    r = run_small(small, mix, trace=trace)
    harness.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert set(line["metrics"]) == {rate, "setup_s"}
    else:
        # a CPU run writes no number under a device metric's name
        assert line["metrics"] == {}
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, text in zip(line["checks"], tail):
        assert text.startswith(f"check {name}: ") and "limit" in text


def test_cell_and_metric_from_files_alone(small):
    bench, bench_dir = small
    mix = load(bench_dir / "traffic" / "small_whatif_replay.json")
    mix["params"]["n_learners"] = 32
    dump(mix, bench_dir / "traffic" / "dummy_mix.json")
    shutil.copy(bench_dir / "workloads" / "small.whatif_replay.json",
                bench_dir / "workloads" / "small.dummy_mix.json")
    (bench_dir / "metrics" / "dummy_events.py").write_text(
        "def read(run):\n    return float(run.stamps['events'])\n")
    bench["workloads"].append({"name": "small.dummy_mix", "config": "small",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "added from files"})
    bench["per_layer"].append({
        "name": "dummy_events", "unit": "events", "better": "higher",
        "source": "program_counter", "layer": "replay loop",
        "moves": "replay_events_per_s", "workloads": ["small.dummy_mix"]})
    r = harness.run_cell(ROOT, "small.dummy_mix", 5, 1.0, True, "cpu", 0.0,
                         bench, bench_dir)
    assert r["correct"]
    assert r["metrics"]["dummy_events"]["value"] == r["attempted"]


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "qwen2_1_5b.whatif_replay", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and p.stdout == ""


# ---------------------------------------------------------------------------
# faults under the timed path
# ---------------------------------------------------------------------------
def _wrap_step(monkeypatch, fault):
    """Breaks the round step that the port's trainer builds."""
    from repro_torch.train import loop
    real = loop.make_train_step

    def make(run, loss_fn, engine="sequential"):
        step = real(run, loss_fn, engine=engine)

        def broken(params, opt, batch):
            if fault == "half_batch":
                rows = batch["tokens"].shape[0]
                batch = {k: v[: rows // 2] for k, v in batch.items()}
            p2, o2, m = step(params, opt, batch)
            if fault == "unchanged":
                return params, opt, m
            if fault == "altered":
                e0, e1 = params["embed"], p2["embed"]
                p2 = dict(p2, embed=e0 + 1.01 * (e1 - e0))
            return p2, o2, m
        return broken

    monkeypatch.setattr(loop, "make_train_step", make)


@pytest.mark.parametrize("mix", ["train_softsync", "train_hardsync"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_training_fault_is_not_correct(small, monkeypatch, mix, fault):
    _wrap_step(monkeypatch, fault)
    r = run_small(small, mix)
    assert not r["correct"], r["checks"]


def test_training_window_fault_is_not_correct(small, monkeypatch):
    """A step that goes wrong only in the window's rounds, after set-up's
    three (it leaves the weights as they were): the window's losses and the
    final change catch it."""
    from repro_torch.train import loop
    real = loop.make_train_step
    built = []

    def make(run, loss_fn, engine="sequential"):
        step = real(run, loss_fn, engine=engine)
        built.append(run.seed)
        if len(built) < 3:
            return step

        def late(params, opt, batch):
            return params, opt, step(params, opt, batch)[2]
        return late

    monkeypatch.setattr(loop, "make_train_step", make)
    r = run_small(small, "train_softsync", seed=123)
    assert len(built) == 3 and len(set(built)) == 3
    assert not r["correct"], r["checks"]
    assert r["checks"]["grad_gap"]["value"] <= 1e-4


def test_training_notes_name_the_worst_slices(small):
    r = run_small(small, "train_hardsync")
    worst = r["notes"]["worst_slices"]
    assert set(worst) == {"grad_gap", "change_gap"}
    for name, top in worst.items():
        assert len(top) == 3 and top[0][1] == r["checks"][name]["value"]
        assert all(g >= 0 for _, _, g in top)
    rounds = r["notes"]["window_rounds"]
    assert r["attempted"] == rounds and len(r["notes"]["window_round_s"]) \
        == rounds


def _wrap_event(monkeypatch, fault):
    from repro_torch.kernels import replay_ring
    real = replay_ring.ring_apply_whatif

    def broken(ring, s, res, a, wstar, coef, lrs, idx, spec):
        if fault == "unchanged":
            return ring, s, res
        if fault == "half_batch":
            c = coef.shape[0]
            coef = torch.cat([2 * coef[: c // 2], 0 * coef[c // 2:]])
        out = real(ring, s, res, a, wstar, coef, lrs, idx, spec=spec)
        if fault == "altered":
            res[::97] += 1e-3
        return out

    monkeypatch.setattr(replay_ring, "ring_apply_whatif", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_replay_fault_is_not_correct(small, monkeypatch, fault):
    _wrap_event(monkeypatch, fault)
    r = run_small(small, "whatif_replay")
    assert not r["correct"], r["checks"]
