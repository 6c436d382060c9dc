"""The control and the faults of ``portbench/control.py`` at a size a
test run holds, each put in the program's place.  Every fault has to fail
one of the cell's numbers against the cell's own limits.  The control's
rounding errors grow with width and depth (on the chip, at the training
cells' sizes, TF32 read 6e-4 to 2e-3 on ``grad_gap`` against the fp32
program's 8e-5 to 9e-5), so here it has to read at least a hundred times
what the program reads at this size, on one of the numbers; the replay's
bf16 control also fails the cell's limit.  The readings of the replay
cell's control and faults on the card, at its own size, fail its
committed limits."""

import pytest
import torch

from portbench import control
from portbench.tests.conftest import ROOT, load, run_small

SEED = 7


def _fails(readings, limits):
    return any(v > limits[k] for k, v in readings.items())


@pytest.mark.parametrize("mix", ["train_softsync", "train_hardsync",
                                 "whatif_replay"])
def test_control_and_faults(small, mix):
    bench, bench_dir = small
    limits = load(bench_dir / "workloads" / f"small.{mix}.json")["limits"]
    r = run_small(small, mix, seed=SEED)
    program = {k: c["value"] for k, c in r["checks"].items()}
    got = control.readings(f"small.{mix}", SEED, torch.device("cpu"),
                           events=300, rounds=r["notes"].get("window_rounds"),
                           root=ROOT, bench=bench, bench_dir=bench_dir)
    kinds = {"control", "half_batch", "altered"}
    if mix == "whatif_replay":
        kinds.add("unchanged")
    assert set(got) == kinds
    for kind, readings in got.items():
        if kind == "control" and mix != "whatif_replay":
            assert any(v >= 100 * program[k] for k, v in readings.items()), \
                (readings, program)
        else:
            assert _fails(readings, limits), (kind, readings, limits)


# The least reading of each on an NVIDIA H100 80GB HBM3 at the cell's size
# (seeds 11-13, 21-23 and 31-33; PERF.md section 6).
CARD_READINGS = {"control": 0.2820840744, "half_batch": 1.1274088e-4,
                 "unchanged": 1.0, "altered": 1.0018440e-3}


@pytest.mark.parametrize("kind", sorted(CARD_READINGS))
def test_card_readings_fail_the_replay_limits(kind):
    limits = load(ROOT / "portbench" / "workloads"
                  / "qwen2_1_5b.whatif_replay.json")["limits"]
    assert CARD_READINGS[kind] > limits["w_gap"]
