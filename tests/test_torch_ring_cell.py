"""The port's ``ring`` cell against the reference's.

* The analytic part — ``configs_table`` and ``analytic`` over the ten
  registered architectures — equals the reference's committed envelope
  (``benchmarks/results/ring_feasibility.json``) exactly, and the two
  bytes/param models equal the reference's own helpers (imported; its
  ``compute`` spawns 10 M-parameter children and is not called).
* The trial plumbing, on the CPU at a tiny D: a child that finishes gives
  a record with the reference's keys and ``feasible`` true; a child that
  raises ``torch.OutOfMemoryError`` gives ``feasible`` false with its last
  stderr line.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import json
from pathlib import Path

import pytest

from repro_torch.experiments import registry
from repro_torch.experiments.cells import ring_feasibility as rf

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
REFERENCE_TRIAL_KEYS = {"label", "d", "impl", "problem", "ring_dtype",
                        "cap_bytes", "feasible", "detail"}


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.experiments.cells import ring_feasibility as r_rf
    return r_rf


def test_analytic_equals_the_envelope():
    env = json.loads((RESULTS / "ring_feasibility.json").read_text())
    out = json.loads(json.dumps(rf.analytic()))
    assert out["configs_table"] == env["derived"]["configs_table"]
    assert out["analytic"] == env["derived"]["analytic"]
    assert set(env["derived"]["measured_bytes_per_param"].items()) <= set(
        rf.MEASURED_BYTES_PER_PARAM.items())
    for t in env["derived"]["rlimit_demo"]["trials"]:
        assert set(t) == REFERENCE_TRIAL_KEYS


@pytest.mark.parametrize("K", [1, 3, 8])
def test_bytes_per_param_models_equal_reference(K, R):
    for c in (1, 30, 128):
        assert rf._stock_bytes_per_param(K, c) == \
            R._stock_bytes_per_param(K, c)
    for dtype in ("fp32", "bf16"):
        for opt in ("sgd", "momentum", "adagrad", "adamw"):
            assert rf._whatif_bytes_per_param(K, dtype, opt) == \
                R._whatif_bytes_per_param(K, dtype, opt)


def test_cell_registration_matches_reference(R):
    from repro.experiments import registry as r_registry
    cell, ref = registry.get_cell("ring"), r_registry.get_cell("ring")
    assert (cell.result, cell.skip_quick, cell.campaigns) == (
        ref.result, ref.skip_quick, ref.campaigns)
    assert [c.name for c in cell.claims] == [c.name for c in ref.claims]
    assert (rf._D0, rf._HIDDEN0, rf._D_WHATIF, rf._LAM, rf._STEPS) == (
        R._D0, R._HIDDEN0, R._D_WHATIF, R._LAM, R._STEPS)


def test_feasible_child_gives_the_reference_record():
    t = rf._try_replay("whatif_tiny", 4096, "auto", "quadratic_whatif",
                       (("d", 4096),), ring_dtype="bf16", cap=1 << 30,
                       device="cpu")
    assert set(t) == REFERENCE_TRIAL_KEYS
    assert t["feasible"] and t["detail"].startswith("FEASIBLE loss")
    assert t["cap_bytes"] == 1 << 30 and rf.peak_bytes(t) > 0


def test_out_of_memory_child_is_infeasible():
    code = ("import torch\n"
            "raise torch.OutOfMemoryError('CUDA out of memory. Tried to "
            "allocate 1.91 GiB')\n")
    t = rf._run_child(code, {"label": "oom"})
    assert not t["feasible"] and rf.peak_bytes(t) is None
    assert t["detail"].startswith("torch.OutOfMemoryError: CUDA out of "
                                  "memory")
