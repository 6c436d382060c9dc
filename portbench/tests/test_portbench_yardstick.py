"""The yardstick's arithmetic against hand counts."""

import json

import pytest

from portbench.reference import cost
from portbench.tests.conftest import ROOT


def qwen2():
    with open(ROOT / "portbench" / "configs" / "qwen2_1_5b.json") as f:
        return json.load(f)


def test_matmul_parameters_of_qwen2_by_hand():
    # per layer: q 1536·1536, k and v 1536·256 each, o 1536·1536, the MLP
    # 3·1536·8960; 28 layers; the tied head 1536·151936
    per_layer = 1536 * 1536 + 2 * 1536 * 256 + 1536 * 1536 + 3 * 1536 * 8960
    assert per_layer == 46_792_704
    assert cost.lm_matmul_params(qwen2()) == 28 * per_layer + 1536 * 151936


def test_training_flops_of_qwen2_by_hand():
    # 6 · 1 543 569 408 · 8 192 tokens, plus QKᵀ and PV over the causal
    # pairs (1024·1025/2 a sequence), 2·12·128 flops a pair each, 28 layers,
    # 8 sequences, three passes
    dense = 6 * 1_543_569_408 * 8192
    attn = 3 * 28 * 8 * 2 * (2 * 12 * 128 * (1024 * 1025 // 2))
    assert cost.lm_train_flops(qwen2(), 8, 1024) == pytest.approx(
        dense + attn, rel=1e-12)
    assert cost.lm_train_flops(qwen2(), 8, 1024) / 1e12 == pytest.approx(
        78.0363, abs=1e-4)


@pytest.mark.parametrize("rows, bound_ms", [(1, 13.898), (2, 14.005)])
def test_whatif_event_bound_at_phase_7s_shape(rows, bound_ms):
    # chip_smoke.py phase 7: D 1 777 086 464, c 128, K 2, a bf16 ring with
    # its residue, sgd; the bound is set by operations
    D = 1_777_086_464
    nbytes, nops = cost.whatif_event_cost(D, 128, 2, rows + 1, rows, "sgd",
                                          True)
    assert nbytes == (8 + 2 + 2 * (rows + 1) + 8) * D
    assert nops == (2 * 128 + 2 * rows + 2 + 2) * D
    t, which = cost.bound_s(nbytes, nops)
    assert which == "operations"
    assert t * 1e3 == pytest.approx(bound_ms, abs=5e-4)


def test_peaks_are_the_data_sheets():
    assert cost.PEAK_BYTES_PER_S == 3.35e12
    assert cost.PEAK_FLOPS_BY_DTYPE == {"float32": 67e12,
                                        "bfloat16": 989e12,
                                        "float16": 989e12}
