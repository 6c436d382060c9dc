"""The Granite prefill cell's driver, layout, yardstick and readers at a
small size on the CPU: a copy of ``granite_4_0_h_small``'s configuration
cut to CPU widths (both mixer kinds, 8 experts top-3, the shared MLP), its
weights drawn from the seed, the driver against the plain reference, the
result line's shape, and the per-layer readers giving nothing without a
card; ``granite_cost`` against a count by hand.  On the card (``-m
cuda``): the cell itself, once, at its own size."""

import copy
import time

import pytest
import torch

from portbench import granite_layout, harness
from portbench.reference import granite_cost
from portbench.tests.conftest import ROOT, dump, load

CELL = "granite_4_0_h_small.prefill_16k"
# the weights' scale grown with the cut widths (0.02 · √(4 096 / 64)), so
# each step changes the residual stream by as large a share as at the
# published widths and the step comparison reads bf16's rounding, not the
# rounding of a residual stream that the step hardly moves
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=32, shared_intermediate_size=48,
             num_local_experts=8, num_experts_per_tok=3, vocab_size=512,
             mamba_d_state=16, mamba_d_head=16, mamba_n_heads=8,
             mamba_chunk_size=16, num_hidden_layers=4,
             layer_types=["mamba", "attention", "mamba", "mamba"],
             initializer_range=0.16)


@pytest.fixture
def small_granite(small):
    bench, bench_dir = small
    cfg = load(bench_dir / "configs" / "granite_4_0_h_small.json")
    cfg.update(SMALL)
    dump(cfg, bench_dir / "configs" / "small_granite.json")
    mix = load(bench_dir / "traffic" / "prefill_16k.json")
    mix["params"].update(batch=2, seq=40)
    dump(mix, bench_dir / "traffic" / "small_prefill_16k.json")
    dump(load(bench_dir / "workloads" / f"{CELL}.json"),
         bench_dir / "workloads" / "small_granite.prefill_16k.json")
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "small_granite",
                             "source": cfg["source"], "file": "x",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "small_granite.prefill_16k",
                               "config": "small_granite",
                               "traffic": "small_prefill_16k", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("small_granite.prefill_16k")
    return bench, bench_dir


@pytest.mark.parametrize("trace", [False, True])
def test_granite_cell_agrees_with_the_reference(small_granite, trace):
    bench, bench_dir = small_granite
    r = harness.run_cell(ROOT, "small_granite.prefill_16k", 2 ** 31 + 11,
                         1.0, trace, "cpu", time.perf_counter(), bench,
                         bench_dir)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    notes = r["notes"]
    assert set(r["checks"]) == {"logit_rms_gap", "mixer_gap", "add_gap",
                                "ffn_gap", "route_margin", "bad_routes",
                                "rerun_gap"}
    assert r["checks"]["rerun_gap"]["value"] == 0
    assert r["checks"]["bad_routes"]["value"] == 0
    assert len(notes["checked"]) == 1
    assert len(notes["worst_steps"][0]) == 4
    if trace:
        # a CPU run writes no number under a device metric's name
        assert r["metrics"] == {}
    else:
        assert set(r["metrics"]) == {"setup_s", "replay_events_per_s"}
        rate = r["metrics"]["replay_events_per_s"]["value"]
        assert rate > 0
        assert notes["prefill_tokens_per_s"] == pytest.approx(rate * 2 * 40)


def test_yardstick_against_a_count_by_hand():
    cfg = load(ROOT / "portbench/configs/granite_4_0_h_small.json")
    M, V = 4096, 100352
    mamba = 36 * (M * (2 * 8192 + 2 * 128 + 128) + 8192 * M)
    attn = 4 * (2 * M * 4096 + 2 * M * 1024)
    ffn = 40 * (M * 72 + 10 * 3 * M * 768 + 3 * M * 1536)
    assert granite_cost.matmul_params_applied(cfg) == \
        mamba + attn + ffn + M * V == 8_800_960_512
    S = 16384
    flops = 2.0 * 8_800_960_512 * S + 4 * 2 * 2.0 * M * S * (S + 1) / 2
    assert granite_cost.prefill_flops(cfg, 1, S) == pytest.approx(flops)
    assert granite_cost.prefill_flops(cfg, 1, S) / 1e12 == \
        pytest.approx(297.19, abs=0.005)
    assert granite_cost.expert_flops(cfg, 1, S) == \
        pytest.approx(2.0 * 40 * 10 * 3 * M * 768 * S)
    T, k = S, 10
    assert granite_cost.dispatch_bytes(cfg, 1, S) == \
        4 * T * 72 + 2 * T * M + 2 * T * k * M + 12 * T * k + 8 * 72
    assert granite_cost.combine_bytes(cfg, 1, S) == \
        2 * T * k * M + 8 * T * k + 6 * T * M


def test_layout_draws_the_same_leaf_again():
    cfg = load(ROOT / "portbench/configs/granite_4_0_h_small.json")
    cfg.update(SMALL)
    leaves = granite_layout.layout(cfg)
    for name in ("layers.1.attn.w_k", "layers.0.mamba.dt_bias",
                 "layers.3.moe.w_in", "layers.2.mamba.A_log"):
        a = granite_layout.draw(cfg, leaves, name, 7, "cpu", torch.bfloat16)
        b = granite_layout.draw(cfg, leaves, name, 7, "cpu", torch.bfloat16)
        assert torch.equal(a, b)
    assert granite_layout.draw(cfg, leaves, "layers.0.mamba.dt_bias", 7,
                               "cpu", torch.bfloat16).dtype == torch.float32
    assert [n for n, *_ in leaves if n.startswith("layers.1.")][1] == \
        "layers.1.attn.w_q"


@pytest.mark.cuda
def test_cell_on_the_card():
    """``granite_4_0_h_small.prefill_16k`` at its own size through the
    harness, a short window: correct, nothing failed, and per prefill one
    dispatch and one combine per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels import moe_route as mr
    cfg = load(ROOT / "portbench/configs/granite_4_0_h_small.json")
    warmups = load(ROOT / "portbench/traffic/prefill_16k.json")["params"][
        "warmup_prefills"]
    mr.reset_launches()
    r = harness.run_cell(ROOT, CELL, 4_000_000_009, 2.0, False, "cuda",
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    # the check runs the program once more, step by step
    prefills = warmups + r["attempted"] + 1
    assert mr.launches == {"moe_dispatch": 40 * prefills,
                           "moe_combine": 40 * prefills}
    assert cfg["num_hidden_layers"] == 40
