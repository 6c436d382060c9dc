"""The prefill cell's driver, layout and readers at a small size on the
CPU: a copy of ``zamba2_7b``'s configuration cut to CPU widths (two hybrid
layers, both shared blocks), its weights drawn from the seed, the driver
against the plain reference, the result line's shape, and the per-layer
readers giving nothing without a card.  On the card (``-m cuda``): the
cell itself, once, at its own size."""

import copy
import json
import time

import pytest
import torch

from portbench import harness, hybrid_layout
from portbench.tests.conftest import ROOT, dump, load

SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             attention_head_dim=32, intermediate_size=128, vocab_size=512,
             mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8,
             chunk_size=16, adapter_rank=8, num_hidden_layers=5,
             hybrid_layer_ids=[1, 3],
             layers_block_type=["mamba", "hybrid", "mamba", "hybrid",
                                "mamba"])


@pytest.fixture
def small_prefill(small):
    bench, bench_dir = small
    cfg = load(bench_dir / "configs" / "zamba2_7b.json")
    cfg.update(SMALL)
    dump(cfg, bench_dir / "configs" / "small_zamba2.json")
    mix = load(bench_dir / "traffic" / "prefill.json")
    mix["params"].update(batch=3, seq=40)
    dump(mix, bench_dir / "traffic" / "small_prefill.json")
    json_wl = load(bench_dir / "workloads" / "zamba2_7b.prefill.json")
    dump(json_wl, bench_dir / "workloads" / "small_zamba2.prefill.json")
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "small_zamba2", "source": cfg["source"],
                             "file": "x", "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "small_zamba2.prefill",
                               "config": "small_zamba2",
                               "traffic": "small_prefill", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "zamba2_7b.prefill" in m.get("workloads", ()):
            m["workloads"].append("small_zamba2.prefill")
    return bench, bench_dir


@pytest.mark.parametrize("trace", [False, True])
def test_prefill_cell_agrees_with_the_reference(small_prefill, trace):
    bench, bench_dir = small_prefill
    r = harness.run_cell(ROOT, "small_zamba2.prefill", 2 ** 31 + 11, 1.0,
                         trace, "cpu", time.perf_counter(), bench, bench_dir)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    if trace:
        # a CPU run writes no number under a device metric's name
        assert r["metrics"] == {}
    else:
        assert set(r["metrics"]) == {"setup_s", "replay_events_per_s"}
        rate = r["metrics"]["replay_events_per_s"]["value"]
        assert rate > 0
        assert r["notes"]["prefill_tokens_per_s"] == pytest.approx(
            rate * 3 * 40)


def test_layout_draws_the_same_leaf_again():
    cfg = json.loads((ROOT / "portbench/configs/zamba2_7b.json").read_text())
    cfg.update(SMALL)
    leaves = hybrid_layout.layout(cfg)
    for name in ("layers.3.adapter_up", "layers.2.dt_bias", "shared.1.w_q",
                 "layers.0.A_log"):
        a = hybrid_layout.draw(cfg, leaves, name, 7, "cpu", torch.bfloat16)
        b = hybrid_layout.draw(cfg, leaves, name, 7, "cpu", torch.bfloat16)
        assert torch.equal(a, b)
    dt = torch.nn.functional.softplus(
        hybrid_layout.draw(cfg, leaves, "layers.2.dt_bias", 7, "cpu",
                           torch.bfloat16))
    assert dt.dtype == torch.float32
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    bad = dict(cfg, use_shared_attention_adapter=True)
    with pytest.raises(ValueError, match="computes none"):
        hybrid_layout.port_config(bad)


@pytest.mark.cuda
def test_cell_on_the_card():
    """``zamba2_7b.prefill`` at its own size through the harness, a short
    window: correct, nothing failed, and per prefill (the warm-ups and the
    window's) one sm90 flash launch per hybrid layer and one ``ssm_scan``
    per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sk
    cfg = load(ROOT / "portbench/configs/zamba2_7b.json")
    warmups = load(ROOT / "portbench/traffic/prefill.json")["params"][
        "warmup_prefills"]
    fa.reset_launches()
    sk.reset_launches()
    r = harness.run_cell(ROOT, "zamba2_7b.prefill", 4_000_000_007, 2.0,
                         False, "cuda", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    prefills = warmups + r["attempted"]
    assert fa.launches_by_path["sm90"] == \
        len(cfg["hybrid_layer_ids"]) * prefills
    assert sk.launches["ssm_scan"] == cfg["num_hidden_layers"] * prefills
    assert r["metrics"]["replay_events_per_s"]["value"] > 0
    assert r["notes"]["prefill_tokens_per_s"] > 0
