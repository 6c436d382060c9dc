"""Granite-4.0-H-Small as published (``configs/granite_4_0_h_small.py``,
``models/granite.py``) against the benchmark's plain fp32 reference
(``portbench/reference/granite_lm.py``), on seeded random weights at
``SMOKE`` size on the CPU: both mixer kinds, 8 experts top-3 and the
shared MLP.

* ``prefill_step`` logits through the plain attention paths and through
  the kernels' plain versions;
* a prefill through the caches and decodes against the full forward;
* the dropless MoE: an expert that gets no row and one that gets every
  token's, each token's output against a direct loop over its experts;
* ``moe_dispatch_plain`` / ``moe_combine_plain`` against a direct loop
  (ties to the lower expert, a stable permutation, the combine's order);
* the cell's comparison (``drivers/granite_prefill.compare_with``, the
  reference step by step from the program's residual stream following
  its routing): the bf16 program within the limits, the faults the
  cell's ``correct`` must catch (``portbench/granite_control.py``'s) and
  the fp8 control each beyond them, a routing one expert off caught by
  the margin alone, the same expert twice by the count of bad choices
  as well;
* the reference against ``transformers``' ``GraniteMoeHybridForCausalLM``
  (fp32, its torch path, the same weights), skipped without it;
* the configuration's published count, the family seam, the spans and
  counters of a prefill, the wrappers' refusal of autograd, and
  ``prefill_step``'s count of a batch's positions whatever its inputs.

On the card (``-m cuda``): the dispatch and combine kernels against their
plain versions (bitwise but for the gates), the grouped expert product
against one product an expert, and one ``SMOKE`` prefill's launches.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import granite_control as CONTROL  # noqa: E402
from portbench import granite_layout, inputs  # noqa: E402
from portbench.drivers import granite_prefill as DRIVER  # noqa: E402
from portbench.reference.granite_lm import GraniteLM  # noqa: E402
from portbench.reference.zamba2_lm import (fp8_operand,  # noqa: E402
                                           logit_rms_gap)
from repro_torch import configs, obs  # noqa: E402
from repro_torch.config import GraniteConfig, RunConfig  # noqa: E402
from repro_torch.configs import granite_4_0_h_small as gs  # noqa: E402
from repro_torch.configs import zamba2_7b_instruct as zi  # noqa: E402
from repro_torch.kernels import moe_route as mr  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import (granite, hybrid, init_model,  # noqa: E402
                                model_decode_step, model_forward,
                                transformer)
from repro_torch.serve import engine  # noqa: E402

# The cell's comparison (``portbench/drivers/granite_prefill.
# compare_with``): the reference step by step from the program's own run,
# following its routing.  At SMOKE's 4 layers (values measured here, the
# attention made sharp, below): the bf16 program reads mixer / add / ffn
# steps of at most 0.0103 / 0.0019 / 0.0078 and a head gap of 0.0030;
# every fault a step beyond its limit by 2.5x or more, and the fp8 control
# both a step and the head.  The routing margin: bf16 0.004 or less here,
# a routing one expert off 3.5.  The cell's own readings at 40 layers, and
# its limits, are PERF.md §6's and its workload file's.
LIMITS = {"logit_rms_gap": 0.015, "mixer_gap": 0.04, "add_gap": 0.008,
          "ffn_gap": 0.03, "route_margin": 0.05}
STEPS = ("mixer_gap", "add_gap", "ffn_gap")
FP32 = dataclasses.replace(gs.SMOKE, dtype="float32")
NAIVE = RunConfig(attn_impl="naive")
KERNELS = RunConfig(attn_impl="pallas", use_pallas=True)


def published(cfg: GraniteConfig) -> dict:
    """The published keys of a ``GraniteConfig``, as the reference and
    ``granite_layout`` read them."""
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.moe_d_ff,
        "shared_intermediate_size": cfg.shared_d_ff,
        "num_local_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.top_k, "vocab_size": cfg.vocab_size,
        "num_hidden_layers": cfg.n_layers,
        "layer_types": list(cfg.layer_types),
        "mamba_expand": cfg.ssm_expand, "mamba_n_heads": cfg.ssm_n_heads,
        "mamba_d_head": cfg.ssm_head_dim, "mamba_d_state": cfg.ssm_state,
        "mamba_n_groups": cfg.ssm_groups, "mamba_d_conv": cfg.ssm_conv,
        "mamba_chunk_size": cfg.ssm_chunk, "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "logits_scaling": cfg.logits_scaling,
        "attention_multiplier": cfg.attention_multiplier,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": cfg.dtype}


def reference(cfg, params, op=None, follow=None) -> GraniteLM:
    flat = inputs.flatten(params)
    return GraniteLM(published(cfg), lambda n: flat[n].to(torch.float32),
                     matmul_operand=op, follow=follow)


def program_states(cfg, params, tok, run=KERNELS):
    """The program's residual stream after the embedding and after each
    step, its routing and its logits, as the cell's check reads them."""
    states = []
    logits, aux = granite.forward(cfg, run, params, {"tokens": tok}, states)
    return states, aux["experts"], logits


def readings(cfg, params, tok, states, routes, logits) -> dict:
    """The cell's comparison of a run against the reference following its
    routing (``compare_with``, as the cell's check calls it)."""
    return DRIVER.compare_with(reference(cfg, params, follow=routes),
                               published(cfg), states, logits, tok,
                               logits.device)


def within(res, room=1.0) -> bool:
    return all(res[k] * room < LIMITS[k] for k in LIMITS) \
        and res["bad_routes"] == 0


def tokens(seed, B, S, vocab=gs.SMOKE.vocab_size):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (B, S), generator=g)


def sharp(params, factor=8.0):
    """The attention layers' q made ``factor`` times larger, so the
    published 1/128 scale still gives a peaked softmax at SMOKE's head
    width (random weights at init attend nearly uniformly)."""
    for p in params["layers"].values():
        if "attn" in p:
            p["attn"]["w_q"] = p["attn"]["w_q"] * factor
    return params


@pytest.fixture(scope="module")
def fp32_model():
    return sharp(init_model(FP32, 0, device="cpu"))


def test_published_configuration():
    cfg = gs.CONFIG
    assert cfg.param_count() == 32_207_337_984
    assert cfg.attention_layer_ids == (5, 15, 25, 35)
    assert cfg.layer_types.count("mamba") == 36
    assert (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state) == (128, 64,
                                                                  128)
    pub = json.loads((ROOT / "portbench/configs/granite_4_0_h_small.json")
                     .read_text())
    port = granite_layout.port_config(pub)
    assert dataclasses.replace(port, name=cfg.name) == cfg
    n = sum(int(torch.Size(s).numel()) for _, s, _, _ in
            granite_layout.layout(pub))
    assert n == cfg.param_count()
    assert "granite_4_0_h_small" not in configs.ARCH_IDS
    smoke = gs.SMOKE
    assert set(smoke.layer_types) == {"mamba", "attention"}
    assert smoke.n_experts >= 8 and smoke.top_k >= 3 and smoke.shared_d_ff
    params = init_model(smoke, 0, device="cpu")
    assert transformer.count_params(params) == smoke.param_count()
    bad = dict(pub, position_embedding_type="rope")
    with pytest.raises(ValueError, match="computes none"):
        granite_layout.port_config(bad)
    with pytest.raises(ValueError, match="power of two"):
        dataclasses.replace(smoke, logits_scaling=12.0)


def test_one_family_seam():
    assert transformer.family(gs.SMOKE) is granite
    assert transformer.family(zi.SMOKE) is hybrid
    assert transformer.family(configs.get_smoke("qwen2_1_5b")) is None
    src = (ROOT / "src/repro_torch/models/transformer.py").read_text()
    assert "isinstance(cfg" not in src


@pytest.mark.parametrize("run", [NAIVE, KERNELS], ids=["naive", "kernels"])
def test_prefill_matches_reference(run, fp32_model):
    tok = tokens(1, 2, 40)
    got = engine.prefill_step(FP32, run, fp32_model, {"tokens": tok})
    ref = reference(FP32, fp32_model)
    with torch.no_grad():
        want = ref.forward(tok)
    assert got.shape == want.shape == (2, 40, FP32.padded_vocab)
    assert logit_rms_gap(got, want) < 2e-5


def test_bf16_prefill_within_the_smoke_limit(fp32_model):
    bf16 = dataclasses.replace(FP32, dtype="bfloat16")
    params = sharp(init_model(bf16, 0, device="cpu"))
    tok = tokens(2, 2, 48)
    res = readings(bf16, params, tok, *program_states(bf16, params, tok))
    assert within(res, room=2.5), res


def test_prefill_then_decode_through_the_caches(fp32_model):
    tok = tokens(3, 2, 12)
    full, _ = model_forward(FP32, NAIVE, fp32_model, {"tokens": tok})
    state = engine.init_serve_state(FP32, 2, 16, device="cpu")
    logits, state = engine.prefill(FP32, NAIVE, fp32_model,
                                   {"tokens": tok[:, :8]}, state)
    steps = [logits]
    for t in range(8, 12):
        lg, _ = model_decode_step(FP32, NAIVE, fp32_model, tok[:, t:t + 1],
                                  torch.tensor(t, dtype=torch.int32),
                                  state.caches)
        steps.append(lg)
    assert logit_rms_gap(torch.cat(steps, dim=1), full) < 2e-5


def _direct_moe(cfg, p, n):
    """MoE(n) + Shared(n) token by token over each token's own experts."""
    w, sh = p["moe"], p["shared"]
    logits = n @ w["router"]
    out = torch.empty_like(n)
    for t in range(n.shape[0]):
        vals, idx = torch.sort(logits[t], descending=True, stable=True)
        gates = torch.softmax(vals[:cfg.top_k], -1)
        acc = torch.zeros_like(n[t])
        for g, e in zip(gates, idx[:cfg.top_k].tolist()):
            gu = n[t] @ w["w_in"][e]
            a, b = gu.chunk(2)
            acc = acc + g * ((F.silu(a) * b) @ w["w_out"][e])
        a, b = (n[t] @ sh["w_in"]).chunk(2)
        out[t] = acc + (F.silu(a) * b) @ sh["w_out"]
    return out


@pytest.mark.parametrize("run", [NAIVE, KERNELS], ids=["plain", "kernels"])
def test_dropless_expert_with_no_rows_and_one_with_every_token(run):
    """Expert 0's router column far below the others (no row), expert 1's
    far above (every token's): nothing is dropped, and each token's
    output is its own experts' gated sum plus the shared MLP."""
    cfg = FP32
    p = init_model(cfg, 5, device="cpu")["layers"]["0"]
    router = p["moe"]["router"].clone()
    T = 96
    n = torch.randn(T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    bias = torch.zeros(cfg.n_experts)
    bias[0], bias[1] = -100.0, 100.0
    p = dict(p, moe=dict(p["moe"], router=router))
    # a constant column of n carries the bias into the router's logits
    n[:, 0] = 1.0
    router[0] = bias
    logits = n @ router
    routed = mr.moe_dispatch_plain(logits, n, cfg.top_k)
    assert int(routed.counts[0]) == 0 and int(routed.counts[1]) == T
    assert int(routed.counts.sum()) == T * cfg.top_k
    x = torch.randn(T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    got = granite.moe_forward(cfg, run, p, n, x)
    want = x + cfg.residual_multiplier * _direct_moe(cfg, p, n)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dispatch_plain_against_a_direct_loop():
    T, E, k, M = 50, 8, 3, 16
    g = torch.Generator().manual_seed(8)
    # logits on a coarse grid, so many tie: ties go to the lower expert
    logits = torch.randint(-3, 4, (T, E), generator=g).float()
    x = torch.randn(T, M, generator=g)
    r = mr.moe_dispatch_plain(logits, x, k)
    want_rows = {e: [] for e in range(E)}
    for t in range(T):
        order = sorted(range(E), key=lambda e: (-float(logits[t, e]), e))
        assert r.experts[t].tolist() == order[:k]
        assert torch.allclose(r.gates[t],
                              torch.softmax(logits[t, order[:k]], -1))
        for e in order[:k]:
            want_rows[e].append(t)
    counts = [len(want_rows[e]) for e in range(E)]
    assert r.counts.tolist() == counts
    assert r.ends.tolist() == torch.cumsum(torch.tensor(counts), 0).tolist()
    start = 0
    for e in range(E):       # a stable permutation: rows in token order
        for i, t in enumerate(want_rows[e]):
            j = r.experts[t].tolist().index(e)
            assert int(r.pos[t, j]) == start + i
            assert torch.equal(r.xs[start + i], x[t])
        start += counts[e]
    assert r.experts.dtype == r.pos.dtype == r.counts.dtype == torch.int32


def test_combine_plain_against_a_direct_loop():
    T, k, M = 20, 3, 16
    g = torch.Generator().manual_seed(9)
    rows = torch.randn(T * k, M, generator=g).to(torch.bfloat16)
    gates = torch.softmax(torch.randn(T, k, generator=g), -1)
    pos = torch.randperm(T * k, generator=g).reshape(T, k).to(torch.int32)
    shared, resid = (torch.randn(T, M, generator=g).to(torch.bfloat16)
                     for _ in range(2))
    got = mr.moe_combine_plain(rows, gates, pos, shared, resid, 0.22)
    for t in range(T):
        acc = torch.zeros(M)
        for j in range(k):
            acc = acc + gates[t, j] * rows[int(pos[t, j])].float()
        want = ((acc + shared[t].float()) * 0.22
                + resid[t].float()).to(torch.bfloat16)
        assert torch.equal(got[t], want)


@pytest.mark.parametrize("fault", sorted(CONTROL.FAULTS))
def test_fault_fails_the_comparison(fault, fp32_model):
    tok = tokens(4, 2, 40)
    with CONTROL.planted(fault, FP32, fp32_model) as cfg:
        faulty = program_states(cfg, fp32_model, tok)
    res = readings(FP32, fp32_model, tok, *faulty)
    assert any(res[k] > 2.5 * LIMITS[k] for k in STEPS), res
    assert (res["bad_routes"] > 0) == (fault == "duplicate_expert"), res
    res = readings(FP32, fp32_model, tok,
                   *program_states(FP32, fp32_model, tok))
    assert max(res[k] for k in STEPS) < 2e-5 and res["bad_routes"] == 0
    assert res["logit_rms_gap"] < 2e-5 and res["route_margin"] < 1e-5


def test_fp8_control_fails_the_comparison(fp32_model):
    """The reference with fp8 operands, run alone in the program's place,
    fails both the step and the head comparison."""
    tok = tokens(4, 2, 40)
    fp8 = reference(FP32, fp32_model, fp8_operand)
    states = []
    with torch.no_grad():
        logits = fp8.forward(tok, states)
    res = readings(FP32, fp32_model, tok, states, fp8.routes, logits)
    assert res["mixer_gap"] > 2.5 * LIMITS["mixer_gap"]
    assert res["logit_rms_gap"] > 2.5 * LIMITS["logit_rms_gap"]


def test_margin_catches_a_wrong_routing(fp32_model):
    """The reference following routes one expert off (e + 1 mod E) reads a
    margin far above its limit; following its own, 0."""
    tok = tokens(4, 2, 40)
    _, aux = model_forward(FP32, KERNELS, fp32_model, {"tokens": tok})
    for follow, big in ((aux["experts"], False),
                        ([(e + 1) % FP32.n_experts for e in aux["experts"]],
                         True)):
        ref = reference(FP32, fp32_model, follow=follow)
        with torch.no_grad():
            ref.forward(tok)
        margin = float(max(m.max() for m in ref.margins))
        assert (margin > 4 * LIMITS["route_margin"]) if big \
            else margin < 1e-5


def test_reference_against_transformers(fp32_model):
    hf = pytest.importorskip(
        "transformers.models.granitemoehybrid.modeling_granitemoehybrid")
    from transformers import GraniteMoeHybridConfig
    cfg = FP32
    hcfg = GraniteMoeHybridConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        intermediate_size=cfg.moe_d_ff, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=True,
        embedding_multiplier=cfg.embedding_multiplier,
        logits_scaling=cfg.logits_scaling,
        residual_multiplier=cfg.residual_multiplier,
        attention_multiplier=cfg.attention_multiplier,
        num_local_experts=cfg.n_experts, num_experts_per_tok=cfg.top_k,
        shared_intermediate_size=cfg.shared_d_ff,
        position_embedding_type="nope", layer_types=list(cfg.layer_types),
        mamba_n_heads=cfg.ssm_n_heads, mamba_n_groups=cfg.ssm_groups,
        mamba_d_state=cfg.ssm_state, mamba_d_head=cfg.ssm_head_dim,
        mamba_d_conv=cfg.ssm_conv, mamba_expand=cfg.ssm_expand,
        mamba_chunk_size=cfg.ssm_chunk, attn_implementation="eager")
    model = hf.GraniteMoeHybridForCausalLM(hcfg).eval().float()
    P = fp32_model
    sd = {"model.embed_tokens.weight": P["embed"][:cfg.vocab_size],
          "model.norm.weight": P["final_norm"]["scale"]}
    for i, kind in enumerate(cfg.layer_types):
        p, h = P["layers"][str(i)], f"model.layers.{i}."
        sd[h + "input_layernorm.weight"] = p["input_norm"]
        sd[h + "post_attention_layernorm.weight"] = p["post_norm"]
        moe, shared = p["moe"], p["shared"]
        sd[h + "block_sparse_moe.router.layer.weight"] = moe["router"].T
        sd[h + "block_sparse_moe.input_linear.weight"] = \
            moe["w_in"].transpose(1, 2)
        sd[h + "block_sparse_moe.output_linear.weight"] = \
            moe["w_out"].transpose(1, 2)
        sd[h + "shared_mlp.input_linear.weight"] = shared["w_in"].T
        sd[h + "shared_mlp.output_linear.weight"] = shared["w_out"].T
        if kind == "mamba":
            m = p["mamba"]
            sd.update({h + "mamba.in_proj.weight": m["w_in"].T,
                       h + "mamba.conv1d.weight": m["conv_w"].T[:, None, :],
                       h + "mamba.conv1d.bias": m["conv_b"],
                       h + "mamba.dt_bias": m["dt_bias"],
                       h + "mamba.A_log": m["A_log"], h + "mamba.D": m["D"],
                       h + "mamba.norm.weight": m["gate_norm"],
                       h + "mamba.out_proj.weight": m["w_out"].T})
        else:
            a = p["attn"]
            for n in ("q", "k", "v", "o"):
                sd[h + f"self_attn.{n}_proj.weight"] = a[f"w_{n}"].T
    missing, unexpected = model.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert not unexpected and set(missing) <= {"lm_head.weight"}
    tok = tokens(5, 1, 40)
    with torch.no_grad():
        got = model(tok).logits
        want = reference(cfg, P).forward(tok)[..., :cfg.vocab_size]
    assert logit_rms_gap(got, want) < 2e-5


def test_prefill_spans_and_counts(fp32_model):
    tok = tokens(6, 2, 24)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        engine.prefill_step(FP32, KERNELS, fp32_model, {"tokens": tok})
    recs = [r for r in obs.records()
            if r["name"] in ("repro_torch.moe", "repro_torch.moe_experts")]
    moe = [r for r in recs if r["name"] == "repro_torch.moe"]
    experts = [r for r in recs if r["name"] == "repro_torch.moe_experts"]
    assert len(moe) == len(experts) == FP32.n_layers
    ids = {r["id"] for r in moe}
    assert all(r["parent"] in ids for r in experts)
    for r in moe:
        assert r["counts"]["moe.tokens"] == 2 * 24
        assert r["counts"]["moe.pairs"] == 2 * 24 * FP32.top_k


def test_prefill_counts_positions_of_any_input():
    """``prefill_step`` counts a frames batch's positions (an audio model
    takes no token ids) and a vision batch's patches and tokens."""
    bf16 = torch.bfloat16
    for arch, batch in (
            ("hubert_xlarge", lambda c: {"frames": torch.randn(
                2, 6, c.d_model).to(bf16)}),
            ("internvl2_2b", lambda c: {
                "patches": torch.randn(2, c.n_prefix_embeds,
                                       c.d_model).to(bf16),
                "tokens": tokens(7, 2, 5, c.vocab_size)})):
        cfg = configs.get_smoke(arch)
        params = init_model(cfg, 0, device="cpu")
        b = batch(cfg)
        before = obs.counters().get("tokens", 0)
        engine.prefill_step(cfg, NAIVE, params, b)
        want = sum(t.shape[0] * t.shape[1] for t in b.values())
        assert obs.counters()["tokens"] - before == want


@pytest.mark.parametrize("wrapper", ["moe_dispatch", "moe_combine"])
def test_moe_wrappers_refuse_autograd(wrapper):
    T, E, k, M = 6, 8, 3, 16
    logits = torch.randn(T, E, requires_grad=True)
    x = torch.randn(T, M, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        if wrapper == "moe_dispatch":
            kops.moe_dispatch(logits, x, k)
        else:
            r = mr.moe_dispatch_plain(logits.detach(), x.detach(), k)
            kops.moe_combine(r.xs.requires_grad_(), r.gates, r.pos,
                             x, x, 0.22)
    with torch.no_grad():
        r = kops.moe_dispatch(logits, x, k)
        assert torch.equal(kops.moe_combine(r.xs, r.gates, r.pos, x, x, 0.5),
                           mr.moe_combine_plain(r.xs, r.gates, r.pos, x, x,
                                                0.5))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _route_inputs(T, E, M, dev, seed, skew=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, M, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(M, E, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    logits = x.float() @ w.float()
    if skew:
        logits[:, 5] = -1e4
        logits[:, 3] += 1e4
    return logits, x


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,M,skew", [
    (3000, 72, 10, 512, False), (3000, 72, 10, 512, True),
    (129, 8, 3, 64, False), (1, 72, 10, 4096, False)])
def test_dispatch_and_combine_match_plain_on_card(cuda, T, E, k, M, skew):
    logits, x = _route_inputs(T, E, M, cuda, T + E, skew)
    mr.reset_launches()
    got = mr.moe_dispatch(logits, x, k)
    want = mr.moe_dispatch_plain(logits, x, k)
    for name in ("experts", "counts", "ends", "pos", "xs"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.allclose(got.gates, want.gates, rtol=4 * 2 ** -23, atol=0)
    if skew:
        assert int(got.counts[5]) == 0 and int(got.counts[3]) == T
    g = torch.Generator(device=cuda).manual_seed(1)
    rows = torch.randn(T * k, M, generator=g, device=cuda).to(torch.bfloat16)
    shared, resid = (torch.randn(T, M, generator=g, device=cuda)
                     .to(torch.bfloat16) for _ in range(2))
    out = mr.moe_combine(rows, got.gates, got.pos, shared, resid, 0.22)
    assert torch.equal(out, mr.moe_combine_plain(rows, got.gates, got.pos,
                                                 shared, resid, 0.22))
    assert mr.launches == {"moe_dispatch": 1, "moe_combine": 1}


@pytest.mark.cuda
def test_grouped_product_matches_one_product_an_expert_on_card(cuda):
    T, E, k, M, N = 2000, 72, 10, 512, 256
    logits, x = _route_inputs(T, E, M, cuda, 2, skew=True)
    r = mr.moe_dispatch(logits, x, k)
    w = (torch.randn(E, M, N, device=cuda) * 0.05).to(torch.bfloat16)
    got = granite._grouped(r.xs, w, r.ends, r.counts).float()
    want = granite._grouped(r.xs.float(), w.float(), r.ends, r.counts)
    assert torch.allclose(got, want, rtol=2 ** -7, atol=1e-3)


@pytest.mark.cuda
def test_smoke_prefill_launches_on_card(cuda):
    """One ``prefill_step`` of ``SMOKE`` at head dims the kernels take: one
    dispatch and one combine launch per layer; the same run step by step
    bitwise, and within the limits of the reference on the card."""
    cfg = dataclasses.replace(gs.SMOKE, ssm_head_dim=32, d_head=32,
                              n_heads=2, n_kv_heads=1)
    params = init_model(cfg, 0, device=cuda)
    tok = tokens(8, 2, 40).to(cuda)
    mr.reset_launches()
    got = engine.prefill_step(cfg, KERNELS, params, {"tokens": tok})
    assert mr.launches == {"moe_dispatch": cfg.n_layers,
                           "moe_combine": cfg.n_layers}
    run = program_states(cfg, params, tok)
    assert torch.equal(run[2], got)
    res = readings(cfg, params, tok, *run)
    assert within(res), res
