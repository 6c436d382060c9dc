"""Zamba2-7B-Instruct as published (``configs/zamba2_7b_instruct.py``,
``models/hybrid.py``) against the benchmark's plain fp32 reference
(``portbench/reference/zamba2_lm.py``, loaded by file path), on seeded
random weights at ``SMOKE`` size on the CPU: two hybrid layers, so both
shared blocks and two adapters run.

* ``prefill_step`` logits, through the plain attention paths and the
  kernels' plain versions;
* a prefill through the caches and 8 ``serve_step`` decodes against the
  reference's full forward (logits, not tokens);
* ``model_loss`` and its gradients against the reference's;
* ``ssm_scan_plain`` with B / C in groups against the step-by-step
  recurrence, and G 1 as (B, S, 1, N) bitwise as (B, S, N);
* the faults the cell's ``correct`` must catch, planted in the program
  (``portbench/prefill_control.py``'s: in the weights, or for T in
  the residual in a copy of the layer function), and the fp8 control: each reads
  above ``SMOKE_LIMIT``, which the bf16 program stays under (the cell's
  own readings at 81 layers are PERF.md §6's);
* the flash kernels' plain version at head 224 and the model's scale; the
  spans and counters of a prefill; the configuration's published count;
* the Mamba2 layer's glue wrappers (``kernels/mamba_glue.py``) on CPU
  tensors bitwise the chain ``models/hybrid.py`` ran before them, and the
  layer through either path bitwise that layer; both wrappers, and the
  RMSNorm kernel's (``kernels/rms_norm.py``, tested in
  ``test_torch_rms_norm.py``), refuse autograd.

On the card (``-m cuda``): the sm90 kernel at head 224, ``ssm_scan`` at
G 2 and the glue kernels (the prologue bitwise, the epilogue within one
bf16 ulp) against their plain versions at the ``zamba2_7b.prefill``
cell's shapes; one prefill of a ``SMOKE`` model counting the glue and
RMSNorm launches.  The cell itself runs in ``portbench/tests/test_portbench_prefill.py``
(``test_cell_on_the_card``: correct, and its launches per prefill).
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs, obs
from repro_torch.config import RunConfig
from repro_torch.configs import zamba2_7b_instruct as zi
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_glue as mg
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssm_scan as sk
from repro_torch.models import hybrid, init_model, model_decode_step, \
    model_loss
from repro_torch.models.attention import naive_attention
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("portbench/reference/zamba2_lm.py", "zamba2_reference")
CONTROL = _load("portbench/prefill_control.py", "zamba2_prefill_control")
# ``logit_rms_gap`` at SMOKE's 5 layers: the bf16 program reads 0.09 here
# and every fault and the fp8 control 0.65–1.33, so a limit of 0.25 holds
# the program with room 2× and each of them with room 2×.  The cell's own
# readings at 81 layers, and its limit, are PERF.md §6's.
SMOKE_LIMIT = 0.25
FP32 = dataclasses.replace(zi.SMOKE, dtype="float32")
NAIVE = RunConfig(attn_impl="naive")
KERNELS = RunConfig(attn_impl="pallas", use_pallas=True)


def published(c):
    """The published keys of a ``HybridConfig``, as the reference reads
    them."""
    return dict(
        hidden_size=c.d_model, num_hidden_layers=c.n_layers,
        hybrid_layer_ids=list(c.hybrid_layer_ids),
        num_mem_blocks=c.num_mem_blocks, attention_head_dim=c.d_head,
        num_attention_heads=c.n_heads, intermediate_size=c.d_ff,
        adapter_rank=c.adapter_rank, mamba_d_state=c.ssm_state,
        mamba_d_conv=c.ssm_conv, mamba_expand=c.ssm_expand,
        mamba_headdim=c.ssm_head_dim, mamba_ngroups=c.ssm_groups,
        n_mamba_heads=c.ssm_n_heads, chunk_size=c.ssm_chunk,
        rope_theta=c.rope_theta, rms_norm_eps=c.norm_eps,
        vocab_size=c.vocab_size, tie_word_embeddings=c.tie_embeddings)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def fp32_model():
    params = init_model(FP32, 0, device="cpu")
    weights = {k: v.detach().float() for k, v in flat(params).items()}
    return params, REF.Zamba2LM(published(FP32), weights.__getitem__)


def tokens(seed, B, S, vocab=zi.SMOKE.vocab_size):
    return torch.randint(0, vocab, (B, S),
                         generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
def test_published_configuration():
    cfg = zi.CONFIG
    assert cfg.param_count() == 7_356_749_648
    assert "zamba2_7b_instruct" not in configs.ARCH_IDS
    assert (cfg.d_head, cfg.ssm_n_heads, cfg.ssm_groups) == (224, 112, 2)
    assert cfg.attn_scale == pytest.approx(112 ** -0.5)
    assert [cfg.shared_block_of(i) for i in cfg.hybrid_layer_ids] == \
        [0, 1] * 6 + [0]
    layout = _load("portbench/hybrid_layout.py", "zamba2_layout")
    bench = json.loads((ROOT / "portbench/configs/zamba2_7b.json")
                       .read_text())
    port = layout.port_config(bench)
    for f in dataclasses.fields(cfg):
        if f.name not in ("name", "source"):
            assert getattr(port, f.name) == getattr(cfg, f.name), f.name
    leaves = layout.layout(bench)
    assert sum(math.prod(shape) for _, shape, _, _ in leaves) == \
        cfg.param_count()
    assert zi.SMOKE.param_count() == sum(
        t.numel() for t in flat(init_model(zi.SMOKE, 0,
                                           device="cpu")).values())


# ---------------------------------------------------------------------------
# the program against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("run", [NAIVE, KERNELS,
                                 RunConfig(attn_impl="naive", remat=False)],
                         ids=["naive", "kernels_plain", "naive_no_remat"])
def test_prefill_step_matches_reference(run, fp32_model):
    params, ref = fp32_model
    tok = tokens(1, 2, 40)
    got = engine.prefill_step(FP32, run, params, {"tokens": tok})
    want = ref.forward(tok)
    assert got.shape == (2, 40, FP32.vocab_size)
    assert REF.logit_rms_gap(got, want) < 1e-4


def test_bf16_prefill_within_the_smoke_limit():
    """The model's own dtype through the kernels' plain versions: under
    ``SMOKE_LIMIT``, which every fault and the fp8 control exceed."""
    params = init_model(zi.SMOKE, 0, device="cpu")
    weights = {k: v.float() for k, v in flat(params).items()}
    ref = REF.Zamba2LM(published(zi.SMOKE), weights.__getitem__)
    tok = tokens(2, 2, 40)
    got = engine.prefill_step(zi.SMOKE, KERNELS, params, {"tokens": tok})
    assert REF.logit_rms_gap(got, ref.forward(tok)) < SMOKE_LIMIT / 2


def test_prefill_then_decode_through_the_caches(fp32_model, monkeypatch):
    """The prompt through the caches (``engine.prefill``), then 8
    ``serve_step`` decodes of their own greedy tokens; every logit against
    the reference's forward over the whole sequence."""
    params, ref = fp32_model
    prompt = tokens(3, 2, 24)
    seen = []

    def recording(*args):
        logits, caches = model_decode_step(*args)
        seen.append(logits[:, 0])
        return logits, caches

    state = engine.init_serve_state(FP32, 2, 32, device="cpu")
    first, state = engine.prefill(FP32, NAIVE, params, {"tokens": prompt},
                                  state)
    monkeypatch.setattr(engine, "model_decode_step", recording)
    tok, pos, caches, out = state.last_tokens, state.position, \
        state.caches, []
    tok = torch.argmax(first[:, -1], -1)[:, None].to(torch.int32)
    for _ in range(8):
        out.append(tok)
        tok, caches = engine.serve_step(FP32, NAIVE, params, tok, pos,
                                        caches)
        pos = pos + 1
    full = torch.cat([prompt, torch.cat(out, 1).long()], 1)
    want = ref.forward(full)
    got = torch.cat([first, torch.stack(seen, 1)], 1)
    assert got.shape == want.shape == (2, 32, FP32.vocab_size)
    assert REF.logit_rms_gap(got, want) < 1e-4
    assert len(caches["kv"]) == len(FP32.hybrid_layer_ids)


def test_model_loss_and_gradients(fp32_model):
    params, _ = fp32_model
    params = {k: v.detach().clone().requires_grad_(v.is_floating_point())
              for k, v in flat(params).items()}
    tree = _nest(params)
    tok = tokens(4, 2, 33)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "loss_mask": torch.ones(2, 32)}
    loss, _ = model_loss(FP32, NAIVE, tree, batch)
    loss.backward()
    weights = {k: v.detach().clone().requires_grad_(True)
               for k, v in params.items()}
    ref = REF.Zamba2LM(published(FP32), weights.__getitem__)
    want = ref.loss(batch["tokens"], batch["labels"], batch["loss_mask"])
    want.backward()
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-5)
    for name, w in weights.items():
        g, r = params[name].grad, w.grad
        assert g is not None, name
        scale = float(r.abs().max()) + 1e-12
        assert float((g - r).abs().max()) <= 1e-3 * scale, name


def _nest(flat_params):
    tree = {}
    for name, x in flat_params.items():
        *path, last = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = x
    return tree


# ---------------------------------------------------------------------------
# the grouped scan
# ---------------------------------------------------------------------------
def _recurrence(x, a, Bm, Cm):
    """S_t = exp(a_t) S_{t−1} + B_t ⊗ x_t, y_t = C_t · S_t in float64,
    head h reading group h // (H / G)."""
    Bt, S, H, P = x.shape
    G = Bm.shape[2]
    Bh = Bm.double().repeat_interleave(H // G, dim=2)
    Ch = Cm.double().repeat_interleave(H // G, dim=2)
    st = torch.zeros(Bt, H, Bm.shape[-1], P, dtype=torch.float64)
    ys = []
    for t in range(S):
        st = torch.exp(a[:, t].double())[..., None, None] * st \
            + Bh[:, t, :, :, None] * x[:, t].double()[:, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], st))
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("G", [1, 2, 4])
def test_grouped_scan_matches_the_recurrence(G):
    g = torch.Generator().manual_seed(G)
    Bt, S, H, P, N = 2, 45, 8, 4, 6
    dt = torch.rand(Bt, S, H, generator=g) * 0.1 + 1e-3
    x = torch.randn(Bt, S, H, P, generator=g) * dt[..., None]
    a = dt * -torch.arange(1, H + 1, dtype=torch.float32)
    bc = torch.randn(Bt, S, 2 * G * N, generator=g)
    Bm = bc[..., :G * N].unflatten(-1, (G, N))
    Cm = bc[..., G * N:].unflatten(-1, (G, N))
    y, state = sk.ssm_scan_plain(x, a, Bm, Cm, chunk=16)
    wy, wstate = _recurrence(x, a, Bm, Cm)
    np.testing.assert_allclose(y.double().numpy(), wy.numpy(), atol=1e-5)
    np.testing.assert_allclose(state.double().numpy(), wstate.numpy(),
                               atol=1e-5)
    if G == 1:
        y1, s1 = sk.ssm_scan_plain(x, a, Bm[:, :, 0], Cm[:, :, 0], chunk=16)
        assert torch.equal(y, y1) and torch.equal(state, s1)


def test_scan_wrapper_checks_groups():
    x = torch.zeros(1, 8, 6, 32)
    a = torch.zeros(1, 8, 6)
    with pytest.raises(ValueError, match="groups"):
        sk.ssm_scan(x, a, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    assert sk.scratch_shapes(2, 300, 6, 32, 16, 256, 3)[0] == \
        (2, 3, 2, 256, 256)


# ---------------------------------------------------------------------------
# what the cell's comparison must catch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault", sorted(CONTROL.FAULTS))
def test_fault_fails_the_comparison(fault, fp32_model):
    params, ref = fp32_model
    tok = tokens(5, 2, 40)
    want = ref.forward(tok)
    sound = REF.logit_rms_gap(engine.prefill_step(FP32, KERNELS, params,
                                              {"tokens": tok}), want)
    with CONTROL.planted(fault, FP32, params) as faulty:
        bad = REF.logit_rms_gap(engine.prefill_step(FP32, KERNELS, faulty,
                                                {"tokens": tok}), want)
    again = REF.logit_rms_gap(engine.prefill_step(FP32, KERNELS, params,
                                              {"tokens": tok}), want)
    assert bad > 2 * SMOKE_LIMIT and bad > 1000 * sound, (fault, bad,
                                                          sound)
    assert again == sound


def test_fp8_control_fails_the_comparison(fp32_model):
    _, ref = fp32_model
    weights = {k: v for k, v in ((n, ref.w(n)) for n in flat(
        init_model(FP32, 0, device="cpu")))}
    ctl = REF.Zamba2LM(published(FP32), weights.__getitem__,
                       matmul_operand=REF.fp8_operand)
    tok = tokens(6, 2, 40)
    assert REF.logit_rms_gap(ctl.forward(tok), ref.forward(tok)) \
        > 2 * SMOKE_LIMIT


def test_round_fp8_e4m3():
    x = torch.tensor([0.0, 1.0, -3.0, 448.0, 1.0 + 2 ** -4])
    assert torch.equal(REF.round_fp8_e4m3(x),
                       torch.tensor([0.0, 1.0, -3.0, 448.0, 1.0]))


# ---------------------------------------------------------------------------
# the flash kernels' plain version at head 224; spans and counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [None, 112 ** -0.5])
def test_flash_plain_at_head_224(scale):
    g = torch.Generator().manual_seed(224)
    q = torch.randn(1, 70, 2, 224, generator=g)
    k = torch.randn(1, 70, 2, 224, generator=g)
    v = torch.randn(1, 70, 2, 224, generator=g)
    got = fa.flash_attention(q, k, v, causal=True, scale=scale)
    want = naive_attention(q, k, v, causal=True, scale=scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    assert fa.kernel_tiles(4096, 4096, torch.bfloat16, 224) == (128, 64)
    assert fa.kernel_tiles(4096, 4096, torch.bfloat16, 128) == (128, 128)
    assert 224 in fa.HEAD_DIMS["sm90"] and 224 not in fa.HEAD_DIMS["tf32x3"]


def test_prefill_spans_and_counts(fp32_model):
    params, _ = fp32_model
    tok = tokens(7, 2, 20)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.prefill_step(FP32, KERNELS, params, {"tokens": tok})
    recs = [r for r in obs.records()
            if r["name"] in ("repro_torch.prefill",
                             "repro_torch.shared_block")][-3:]
    assert [r["name"] for r in recs] == ["repro_torch.shared_block"] * 2 \
        + ["repro_torch.prefill"]
    assert recs[0]["counts"]["shared_block.0"] == 1
    assert recs[1]["counts"]["shared_block.1"] == 1
    assert recs[2]["counts"]["tokens"] == 40
    assert recs[2]["counts"]["shared_block.0"] == 1
    assert all(obs.device_seconds(r) is None for r in recs)   # no card


# ---------------------------------------------------------------------------
# the Mamba2 layer's glue around the scan
# ---------------------------------------------------------------------------
def _todays_layer(cfg, p, x):
    """``hybrid.mamba_forward``'s plain path as written before the glue
    kernels; returns (convolved x B C, xdt, a, the scan's y, the out
    projection's input, the layer's output)."""
    Bt, S, _ = x.shape
    Din, H, P = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    zxbcdt = torch.matmul(x, p["w_in"])
    C = Din + 2 * G * N
    z, xbc, dt = (zxbcdt[..., :Din], zxbcdt[..., Din:Din + C],
                  zxbcdt[..., Din + C:])
    xbc, _ = mg.causal_conv_plain(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :Din].unflatten(-1, (H, P))
    bc = xbc[..., Din:]
    Bm = bc[..., :G * N].unflatten(-1, (G, N))
    Cm = bc[..., G * N:].unflatten(-1, (G, N))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    a = dt * -torch.exp(p["A_log"])
    xdt = xs.to(torch.float32) * dt[..., None]
    y0, _ = sk.ssm_scan_plain(xdt, a, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y0 + xs.to(torch.float32) * p["D"][:, None]
    h = y.reshape(Bt, S, Din) * F.silu(z.to(torch.float32))
    hg = h.unflatten(-1, (G, -1))
    hg = hg * torch.rsqrt(torch.mean(hg * hg, dim=-1, keepdim=True)
                          + cfg.norm_eps)
    h = (hg.flatten(-2) * p["gate_norm"].to(torch.float32)).to(x.dtype)
    return xbc, xdt, a, y0, h, torch.matmul(h, p["w_out"])


def _glue_layer(cfg, seed, device="cpu"):
    """A Mamba2 layer of ``cfg`` in bf16 with random conv_b, D and
    gate_norm, and head 0's dt_bias past softplus's threshold 20."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = hybrid._init_layer(gen, cfg, False, torch.bfloat16, device)
    C, H, Din = p["conv_b"].shape[0], p["D"].shape[0], p["gate_norm"].shape[0]
    p["conv_b"] = (torch.randn(C, generator=gen, device=device) * 0.1).to(
        torch.bfloat16)
    p["D"] = torch.randn(H, generator=gen, device=device)
    p["gate_norm"] = (1 + 0.1 * torch.randn(Din, generator=gen,
                                            device=device)).to(torch.bfloat16)
    p["dt_bias"][0] = 30.0
    return p, gen


@pytest.mark.parametrize("G,S", [(1, 2), (2, 2), (1, 45), (2, 45)],
                         ids=["g1_s2", "g2_s2", "g1_s45", "g2_s45"])
def test_glue_is_todays_chain_on_cpu(G, S):
    """S 2 is shorter than the convolution's K − 1; 45 is no multiple of
    the kernels' tiles.  ``kops.mamba_in`` / ``mamba_out`` on CPU tensors,
    fed the projection's views and the scan's y, equal the old chain
    bitwise, and so does the layer through either path."""
    cfg = dataclasses.replace(zi.SMOKE, ssm_groups=G)
    p, gen = _glue_layer(cfg, 30 + G)
    x = torch.randn(2, S, cfg.d_model, generator=gen).to(torch.bfloat16)
    want = _todays_layer(cfg, p, x)
    z, xbc, dt = hybrid._project(cfg, p, x)
    Din, H, P = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    got = kops.mamba_in(xbc, dt, p["conv_w"], p["conv_b"], p["dt_bias"],
                        p["A_log"], head_dim=P)
    got += (want[3], kops.mamba_out(
        want[3], got[0][..., :Din].unflatten(-1, (H, P)), z, p["D"],
        p["gate_norm"], groups=G, eps=cfg.norm_eps))
    got += (hybrid.mamba_forward(cfg, p, x, use_pallas=False),
            hybrid.mamba_forward(cfg, p, x, use_pallas=True))
    want += (want[-1],)
    names = ("x B C", "xdt", "a", "y", "h", "layer", "layer (kernels)")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert bool((want[2][..., 0] < -20).all())     # past the threshold


@pytest.mark.parametrize("wrapper", ["mamba_in", "mamba_out", "rms_norm"])
def test_glue_wrappers_refuse_autograd(wrapper):
    cfg = zi.SMOKE
    p, gen = _glue_layer(cfg, 40)
    x = torch.randn(1, 5, cfg.d_model, generator=gen).to(torch.bfloat16)
    z, xbc, dt = hybrid._project(cfg, p, x)
    Din, H, P = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    xs = xbc[..., :Din].unflatten(-1, (H, P))
    y = torch.randn(1, 5, H, P, generator=gen)
    w = p[{"mamba_in": "conv_w", "mamba_out": "gate_norm",
           "rms_norm": "norm"}[wrapper]]

    def call():
        if wrapper == "mamba_in":
            return kops.mamba_in(xbc, dt, p["conv_w"], p["conv_b"],
                                 p["dt_bias"], p["A_log"], head_dim=P)
        if wrapper == "rms_norm":
            return kops.rms_norm(x, p["norm"], cfg.norm_eps)
        return kops.mamba_out(y, xs, z, p["D"], p["gate_norm"],
                              groups=cfg.ssm_groups, eps=cfg.norm_eps)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the sm90 and ssm_scan kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sm90_head_224_matches_plain_on_card(cuda):
    """The cell's shapes: 8 sequences of 4 096, 32 heads of 224, causal,
    the model's scale; within ``sm90_error_share``."""
    B, S, H, D = 8, 4096, 32, 224
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=True, scale=112 ** -0.5)
    assert fa.launches_by_path == {"sm90": 1, "tf32x3": 0}
    view = lambda t: t.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4)  # noqa
    kb, vb = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    plain = fa.flash_attention_bkgsd_plain(
        view(q), kb, vb, causal=True, blk_q=128, blk_k=fa.SM90_WIDE_BLK_K,
        scale=112 ** -0.5)
    assert bool(torch.isfinite(out).all())
    assert fa.sm90_error_share(view(out), plain, vb) <= 1.0


@pytest.mark.cuda
def test_ssm_scan_two_groups_matches_plain_on_card(cuda):
    """The cell's shapes (B 8, S 4 096, 112 heads, P = N = 64, chunk 256),
    B / C bf16 column slices of one tensor as the model passes them;
    within 1e-5 + 2⁻²⁰ · the largest chunk decay of the largest output."""
    Bt, S, H, G, N, P = 8, 4096, 112, 2, 64, 64
    g = torch.Generator(device=cuda).manual_seed(10)
    dt = torch.rand(Bt, S, H, generator=g, device=cuda) * 0.099 + 1e-3
    x = torch.randn(Bt, S, H, P, generator=g, device=cuda) * dt[..., None]
    a = dt * -torch.arange(1, H + 1, device=cuda, dtype=torch.float32)
    bc = torch.randn(Bt, S, 2 * G * N, generator=g, device=cuda).to(
        torch.bfloat16)
    Bm = bc[..., :G * N].unflatten(-1, (G, N))
    Cm = bc[..., G * N:].unflatten(-1, (G, N))
    sk.reset_launches()
    y, st = sk.ssm_scan(x, a, Bm, Cm)
    assert sk.launches["ssm_scan"] == 1
    py, pst = sk.ssm_scan_plain(x, a, Bm, Cm)
    span = float(a.reshape(Bt, S // 256, 256, H).sum(2).abs().max())
    tol = 1e-5 + 2.0 ** -20 * span
    assert float((y - py).abs().max()) <= tol * float(py.abs().max())
    assert float((st - pst).abs().max()) <= tol * float(pst.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,G,dtype", [
    (8, 4096, 2, torch.bfloat16), (2, 45, 1, torch.bfloat16),
    (3, 2, 2, torch.float32)], ids=["cell", "ragged", "short_fp32"])
def test_mamba_glue_matches_plain_on_card(cuda, B, S, G, dtype):
    """At the cell's layer (B 8, S 4 096, 112 heads, P = N = 64, G 2) and
    at two small ones: the prologue's three outputs bitwise its plain
    version's on the card; the epilogue within one bf16 ulp on at most
    1e-3 of its elements (fp32: within 2⁻²¹ relative); one launch each."""
    cfg = zi.CONFIG if S == 4096 else dataclasses.replace(
        zi.SMOKE, ssm_groups=G)
    p, gen = _glue_layer(cfg, 50 + G, cuda)
    p = {k: v.to(dtype) if v.dtype == torch.bfloat16 else v
         for k, v in p.items()}
    Din, H, P = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    C = Din + 2 * G * cfg.ssm_state
    zxbcdt = torch.randn(B, S, Din + C + H, generator=gen,
                         device=cuda).to(dtype)
    z, xbc, dt = (zxbcdt[..., :Din], zxbcdt[..., Din:Din + C],
                  zxbcdt[..., Din + C:])
    args = (xbc, dt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    mg.reset_launches()
    got = mg.mamba_in(*args, head_dim=P)
    assert mg.launches == {"mamba_in": 1, "mamba_out": 0}
    want = mg.mamba_in_plain(*args, head_dim=P)
    for name, g, w in zip(("x B C", "xdt", "a"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    xs = got[0][..., :Din].unflatten(-1, (H, P))
    y = torch.randn(B, S, H, P, generator=gen, device=cuda)
    out = mg.mamba_out(y, xs, z, p["D"], p["gate_norm"], groups=G,
                       eps=cfg.norm_eps)
    assert mg.launches == {"mamba_in": 1, "mamba_out": 1}
    plain = mg.mamba_out_plain(y, xs, z, p["D"], p["gate_norm"], groups=G,
                               eps=cfg.norm_eps)
    assert out.dtype == plain.dtype == dtype
    diff = (out.float() - plain.float()).abs()
    if dtype == torch.float32:
        assert bool((diff <= 2.0 ** -21 * plain.abs()).all())
        return
    big = torch.maximum(out.float().abs(), plain.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    assert int((diff > ulp).sum()) == 0
    assert float((diff > 0).float().mean()) <= 1e-3


@pytest.mark.cuda
def test_smoke_prefill_launches_the_glue_on_card(cuda):
    """One ``prefill_step`` of ``SMOKE`` at head dim 32 (``ssm_scan``'s
    kernel takes P of 32, 64 or 128): one launch of each glue kernel and
    of the scan per layer, one RMSNorm launch per layer, two per hybrid
    layer and the final norm, and logits within ``SMOKE_LIMIT`` / 2 of
    the plain path's on the card."""
    cfg = dataclasses.replace(zi.SMOKE, ssm_head_dim=32)
    params = init_model(cfg, 0, device=cuda)
    tok = tokens(8, 2, 40).to(cuda)
    mg.reset_launches()
    sk.reset_launches()
    rn.reset_launches()
    got = engine.prefill_step(cfg, KERNELS, params, {"tokens": tok})
    assert mg.launches == {"mamba_in": cfg.n_layers,
                           "mamba_out": cfg.n_layers}
    assert sk.launches["ssm_scan"] == cfg.n_layers
    assert rn.launches["rms_norm"] == \
        2 * len(cfg.hybrid_layer_ids) + cfg.n_layers + 1
    plain = engine.prefill_step(cfg, NAIVE, params, {"tokens": tok})
    assert REF.logit_rms_gap(got, plain) < SMOKE_LIMIT / 2
