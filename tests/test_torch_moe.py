"""The port's MoE (``models/moe.py``, the ``moe`` and ``moe_dense``
blocks), the audio and vision frontends, and the serving path of the
configs they open — llama4_maverick and arctic (MoE), qwen3 (qk-norm),
starcoder2 and llama3_405b (dense GQA), hubert (audio, encoder-only) and
internvl2 (vision) — against the reference at ``SMOKE`` widths, on the
same weights in both packages (the module and block tests carry the
reference's across, the model tests hand the port's draw to the
reference) and numpy-seeded inputs.

Tolerances: fp32 within 5e-5 (matmul summation orders differ); bf16
within the reference's own 7e-2 (``tests/test_serving.py``).  Routing
(each token's experts ``idx`` and ``keep``) is held equal, in both dtypes:
the router is fp32 in both packages.  Greedy tokens and continuous-batching
completions are compared in fp32.  An MoE model's decode-replay prefill is
held against the reference's, not against its own full-sequence forward:
a prefill routes in groups of up to 2 048 tokens, a decode step in one
group of the batch's tokens, so capacities and drops differ by design.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRunConfig
from repro.configs import get_smoke as jget_smoke
from repro.models import blocks as jblocks
from repro.models import init_caches as jinit_caches
from repro.models import init_model as jinit_model
from repro.models import model_decode_step as jdecode
from repro.models import model_forward as jforward
from repro.models import model_loss as jloss
from repro.models import moe as jmoe
from repro.serve.engine import generate as jgenerate
from repro.serve.engine import init_serve_state as jinit_serve_state
from repro.serve.engine import prefill as jprefill
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro_torch.config import RunConfig
from repro_torch.configs import get_smoke
from repro_torch.experiments.carry import model_params_from_jax, tree_from_jax
from repro_torch.models import (init_caches, init_model, model_decode_step,
                                model_forward, model_loss)
from repro_torch.models import blocks, moe
from repro_torch.serve.engine import (generate, init_serve_state, prefill,
                                      prefill_step)
from repro_torch.serve.scheduler import ContinuousBatchingEngine

ATOL = {"float32": 5e-5, "bfloat16": 7e-2}
MOE = ["llama4_maverick_400b_a17b", "arctic_480b"]
SERVED = MOE + ["qwen3_14b", "starcoder2_7b", "llama3_405b"]
FRONTENDS = ["hubert_xlarge", "internvl2_2b"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 10


def _jinit(jcfg, seed):
    """The reference's weights (its init, jitted: eager it takes seconds)."""
    return jax.jit(lambda k: jinit_model(jcfg, k))(jax.random.PRNGKey(seed))


def _weights(cfg, seed):
    """(reference tree, port tree) of the same weights, drawn by the port's
    init on the CPU and handed to the reference bit for bit (its init
    compiles for seconds per model; the carry test holds the other
    direction)."""
    p = init_model(cfg, seed, device="cpu")

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy().copy())
    return jax.tree.map(to_jax, p), p


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke(arch), dtype=dtype, **kw))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _both(x: np.ndarray, dtype: str):
    """The same fp32 numpy input as a reference array and a port tensor,
    each rounded to ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.tensor(x).to(TORCH_DTYPE[dtype]))


def _jroute(jcfg, jp, x):
    """The reference's routing (``repro/models/moe.py:66-97``, grouping,
    router, top_k and slots) in jnp: (idx (G, T, k), keep (G, T·k))."""
    Bx, Sx, M = x.shape
    E, k = jcfg.n_experts, jcfg.top_k
    G, T = moe.groups(Bx, Sx, E)
    C = jmoe.capacity(T, jcfg)
    xg = x.reshape(G, T, M)
    logits = jnp.einsum("gtm,me->gte", xg.astype(jnp.float32),
                        jp["w_router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    fidx = idx.reshape(G, T * k)
    pos = jnp.cumsum(jax.nn.one_hot(fidx, E, dtype=jnp.int32), axis=1) - 1
    pos = jnp.take_along_axis(pos, fidx[..., None], axis=-1)[..., 0]
    return np.asarray(idx), np.asarray(pos < C)


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------
MOE_CASES = {               # (B, S, capacity_factor)
    "prefill": (2, 64, 1.25),
    "drops": (2, 64, 0.5),             # capacity small enough to drop
    "decode": (3, 1, 1.25),            # S = 1 < E: one group of B tokens
    "short": (2, 3, 1.25),             # S < E: one group of B·S tokens
}


@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in MOE_CASES for dtype in ("float32", "bfloat16")
    if dtype == "float32" or case in ("prefill", "drops")])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_reference(arch, dtype, case):
    Bx, Sx, cf = MOE_CASES[case]
    jcfg, cfg = _cfgs(arch, dtype, capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    p = tree_from_jax(jax.tree.map(np.array, jp), "cpu")
    assert p["w_router"].dtype == torch.float32
    assert p["w_gate"].dtype == TORCH_DTYPE[dtype]
    x = np.random.default_rng(1).standard_normal(
        (Bx, Sx, cfg.d_model)).astype(np.float32)
    jx, tx = _both(x, dtype)
    want, jaux = jax.jit(lambda p_, x_: jmoe.moe_forward(jcfg, p_, x_))(
        jp, jx)
    got, aux = moe.moe_forward(cfg, p, tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got.float(), want, ATOL[dtype])
    for k in ("lb_loss", "z_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-7)
    r = moe.route(cfg, p, tx)
    jidx, jkeep = _jroute(jcfg, jp, jx)
    np.testing.assert_array_equal(r["idx"].numpy(), jidx)
    np.testing.assert_array_equal(r["keep"].numpy(), jkeep)
    if case == "drops":
        assert 0 < float(aux["dropped_fraction"]) < 1
    if case == "decode":
        assert r["xg"].shape[:2] == (1, Bx)


def test_moe_ties_take_the_lower_expert_first():
    """A router of zeros gives every expert the same probability: like
    ``jax.lax.top_k``, the port picks the lowest ids (all tokens to experts
    0..k−1, most of them dropped) and gives the reference's output."""
    jcfg, cfg = _cfgs("arctic_480b", "float32")
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    jp = dict(jp, w_router=jnp.zeros_like(jp["w_router"]))
    p = tree_from_jax(jax.tree.map(np.array, jp), "cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    r = moe.route(cfg, p, torch.tensor(x))
    assert (r["idx"] == torch.arange(cfg.top_k)).all()
    jidx, jkeep = _jroute(jcfg, jp, jnp.asarray(x))
    np.testing.assert_array_equal(r["idx"].numpy(), jidx)
    np.testing.assert_array_equal(r["keep"].numpy(), jkeep)
    want, _ = jax.jit(lambda p_, x_: jmoe.moe_forward(jcfg, p_, x_))(
        jp, jnp.asarray(x))
    got, aux = moe.moe_forward(cfg, p, torch.tensor(x))
    _close(got, want, ATOL["float32"])
    # k experts get every token of a group of T, C of them kept each
    C = moe.capacity(8, cfg)
    assert float(aux["dropped_fraction"]) == 1 - C / 8


def test_moe_capacity_and_groups_match_reference():
    jcfg, cfg = _cfgs("llama4_maverick_400b_a17b", "float32")
    for T in (1, 3, 64, 2048, 4096):
        assert moe.capacity(T, cfg) == jmoe.capacity(T, jcfg)
    assert moe.groups(2, 8192, 128) == (8, 2048)
    assert moe.groups(1, 6144, 128) == (3, 2048)
    assert moe.groups(1, 3000, 128) == (375, 8)     # T halves to 8
    assert moe.groups(4, 1, 128) == (1, 4)


# ---------------------------------------------------------------------------
# the moe and moe_dense blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,arch", [("moe", MOE[0]),
                                        ("moe_dense", MOE[1])])
def test_moe_blocks_match_reference(block, arch, dtype):
    """block_forward and (fp32) block_decode, one step against an empty
    cache, of each MoE block, with their aux values.  In bf16 the two
    frameworks round the attention differently, so the router's input
    differs by a bf16 rounding and a near-tie can route a token to another
    expert (and shift its group's later slots): there the tokens whose
    experts and slots agree are held, and each other token must be a
    near-tie (its k-th and (k+1)-th router probabilities within 0.05)."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = jblocks.init_block(block, jax.random.PRNGKey(4), jcfg,
                            jnp.dtype(dtype))
    p = tree_from_jax(jax.tree.map(np.array, jp), "cpu")
    meta = blocks.init_block(block, None, cfg, TORCH_DTYPE[dtype], "meta")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, meta))
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx, tx = _both(x, dtype)
    jrun, run = JRunConfig(attn_impl="naive"), RunConfig(attn_impl="naive")
    want, jaux = jax.jit(lambda p_, x_: jblocks.block_forward(
        block, jcfg, jrun, p_, None, x_, jnp.arange(S)))(jp, jx)
    got, aux = blocks.block_forward(block, cfg, run, p, None, tx,
                                    torch.arange(S))
    held = _held(jcfg, jp, jx, cfg, p, tx, jnp.arange(S), torch.arange(S),
                 dtype)
    _close(got.float()[held], np.asarray(want, np.float32)[held],
           ATOL[dtype])
    for k in jaux:                      # bf16: the router's input rounds
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5 if dtype == "float32" else 1e-2,
                                   atol=1e-7 if dtype == "float32" else 0.1)
    if dtype == "bfloat16":
        return                  # the decode step below in fp32 only
    jcache = jblocks.init_block_cache(block, jcfg, B, 4, jnp.dtype(dtype))
    cache = blocks.init_block_cache(block, cfg, B, 4, TORCH_DTYPE[dtype],
                                    "cpu")
    want, _, jaux = jax.jit(lambda p_, x_, c_: jblocks.block_decode(
        block, jcfg, jrun, p_, None, x_, jnp.int32(0), c_))(jp, jx[:, :1],
                                                             jcache)
    got, out, aux = blocks.block_decode(block, cfg, run, p, None, tx[:, :1],
                                        torch.tensor(0), cache)
    assert out is cache
    _close(got, want, ATOL[dtype])


def _held(jcfg, jp, jx, cfg, p, tx, jpos, pos, dtype):
    """(B, S) mask of the tokens held: in fp32 all of them (equal outputs
    within 5e-5 leave no room for another routing); in bf16 those a
    block's MoE routes alike in both packages (experts and every slot's
    keep), every other token a near-tie (see the test above)."""
    if dtype == "float32":
        return torch.ones(tx.shape[:2], dtype=torch.bool)
    from repro.models import attention as jattn
    from repro.models.layers import rms_norm as jrms
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rms_norm
    eps = cfg.norm_eps

    def jxn(p_, x_):        # jitted, as the block: eager rounds otherwise
        h_ = x_ + jattn.attention_forward(
            jcfg, JRunConfig(attn_impl="naive"), p_["attn"],
            jrms(x_, p_["norm1"]["scale"], eps), jpos)
        return jrms(h_, p_["norm2"]["scale"], eps)
    jidx, jkeep = _jroute(jcfg, jp["moe"], jax.jit(jxn)(jp, jx))
    h = tx + attn.attention_forward(
        cfg, RunConfig(attn_impl="naive"), p["attn"],
        rms_norm(tx, p["norm1"]["scale"], eps), pos)
    r = moe.route(cfg, p["moe"], rms_norm(h, p["norm2"]["scale"], eps))
    G, T, k = r["idx"].shape
    alike = ((r["idx"].numpy() == jidx).all(-1)
             & (r["keep"].numpy().reshape(G, T, k)
                == jkeep.reshape(G, T, k)).all(-1))
    top = torch.sort(r["probs"], dim=-1, descending=True).values
    gap = (top[..., k - 1] - top[..., k]).numpy()
    moved = (r["idx"].numpy() != jidx).any(-1)
    assert (gap[moved] < 0.05).all(), gap[moved]
    assert alike.mean() >= 0.75
    return torch.from_numpy(alike.reshape(tx.shape[:2]))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[
    pytest.param((arch, dtype), id=f"{arch}-{dtype}")
    for arch in SERVED for dtype in ("float32", "bfloat16")])
def model(request):
    """(dtype, reference cfg, reference params, port cfg, port params)."""
    arch, dtype = request.param
    jcfg, cfg = _cfgs(arch, dtype)
    jp, p = _weights(cfg, 0)
    return dtype, jcfg, jp, cfg, p


def _pallas(**kw):
    return dict(attn_impl="pallas", use_pallas=True, **kw)


def test_model_forward_and_decode_match_reference(model):
    """The full-sequence forward through the kernels' path (the flash
    kernel's plain version, against the reference's plain attention: its
    Pallas kernel in interpret mode compiles for seconds a model, and
    ``tests/test_torch_attention.py`` holds the two kernels' versions
    against each other) with its MoE aux losses, then one decode step and
    (fp32) the decode-replay prefill."""
    dtype, jcfg, jp, cfg, p = model
    toks = _tokens(1, (B, S), cfg.vocab_size)
    want, jaux = jax.jit(lambda p_, t: jforward(
        jcfg, JRunConfig(attn_impl="naive"), p_, {"tokens": t}))(
            jp, jnp.asarray(toks.copy()))
    got, aux = model_forward(cfg, RunConfig(**_pallas()), p,
                             {"tokens": torch.tensor(toks)})
    assert got.shape == (B, S, cfg.padded_vocab)
    _close(got, want, ATOL[dtype])
    for k in ("lb_loss", "z_loss"):     # bf16: the router's input rounds
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-4 if dtype == "float32" else 1e-2,
                                   atol=1e-7)
    assert (float(aux["lb_loss"]) > 0) == (cfg.n_experts > 0)

    jrun, run = JRunConfig(), RunConfig()
    want, _ = jdecode(jcfg, jrun, jp, jnp.asarray(toks[:, :1].copy()),
                      jnp.int32(0), jinit_caches(jcfg, B, S + 2))
    got, _ = model_decode_step(cfg, run, p, torch.tensor(toks[:, :1]), 0,
                               init_caches(cfg, B, S + 2, device="cpu"))
    _close(got, want, ATOL[dtype])
    if dtype == "bfloat16":
        return                  # the decode replay below in fp32 only
    jlog, _ = jprefill(jcfg, jrun, jp, {"tokens": jnp.asarray(toks.copy())},
                       jinit_serve_state(jcfg, B, S + 2))
    logits, _ = prefill(cfg, run, p, {"tokens": torch.tensor(toks)},
                        init_serve_state(cfg, B, S + 2, device="cpu"))
    _close(logits, jlog, ATOL[dtype])
    if cfg.n_experts == 0:
        full = prefill_step(cfg, RunConfig(**_pallas()), p,
                            {"tokens": torch.tensor(toks)})
        _close(logits, full, ATOL["float32"])


@pytest.mark.parametrize("arch", SERVED)
def test_generate_and_continuous_batching_match_reference(arch):
    """Greedy tokens of ``generate``, and three requests through two slots
    of ``ContinuousBatchingEngine`` (staggered admission, slot reuse),
    equal the reference's (fp32)."""
    jcfg, cfg = _cfgs(arch, "float32")
    jp, p = _weights(cfg, 3)
    prompt = _tokens(4, (B, 5), cfg.vocab_size)
    want = np.asarray(jgenerate(jcfg, JRunConfig(), jp,
                                jnp.asarray(prompt.copy()), 4))
    got = generate(cfg, RunConfig(), p, torch.tensor(prompt), 4)
    np.testing.assert_array_equal(got.numpy(), want)

    prompts = [[3, 14, 15, 9], [26, 5], [35, 8, 9, 7, 9]]
    jeng = JEngine(jcfg, JRunConfig(), jp, max_batch=2, max_len=12)
    eng = ContinuousBatchingEngine(cfg, RunConfig(), p, max_batch=2,
                                   max_len=12)
    for pr, n in zip(prompts, (3, 2, 3)):
        assert jeng.submit(pr, max_new_tokens=n) == eng.submit(
            pr, max_new_tokens=n)
    want, got = jeng.run_until_done(), eng.run_until_done()
    assert set(got) == set(want) == {0, 1, 2}
    for rid in want:
        assert got[rid].done and got[rid].generated == want[rid].generated


# ---------------------------------------------------------------------------
# the frontends
# ---------------------------------------------------------------------------
def _frontend_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        batch = {"frames": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
        n = S
    else:
        batch = {"patches": rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}
        n = cfg.n_prefix_embeds + S
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32)
    batch["loss_mask"] = (rng.random((B, n)) < 0.8).astype(np.float32)
    return batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_forward_and_loss_match_reference(arch, dtype):
    """hubert (frames in, non-causal) and internvl2 (patches prepended to
    the tokens): ``model_forward`` through the kernels' path and
    ``model_loss`` (naive attention) against the reference (its plain
    attention, as above)."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, p = _weights(cfg, 6)
    assert p["frontend_proj"].shape == (cfg.d_model, cfg.d_model)
    nb = _frontend_batch(cfg, 7)
    jb, tb = {}, {}
    for k, v in nb.items():
        if k in ("frames", "patches"):
            jb[k], tb[k] = _both(v, dtype)
        else:
            jb[k], tb[k] = jnp.asarray(v.copy()), torch.tensor(v)
    want, _ = jax.jit(lambda p_, b: jforward(
        jcfg, JRunConfig(attn_impl="naive"), p_, b))(jp, jb)
    got, _ = model_forward(cfg, RunConfig(**_pallas()), p, tb)
    assert got.shape == (B, nb["labels"].shape[1], cfg.padded_vocab)
    _close(got, want, ATOL[dtype])
    jl, jm = jax.jit(lambda p_, b: jloss(
        jcfg, JRunConfig(attn_impl="naive"), p_, b))(jp, jb)
    loss, m = model_loss(cfg, RunConfig(attn_impl="naive"), p, tb)
    np.testing.assert_allclose(float(loss), float(jl),
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]),
                               rtol=1e-5 if dtype == "float32" else 1e-2)


def test_encoder_only_model_has_no_decode_shapes():
    from repro_torch.config import INPUT_SHAPES, validate_pairing
    cfg = get_smoke("hubert_xlarge")
    assert not cfg.causal and cfg.frontend == "audio"
    assert validate_pairing(cfg, INPUT_SHAPES["decode_32k"])
    assert validate_pairing(cfg, INPUT_SHAPES["prefill_32k"]) is None


@pytest.mark.parametrize("arch", [MOE[0], FRONTENDS[0]])
def test_carry_maps_moe_and_frontend_leaves(arch):
    """Every leaf of the reference's tree lands bit for bit at its path:
    the MoE's fp32 router and bf16 experts stacked per unit, and the
    frontend projection."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.array, _jinit(jcfg, 1))
    p = model_params_from_jax(tree, cfg, "cpu")
    for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = p
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape
        if want.dtype == np.float32:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
    if cfg.n_experts:
        m = p["units"]["block_1"]["moe"]
        assert m["w_router"].dtype == torch.float32
        assert m["w_gate"].shape == (cfg.n_units, cfg.n_experts,
                                     cfg.d_model, cfg.moe_d_ff)
    else:
        assert "frontend_proj" in p


def test_audio_model_trains_with_an_unread_embedding():
    """An audio model reads frames, never its token embedding: one
    hardsync step gives that leaf a zero gradient (as ``jax.grad`` does)
    instead of failing, so it stays as it was, and the loss is the
    reference's on the same weights."""
    from repro_torch.core.distributed import init_opt_state, make_train_step
    jcfg, cfg = _cfgs("hubert_xlarge", "float32")
    jp, p = _weights(cfg, 8)
    nb = _frontend_batch(cfg, 9)
    run = RunConfig(protocol="hardsync", attn_impl="naive", base_lr=0.1,
                    lr_policy="const", optimizer="momentum")
    step = make_train_step(run, lambda p_, b: model_loss(cfg, run, p_, b))
    new, _, metrics = step(p, init_opt_state(run, p),
                           {k: torch.tensor(v) for k, v in nb.items()})
    assert torch.equal(new["embed"], p["embed"])
    assert not torch.equal(new["frontend_proj"], p["frontend_proj"])
    jl, _ = jax.jit(lambda p_, b: jloss(
        jcfg, JRunConfig(attn_impl="naive"), p_, b))(
            jp, {k: jnp.asarray(v.copy()) for k, v in nb.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
