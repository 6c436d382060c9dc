"""The port's serving path (``repro_torch.models``, ``serve/engine.py``,
``serve/scheduler.py``) against the reference on the ``SMOKE`` configs of
qwen2 (dense attention), zamba2 (mamba + shared attention) and rwkv6
(attention-free), with the reference's weights carried across
(``experiments/carry.model_params_from_jax``) and numpy-seeded tokens.

Tolerances: fp32 logits within 5e-5 (matmul and exp summation orders
differ); bf16 logits within the reference's own 7e-2
(``tests/test_serving.py::test_decode_matches_forward``: bf16 rounding at
other places in the two frameworks), set on two layers.  zamba2's SMOKE
model has six: there bf16 logits are held within 0.15 (the reference's own
chunked and naive attention differ by 7.8e-2 on it), and fp32 logits with
the chunked attention within 1e-3 (its P·V product rounds probabilities to
bf16 in both packages — the reference's chunked and naive attention differ
by 2e-2 on it — so a probability that rounds to another bf16 value in one
framework than in the other moves the logits by ~1e-4 to 1e-3).  Greedy tokens and continuous-batching
completions are compared in fp32, where they are equal: in bf16 a logit
rounding can flip an argmax between two near-equal candidates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRunConfig
from repro.configs import get_smoke as jget_smoke
from repro.models import init_caches as jinit_caches
from repro.models import init_model as jinit_model
from repro.models import model_decode_step as jdecode
from repro.models import model_forward as jforward
from repro.serve.engine import generate as jgenerate
from repro.serve.engine import init_serve_state as jinit_serve_state
from repro.serve.engine import prefill as jprefill
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro_torch.config import RunConfig
from repro_torch.configs import get_smoke
from repro_torch.experiments.carry import model_params_from_jax
from repro_torch.models import (count_params, init_caches, init_model,
                                model_decode_step, model_forward)
from repro_torch.models import blocks
from repro_torch.serve.engine import (generate, init_serve_state, prefill,
                                      prefill_step, serve_step)
from repro_torch.serve.scheduler import ContinuousBatchingEngine

ATOL = {"float32": 5e-5, "bfloat16": 7e-2}
B, S = 2, 10
ARCHS = ["qwen2_1_5b", "zamba2_7b", "rwkv6_7b"]


def _cfgs(dtype, arch="qwen2_1_5b"):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


@pytest.fixture(scope="module", params=[
    pytest.param((arch, dtype),
                 id=dtype if arch == "qwen2_1_5b" else f"{arch}-{dtype}")
    for arch in ARCHS for dtype in ("float32", "bfloat16")])
def model(request):
    """(dtype, reference cfg, reference params, port cfg, port params)."""
    arch, dtype = request.param
    jcfg, cfg = _cfgs(dtype, arch)
    jp = jinit_model(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(lambda a: np.array(a, copy=True), jp)
    return dtype, jcfg, jp, cfg, model_params_from_jax(np_tree, cfg, "cpu")


def _run_kw(cfg, impl):
    """The RunConfig of one forward implementation: the attention impl; the
    kernels (flash, ssm_scan, wkv6 — Pallas in interpret mode in the
    reference) with "pallas"; and for rwkv6, whose forward has no
    attention, the unrolled chunked WKV with "chunked"."""
    return dict(attn_impl=impl, attn_q_chunk=4, attn_kv_chunk=4,
                use_pallas=impl == "pallas",
                unroll=impl == "chunked" and cfg.attention_free)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _atol(cfg, dtype, impl="naive"):
    """The module note's tolerances: ATOL on two layers, wider on six."""
    if cfg.n_layers <= 2:
        return ATOL[dtype]
    if dtype == "bfloat16":
        return 0.15
    return 1e-3 if impl == "chunked" else ATOL[dtype]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_model_forward_matches_reference(model, impl):
    """Each implementation of the port against the same one of the
    reference (its Pallas kernels in interpret mode on the CPU)."""
    dtype, jcfg, jp, cfg, p = model
    toks = _tokens(1, (B, S), cfg.vocab_size)
    kw = _run_kw(cfg, impl)
    want, _ = jax.jit(lambda p_, t: jforward(
        jcfg, JRunConfig(**kw), p_, {"tokens": t}))(
            jp, jnp.asarray(toks.copy()))
    run = RunConfig(**kw)
    got, aux = model_forward(cfg, run, p, {"tokens": torch.tensor(toks)})
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.float32
    assert float(aux["lb_loss"]) == 0.0
    _close(got, want, _atol(cfg, dtype, impl))
    assert count_params(p) == sum(int(np.prod(a.shape))
                                  for a in jax.tree.leaves(jp))


def test_decode_step_and_prefill_match_reference(model):
    """One decode step at a scalar position, then the decode-replay prefill:
    logits against the reference's, and the port's prefill against its own
    full-sequence forward (the reference's decode-vs-forward test)."""
    dtype, jcfg, jp, cfg, p = model
    jrun, run = JRunConfig(), RunConfig()
    toks = _tokens(2, (B, S), cfg.vocab_size)
    jcache = jinit_caches(jcfg, B, S + 2)
    want, _ = jdecode(jcfg, jrun, jp, jnp.asarray(toks[:, :1].copy()),
                      jnp.int32(0), jcache)
    caches = init_caches(cfg, B, S + 2, device="cpu")
    got, out = model_decode_step(cfg, run, p, torch.tensor(toks[:, :1]), 0,
                                 caches)
    assert out is caches
    _close(got, want, _atol(cfg, dtype))

    jstate = jinit_serve_state(jcfg, B, S + 2)
    jlog, jstate = jprefill(jcfg, jrun, jp, {"tokens": jnp.asarray(
        toks.copy())}, jstate)
    state = init_serve_state(cfg, B, S + 2, device="cpu")
    logits, new = prefill(cfg, run, p, {"tokens": torch.tensor(toks)}, state)
    assert new.caches is state.caches            # written in place
    assert int(new.position) == S == int(jstate.position)
    _close(logits, jlog, _atol(cfg, dtype))
    full = prefill_step(cfg, RunConfig(attn_impl="pallas", use_pallas=True),
                        p, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(logits.numpy(), full.numpy(),
                               atol=max(7e-2, _atol(cfg, dtype)))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Greedy tokens equal the reference's (fp32, see the module note)."""
    jcfg, cfg = _cfgs("float32", arch)
    jp = jinit_model(jcfg, jax.random.PRNGKey(3))
    p = model_params_from_jax(jax.tree.map(np.array, jp), cfg, "cpu")
    prompt = _tokens(4, (B, 5), cfg.vocab_size)
    want = np.asarray(jgenerate(jcfg, JRunConfig(), jp,
                                jnp.asarray(prompt.copy()), 6))
    got = generate(cfg, RunConfig(), p, torch.tensor(prompt), 6)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_matches_reference(arch):
    """Three requests through two slots (staggered admission, slot reuse):
    completions equal the reference engine's on the same requests (fp32)."""
    jcfg, cfg = _cfgs("float32", arch)
    jp = jinit_model(jcfg, jax.random.PRNGKey(5))
    p = model_params_from_jax(jax.tree.map(np.array, jp), cfg, "cpu")
    prompts = [[3, 14, 15, 9], [26, 5], [35, 8, 9, 7, 9]]
    jeng = JEngine(jcfg, JRunConfig(), jp, max_batch=2, max_len=16)
    eng = ContinuousBatchingEngine(cfg, RunConfig(), p, max_batch=2,
                                   max_len=16)
    for pr, n in zip(prompts, (4, 3, 4)):
        assert jeng.submit(pr, max_new_tokens=n) == eng.submit(
            pr, max_new_tokens=n)
    want, got = jeng.run_until_done(), eng.run_until_done()
    assert set(got) == set(want) == {0, 1, 2}
    for rid in want:
        assert got[rid].done and got[rid].generated == want[rid].generated
    assert eng.step() == 0 and all(r is None for r in eng.slot_req)


def test_serve_step_sampling_takes_a_generator():
    cfg = dataclasses.replace(get_smoke("qwen2_1_5b"), dtype="float32")
    p = init_model(cfg, 0, device="cpu")
    toks = torch.tensor([[1], [2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="rng"):
        serve_step(cfg, RunConfig(), p, toks, torch.tensor(0),
                   init_caches(cfg, 2, 4, device="cpu"), greedy=False)
    draws = [serve_step(cfg, RunConfig(), p, toks, torch.tensor(0),
                        init_caches(cfg, 2, 4, device="cpu"), greedy=False,
                        rng=torch.Generator().manual_seed(7))[0]
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert draws[0].shape == (2, 1) and draws[0].dtype == torch.int32


def test_carry_checks_every_leaf():
    jcfg, cfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.array, jinit_model(jcfg, jax.random.PRNGKey(0)))
    p = model_params_from_jax(tree, cfg, "cpu")
    assert p["units"]["block_0"]["attn"]["w_q"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p["embed"].view(torch.int16).numpy(),
        tree["embed"].view(np.int16))                 # bit for bit
    extra = dict(tree, spare=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="spare"):
        model_params_from_jax(extra, cfg, "cpu")
    short = dict(tree)
    del short["head"]
    with pytest.raises(ValueError, match="head"):
        model_params_from_jax(short, cfg, "cpu")
    wrong = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        model_params_from_jax(wrong, cfg, "cpu")


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_carry_maps_mamba_rwkv_and_shared_leaves(arch):
    """Every leaf of the reference's tree lands bit for bit at its path: the
    mamba and rwkv leaves (the fp32 ones in a bf16 model), and zamba2's
    shared trunk with no unit axis beside per-unit norms."""
    jcfg, cfg = _cfgs("bfloat16", arch)
    tree = jax.tree.map(np.array, jinit_model(jcfg, jax.random.PRNGKey(1)))
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
    if arch == "zamba2_7b":
        unit = p["units"]["block_1"]
        assert set(p["shared"]) == {"attn", "mlp"}
        assert p["shared"]["attn"]["w_q"].shape[0] == cfg.d_model
        assert set(p["units"]["block_0"]) == {"norm1", "norm2"}
        assert unit["mamba"]["dt_bias"].dtype == torch.float32
        assert unit["mamba"]["dt_bias"].shape == (cfg.n_units,
                                                  cfg.ssm_n_heads)
    else:
        assert "shared" not in p
        rw = p["units"]["block_0"]["rwkv"]
        assert rw["bonus_u"].dtype == rw["decay_w0"].dtype == torch.float32
    assert count_params(p) == sum(int(np.prod(a.shape))
                                  for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("block", ["moe", "moe_dense"])
def test_other_blocks_name_their_roadmap_item(block):
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        blocks.init_block(block, None, get_smoke("qwen2_1_5b"),
                          torch.float32, "meta")
