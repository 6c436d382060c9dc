"""The port's RWKV6 path (``repro_torch.kernels.wkv6``,
``repro_torch.models.rwkv``, ``layers.sqrelu_ffn``) against the reference
(``repro``), on the same numpy-seeded inputs.

* ``wkv6``'s plain version against the reference's Pallas kernel run in
  interpret mode and against the recurrence (``wkv_recurrent``,
  ``ref.wkv6_ref``), over S (a ragged S with padding), P and chunk, at a
  decay strong enough that exp(cum⁻_i − cum_j) for j ≥ i overflows;
  ``wkv_chunked`` from a nonzero state; the wrapper's refusal of an
  ``init_state``.
* :func:`staged_wkv`, the CUDA kernels' decomposition in plain PyTorch
  (groups of chunks, the pass over them, the pair term factored or direct
  by each chunk's decay span), against the plain version and the Pallas
  kernel in interpret mode; the kernels' scratch shapes.
* The time mix (``use_pallas`` True and False, and the unrolled chunked
  path), the channel mix, both decode functions (the cache written in
  place) and ``sqrelu_ffn`` on weights carried from the reference; the
  init's leaves (``decay_w0`` and ``bonus_u`` fp32 in a bf16 model).

Tolerances, fixed from the dtype: fp32 within 2e-5 of the output's largest
magnitude against the Pallas kernel and the recurrence (the chunked closed
form sums in another order than XLA's and than the step-by-step
recurrence), plus 2⁻²⁰ of the largest cumulative log decay of a chunk
(:func:`decay_span`: exp(cum⁻_i − cum_j) inherits the rounding of both
sums, about 2e-4 of the output at the strong decay); block outputs within 5e-5 in fp32 and 7e-2 in bf16 (the
reference's serving tolerance).  Tests marked ``cuda`` hold the CUDA kernel
against its plain version on a card (output and final state within 1e-5 of
their largest magnitudes plus the same decay term) and skip without one.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.experiments.carry import _tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import layers, rwkv

_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def J():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke as jget_smoke
    from repro.kernels import ref, wkv6
    from repro.models import layers, rwkv
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, wk=wkv6, ref=ref,
                                 rwkv=rwkv, layers=layers,
                                 get_smoke=jget_smoke)


def _j(x, dtype="float32"):
    """A private jax copy of a numpy array in ``dtype``."""
    import jax.numpy as jnp
    return jnp.asarray(np.array(x, np.float32, copy=True),
                       jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _t(x, dtype="float32"):
    return torch.tensor(np.array(x, np.float32)).to(_T[dtype])


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _near(got, want, rel):
    """max |got − want| ≤ rel · max |want| (and everything finite)."""
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def decay_span(w, chunk):
    """The largest |cumulative log decay| within one chunk (the log decay
    is ≤ 0, so the chunk's total): exp(cum_i − cum_j) is formed from two
    sums of up to this magnitude, each rounded to its fp32 ulp, so a decay
    term carries a relative error of a few ulps of it (2⁻²⁰ · span is
    eight) — a rounding both chunked versions share and no summation order
    removes."""
    x = np.asarray(w, np.float64)
    Q = min(chunk, x.shape[1])
    nc = -(-x.shape[1] // Q)
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, nc * Q - x.shape[1])
    x = np.pad(x, pad).reshape(x.shape[0], nc, Q, *x.shape[2:])
    return float(-x.sum(axis=2).min())


def wkv_inputs(seed, Bt, S, H, P, strong=True):
    """r, k, v, the log decay w and the bonus u.  ``strong``: w about −12
    per step, so a chunk's decay sums past −88 and exp of the pair term's
    argument for j ≥ i overflows; else the reference tests' w ≈ −0.14."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((Bt, S, H, P)).astype(np.float32) * 0.5
               for _ in range(3))
    z = rng.standard_normal((Bt, S, H, P)).astype(np.float32) * 0.5
    w = -np.exp(z + (2.5 if strong else -2.0)).astype(np.float32)
    u = (rng.standard_normal((H, P)) * 0.3).astype(np.float32)
    return r, k, v, w, u


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,P,chunk,strong", [
    (16, 8, 8, True), (48, 16, 16, False), (70, 8, 32, True),
    (64, 16, 32, False)])
def test_wkv6_plain_matches_pallas_interpret_and_recurrence(S, P, chunk,
                                                            strong, J):
    r, k, v, w, u = wkv_inputs(S * 31 + P, 2, S, 3, P, strong)
    if strong:          # exp(cum⁻_i − cum_j) for j ≥ i is inf
        assert np.cumsum(w[0, :min(chunk, S)], 0).min() < -89
    want_y, want_s = J.wk.wkv6(*(_j(t) for t in (r, k, v, w, u)),
                               chunk=chunk, interpret=True)
    rec_y, rec_s = ref.wkv6_ref(*(_t(t) for t in (r, k, v, w, u)))
    wk.reset_launches()
    y, s = ops.wkv6(*(_t(t) for t in (r, k, v, w, u)), chunk=chunk)
    assert wk.launches["wkv6"] == 0                   # no kernel on the CPU
    assert y.shape == r.shape and y.dtype == torch.float32
    assert s.shape == (2, 3, P, P) and s.dtype == torch.float32
    span = 2.0 ** -20 * decay_span(w, chunk)
    for want in (want_y, rec_y):
        _near(y, want, 2e-5 + span)
    for want in (want_s, rec_s):
        _near(s, want, 2e-5 + span)
    jrec_y, jrec_s = J.ref.wkv6_ref(*(_j(t) for t in (r, k, v, w, u)))
    _near(rec_y, jrec_y, 2e-5)
    _near(rec_s, jrec_s, 2e-5)


def mixed_inputs(seed, Bt, S, H, P, chunk):
    """``wkv_inputs`` whose odd chunks carry the strong decay and even
    chunks the model's, so one call's chunks fall on both sides of the
    kernel's factored-form limit (``wkv6.FACTOR_SPAN``)."""
    r, k, v, w, u = wkv_inputs(seed, Bt, S, H, P, strong=False)
    ws = wkv_inputs(seed + 1, Bt, S, H, P, strong=True)[3]
    odd = (np.arange(S) // min(chunk, S)) % 2 == 1
    return r, k, v, np.where(odd[None, :, None, None], ws, w), u


# decay spans of a chunk around the kernel's factored-form limit (60):
# well inside it, just under and just over
EDGE_SPANS = (20.0, 30.0, 40.0, 50.0, 58.0, 59.9, 60.1)


def edge_inputs(seed, Bt, S, H, P, chunk):
    """``wkv_inputs`` at the mild decay with w scaled per (b, chunk, h) so
    that the chunk's decay span (its largest |cumulative log decay| over
    the channels) is one of ``EDGE_SPANS``, in turn along b + chunk + h:
    the factored pair term's factors reach e^±29, and the chunks just over
    ``wkv6.FACTOR_SPAN`` take the direct form in the same call."""
    r, k, v, w, u = wkv_inputs(seed, Bt, S, H, P, strong=False)
    Q = min(chunk, S)
    nc = -(-S // Q)
    x = np.pad(w.astype(np.float64), [(0, 0), (0, nc * Q - S), (0, 0),
                                       (0, 0)]).reshape(Bt, nc, Q, H, P)
    span = -x.sum(axis=2).min(axis=-1)                       # (B, nc, H)
    turn = (np.arange(Bt)[:, None, None] + np.arange(nc)[None, :, None]
            + np.arange(H)[None, None, :]) % len(EDGE_SPANS)
    x = x * (np.asarray(EDGE_SPANS)[turn] / span)[:, :, None, :, None]
    return r, k, v, x.reshape(Bt, nc * Q, H, P)[:, :S].astype(np.float32), u


def staged_wkv(r, k, v, w, u, chunk, group):
    """The CUDA kernels' staged algorithm (``csrc/wkv6.cu``) in plain
    PyTorch fp32: 1. per group of ``group`` chunks, its state contribution
    from zero and its decay, chained chunk by chunk; 2. the pass over the
    groups, keeping the state entering each; 3. each group's chunks from
    its entering state, the pair term factored (exp(cx − m) · exp(m − cum),
    m the midpoint of cum's range) where the (b, h) chunk's span is at most
    ``FACTOR_SPAN``, else formed directly, masked before the exponential.
    Returns (out, final state, (factored, direct) chunk counts)."""
    F = torch.nn.functional
    Bt, S, H, P = r.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    ng = -(-nc // group)

    def blocks(t):          # → (B, H, nc, Q, P), zero past S
        t = F.pad(t.float(), (0, 0, 0, 0, 0, nc * Q - S))
        return t.reshape(Bt, nc, Q, H, P).permute(0, 3, 1, 2, 4)

    rb, kb, vb, wb = (blocks(t) for t in (r, k, v, w))
    cum = torch.cumsum(wb, dim=-2)
    last = cum[..., -1, :]                                     # (B,H,nc,P)
    kw = kb * torch.exp(last[..., None, :] - cum)
    dS = torch.zeros(Bt, H, ng, P, P)                          # stage 1
    dg = torch.ones(Bt, H, ng, P)
    for c in range(nc):
        g = c // group
        dS[:, :, g] = (torch.exp(last[:, :, c])[..., None] * dS[:, :, g]
                       + kw[:, :, c].transpose(-1, -2) @ vb[:, :, c])
        dg[:, :, g] = dg[:, :, g] * torch.exp(last[:, :, c])
    enter = torch.empty_like(dS)                               # stage 2
    s = torch.zeros(Bt, H, P, P)
    for g in range(ng):
        enter[:, :, g] = s
        s = dg[:, :, g][..., None] * s + dS[:, :, g]
    out = torch.empty(Bt, H, nc, Q, P)                         # stage 3
    cx = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], -2)
    lo = torch.clamp(cum.amin(-2), max=0.0)
    hi = torch.clamp(cum.amax(-2), min=0.0)
    fac = (hi - lo).amax(-1) <= wk.FACTOR_SPAN                 # (B,H,nc)
    strict = torch.ones(Q, Q, dtype=torch.bool).tril(-1)
    bonus = (rb * u.float()[None, :, None, None, :] * kb).sum(-1)
    for g in range(ng):
        st = enter[:, :, g]
        for c in range(g * group, min((g + 1) * group, nc)):
            rc, kc, vc = rb[:, :, c], kb[:, :, c], vb[:, :, c]
            re = rc * torch.exp(cx[:, :, c])
            m = 0.5 * (lo[:, :, c] + hi[:, :, c])[..., None, :]
            A_fac = ((re * torch.exp(-m))
                     @ (kw[:, :, c] * torch.exp(m - last[:, :, c][..., None, :])
                        ).transpose(-1, -2))
            diff = cx[:, :, c][..., :, None, :] - cum[:, :, c][..., None, :, :]
            E = torch.exp(torch.where(strict[..., None], diff, -torch.inf))
            A_dir = (rc[..., :, None, :] * kc[..., None, :, :] * E).sum(-1)
            A = torch.where(fac[:, :, c][..., None, None], A_fac, A_dir)
            A = torch.where(strict, A, 0.0) + torch.diag_embed(bonus[:, :, c])
            out[:, :, c] = re @ st + A @ vc
            if c + 1 < min((g + 1) * group, nc):
                st = (torch.exp(last[:, :, c])[..., None] * st
                      + kw[:, :, c].transpose(-1, -2) @ vc)
    out = out.permute(0, 2, 3, 1, 4).reshape(Bt, nc * Q, H, P)[:, :S]
    n_fac = int(fac.sum())
    return out, s, (n_fac, fac.numel() - n_fac)


@pytest.mark.parametrize("S,P,chunk,decay", [
    (1, 8, 16, "model"), (31, 16, 16, "mixed"), (33, 8, 16, "mixed"),
    (63, 16, 32, "strong"), (65, 8, 32, "mixed"), (300, 16, 32, "mixed"),
    (300, 8, 16, "model"), (100, 8, 16, "edge"), (300, 16, 32, "edge")])
def test_staged_wkv_matches_plain_and_pallas_interpret(S, P, chunk, decay,
                                                       J):
    """The kernels' decomposition on the CPU, before any card, at G = 2
    chunks a group (S of one group ± 1 crosses a group's edge): against
    ``wkv6_plain`` and the reference's Pallas kernel in interpret mode,
    within this file's CPU tolerance, each case at its own largest chunk
    decay; the mixed and edge decays take both pair-term forms in one
    call, the edge decay with spans up to just under the factored form's
    limit and just over it."""
    if decay == "mixed":
        ops = mixed_inputs(S + P, 2, S, 3, P, chunk)
    elif decay == "edge":
        ops = edge_inputs(S + P, 2, S, 3, P, chunk)
    else:
        ops = wkv_inputs(S + P, 2, S, 3, P, strong=decay == "strong")
    y, s, (n_fac, n_dir) = staged_wkv(*(_t(t) for t in ops), chunk, 2)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    if decay in ("mixed", "edge"):
        assert n_fac > 0 and n_dir > 0
    else:
        assert (n_dir if decay == "model" else n_fac) == 0
    py, ps = wk.wkv6_plain(*(_t(t) for t in ops), chunk=chunk)
    want_y, want_s = J.wk.wkv6(*(_j(t) for t in ops), chunk=chunk,
                               interpret=True)
    span = 2.0 ** -20 * decay_span(ops[3], chunk)
    for got, want in ((y, py), (s, ps), (y, want_y), (s, want_s)):
        _near(got, want, 2e-5 + span)


def test_wkv6_scratch_shapes():
    """The group states and decays: ⌈⌈S / Q⌉ / GROUP⌉ groups, a ragged last
    group included; rwkv6_7b's prefill layer holds 16.8 MB of states."""
    S = 2 * wk.GROUP * 16 + 1
    assert wk.scratch_shapes(2, S, 3, 8, 16) == ((2, 3, 3, 8, 8),
                                                 (2, 3, 3, 8))
    st, dg = wk.scratch_shapes(1, 8192, 64, 64, 32)
    assert st == (1, 256 // wk.GROUP, 64, 64, 64)
    assert np.prod(st) * 4 == 16_777_216 and dg == st[:-1]


def test_wkv_chunked_from_a_state(J):
    """The reference's unrolled chunked path from a nonzero state at a
    ragged S, against the port's (the kernel's plain version)."""
    r, k, v, w, u = wkv_inputs(5, 2, 70, 2, 8, strong=False)
    s0 = np.random.default_rng(6).standard_normal((2, 2, 8, 8)).astype(
        np.float32)
    want_y, want_s = J.rwkv.wkv_chunked(*(_j(t) for t in (r, k, v, w, u)),
                                        chunk=16, init_state=_j(s0))
    y, s = rwkv.wkv_chunked(*(_t(t) for t in (r, k, v, w, u)), chunk=16,
                            init_state=_t(s0))
    _near(y, want_y, 2e-5)
    _near(s, want_s, 2e-5)
    rec_y, rec_s = rwkv.wkv_recurrent(*(_t(t) for t in (r, k, v, w, u)),
                                      init_state=_t(s0))
    _near(y, rec_y, 2e-5)
    _near(s, rec_s, 2e-5)


def test_wkv6_refuses_an_initial_state():
    """The kernel starts from zero; the reference's ops.wkv6 would drop a
    state silently, the port's raises."""
    r, k, v, w, u = (_t(t) for t in wkv_inputs(0, 1, 8, 2, 4))
    with pytest.raises(ValueError, match="zero state"):
        ops.wkv6(r, k, v, w, u, init_state=torch.zeros(1, 2, 4, 4))
    with pytest.raises(ValueError, match="fp32"):
        ops.wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="one dtype"):
        ops.wkv6(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        ops.wkv6(r, k, v, w, u[:1])


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _carried_rwkv(J, dtype):
    """(reference cfg, reference params, port cfg, port params) of one rwkv
    layer of rwkv6's SMOKE config."""
    jcfg = dataclasses.replace(J.get_smoke("rwkv6_7b"), dtype=dtype)
    cfg = dataclasses.replace(get_smoke("rwkv6_7b"), dtype=dtype)
    jd = J.jnp.bfloat16 if dtype == "bfloat16" else J.jnp.float32
    jp = J.rwkv.init_rwkv(J.jax.random.PRNGKey(4), jcfg, jd)
    p = J.jax.tree.map(lambda a: _tensor_from_numpy(np.asarray(a)), jp)
    return jcfg, jp, cfg, p


def _tol(dtype):
    return 5e-5 if dtype == "float32" else 7e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_leaves(dtype, J):
    """Leaf for leaf the reference's shapes and dtypes, stacked over a lead
    axis; decay_w0 and bonus_u fp32 in any model dtype."""
    jcfg, jp, cfg, _ = _carried_rwkv(J, dtype)
    jd = jp["w_r"].dtype
    units = J.jax.vmap(lambda k: J.rwkv.init_rwkv(k, jcfg, jd))(
        J.jax.random.split(J.jax.random.PRNGKey(0), 3))
    p = rwkv.init_rwkv(torch.Generator().manual_seed(0), cfg, _T[dtype],
                       "cpu", (3,))
    want = dict(J.jax.tree_util.tree_flatten_with_path(units)[0])
    got = dict(J.jax.tree_util.tree_flatten_with_path(p)[0])
    assert set(got) == set(want)
    for path, v in want.items():
        t = _tensor_from_numpy(np.asarray(v))
        assert tuple(got[path].shape) == tuple(t.shape), path
        assert got[path].dtype == t.dtype, path
    for k in ("decay_w0", "bonus_u"):
        assert p[k].dtype == torch.float32
    for k in ("mu_r", "mu_ck", "decay_w0", "ln_x_scale"):
        np.testing.assert_array_equal(_np(p[k]), _np(units[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["recurrent", "pallas", "unrolled"])
def test_time_and_channel_mix_match_reference(path, dtype, J):
    """``rwkv_forward`` through each of its three WKV paths, then
    ``rwkv_channel_mix``, at S = 40 (two chunks of the kernel, the second
    ragged)."""
    jcfg, jp, cfg, p = _carried_rwkv(J, dtype)
    x = np.random.default_rng(12).standard_normal((2, 40, cfg.d_model))
    kw = dict(use_pallas=path == "pallas", unroll=path == "unrolled")
    want = J.jax.jit(lambda p_, x_: J.rwkv.rwkv_forward(jcfg, p_, x_, **kw))(
        jp, _j(x, dtype))
    got = rwkv.rwkv_forward(cfg, p, _t(x, dtype), **kw)
    assert got.dtype == _T[dtype] and got.shape == (2, 40, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))
    want = J.rwkv.rwkv_channel_mix(jcfg, jp, _j(x, dtype))
    got = rwkv.rwkv_channel_mix(cfg, p, _t(x, dtype))
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_time_and_channel_mix_write_the_cache_in_place(dtype, J):
    """Five decode steps of both halves from an empty cache (views into a
    stacked cache) against the reference's, and against the full-sequence
    time mix."""
    jcfg, jp, cfg, p = _carried_rwkv(J, dtype)
    x = np.random.default_rng(13).standard_normal((2, 5, cfg.d_model))
    stacked = rwkv.init_rwkv_cache(cfg, 2, _T[dtype], "cpu", (2,))
    cache = {k: v[0] for k, v in stacked.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    jcache = J.rwkv.init_rwkv_cache(jcfg, 2, _j(x, dtype).dtype)
    outs = []
    for t in range(5):
        xt = x[:, t:t + 1]
        want, jcache = J.rwkv.rwkv_decode_time_mix(jcfg, jp, _j(xt, dtype),
                                                   jcache)
        got, out = rwkv.rwkv_decode_time_mix(cfg, p, _t(xt, dtype), cache)
        assert out is cache
        np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))
        outs.append(got)
        want, jcache = J.rwkv.rwkv_decode_channel_mix(jcfg, jp,
                                                      _j(xt, dtype), jcache)
        got, _ = rwkv.rwkv_decode_channel_mix(cfg, p, _t(xt, dtype), cache)
        np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert all(float(v[1].abs().sum()) == 0 for v in stacked.values())
    for k in cache:
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   atol=_tol(dtype))
    np.testing.assert_allclose(
        _np(torch.cat(outs, 1)), _np(rwkv.rwkv_forward(cfg, p, _t(x, dtype))),
        atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sqrelu_ffn(dtype, J):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    p = {"w_k": rng.standard_normal((16, 24)).astype(np.float32) * 0.25,
         "w_v": rng.standard_normal((24, 16)).astype(np.float32) * 0.2}
    got = layers.sqrelu_ffn(_t(x, dtype), {k: _t(w, dtype)
                                           for k, w in p.items()})
    want = J.layers.sqrelu_ffn(_j(x, dtype), {k: _j(w, dtype)
                                              for k, w in p.items()})
    assert got.dtype == _T[dtype]
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-5 if dtype == "float32" else 0.1)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA wkv6 kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,P,S,chunk,dtype,strong", [
    (64, 64, 1000, 32, "bfloat16", True),    # rwkv6's head, ragged S
    (64, 64, 1000, 32, "bfloat16", False),
    (8, 32, 300, 32, "float32", False),      # rwkv6's SMOKE head
    (4, 128, 77, 16, "bfloat16", True),
    (2, 64, 20, 32, "float32", False),       # one chunk shorter than 32
    (64, 64, wk.GROUP * 32 - 1, 32, "bfloat16", False),  # a group less 1
    (64, 64, wk.GROUP * 32 + 1, 32, "bfloat16", False),  # a group and 1
    (8, 64, 2000, 32, "float32", "mixed"),   # both pair-term forms
    (4, 128, 2000, 16, "bfloat16", "mixed"),
    (8, 64, 2000, 32, "float32", "edge"),    # spans 20 to 60.1
    (4, 128, 700, 16, "bfloat16", "edge")])
def test_wkv6_kernel_matches_plain_on_card(H, P, S, chunk, dtype, strong,
                                           cuda):
    """Tolerance: 1e-5 of the largest |out| and |state| (fp32 sums in
    another order, FMAs allowed) plus the cumulative decay's rounding
    (:func:`decay_span`).  S crosses the kernels' groups of chunks; the
    mixed and edge decays put chunks on both sides of the factored form's
    limit, the edge decay just under and just over it."""
    if strong == "mixed":
        r, k, v, w, u = mixed_inputs(H + S, 2, S, H, P, chunk)
    elif strong == "edge":
        r, k, v, w, u = edge_inputs(H + S, 2, S, H, P, chunk)
    else:
        r, k, v, w, u = wkv_inputs(H + S, 2, S, H, P, strong)
    tr, tk, tv = (_t(x, dtype).to(cuda) for x in (r, k, v))
    tw, tu = _t(w).to(cuda), _t(u).to(cuda)
    wk.reset_launches()
    y, s = ops.wkv6(tr, tk, tv, tw, tu, chunk=chunk)
    assert wk.launches["wkv6"] == 1
    py, ps = wk.wkv6_plain(tr, tk, tv, tw, tu, chunk=chunk)
    torch.cuda.synchronize()
    span = 2.0 ** -20 * decay_span(w, chunk)
    _near(y.cpu(), py.cpu(), 1e-5 + span)
    _near(s.cpu(), ps.cpu(), 1e-5 + span)


@pytest.mark.cuda
def test_wkv6_kernel_scratch_covers_a_ragged_last_group(cuda):
    """B 2 and S = 2 groups of chunks + 40 steps: the scratch holds 3
    groups per (b, h), the last of them 2 chunks (one ragged), and every
    output row and the state come out as the plain version's."""
    S, H, P, chunk = 2 * wk.GROUP * 32 + 40, 4, 64, 32
    assert wk.scratch_shapes(2, S, H, P, chunk) == ((2, 3, H, P, P),
                                                    (2, 3, H, P))
    r, k, v, w, u = (_t(x).to(cuda) for x in wkv_inputs(7, 2, S, H, P, False))
    y, s = ops.wkv6(r, k, v, w, u, chunk=chunk)
    py, ps = wk.wkv6_plain(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    span = 2.0 ** -20 * decay_span(w.cpu().numpy(), chunk)
    _near(y.cpu(), py.cpu(), 1e-5 + span)
    _near(s.cpu(), ps.cpu(), 1e-5 + span)


@pytest.mark.cuda
def test_wkv6_kernel_refuses_other_shapes(cuda):
    r, k, v, w, u = (_t(t).to(cuda) for t in wkv_inputs(0, 1, 40, 2, 16))
    with pytest.raises(ValueError, match="head dim"):
        ops.wkv6(r, k, v, w, u)
    r, k, v, w, u = (_t(t).to(cuda) for t in wkv_inputs(0, 1, 40, 2, 32))
    with pytest.raises(ValueError, match="chunks up to"):
        ops.wkv6(r, k, v, w, u, chunk=40)
