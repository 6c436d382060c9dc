"""The port's Mamba2 path (``repro_torch.kernels.ssm_scan``,
``repro_torch.models.ssm``) against the reference (``repro``), on the same
numpy-seeded inputs.

* ``ssm_scan``'s plain version against the reference's Pallas kernel run in
  interpret mode and against the sequential oracle (``ref.ssm_ref``), over
  S (a ragged S with padding), N and chunk, at a decay whose chunk sums
  reach −1 500: exp(cum_i − cum_j) above the diagonal overflows there.
* ``ssd_chunked`` from a nonzero state, ``ssd_decode_step`` and
  ``kernels.mamba_glue.causal_conv_plain`` with history; ``mamba_forward`` (``use_pallas`` True
  and False) and ``mamba_decode`` on weights carried from the reference;
  the init's leaves (the fp32 ones in a bf16 model, ``dt_bias`` equal).

Tolerances, fixed from the dtype: fp32 within 2e-5 of the output's largest
magnitude against the Pallas kernel and the reference's ``ssd_chunked`` (the
same chunked algorithm; XLA and PyTorch sum up to 256 terms in other
orders), 5e-5 against the sequential oracle (another algorithm), each plus
2⁻²⁰ of the largest cumulative log decay of a chunk (:func:`decay_span`:
the chunked form's exp(cum_i − cum_j) inherits the rounding of both sums);
``mamba_forward`` / ``mamba_decode`` outputs within 5e-5 in fp32 and 7e-2
in bf16 (the reference's serving tolerance: bf16 rounds at other places in
the two frameworks).  Tests marked ``cuda`` hold the CUDA kernel against
its plain version on a card (y and the final state within 1e-5 of their
largest magnitudes plus the same decay term) and skip without one.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.experiments.carry import _tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as sk
from repro_torch.kernels.mamba_glue import causal_conv_plain
from repro_torch.models import ssm
import tf32_split

_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def J():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.config import ModelConfig
    from repro.configs import get_smoke as jget_smoke
    from repro.kernels import ref, ssm_scan
    from repro.models import ssm
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, sk=ssm_scan,
                                 ref=ref, ssm=ssm, get_smoke=jget_smoke,
                                 ModelConfig=ModelConfig)


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


def decay_span(a, chunk):
    """The largest |cumulative log decay| within one chunk (the log decay
    is ≤ 0, so the chunk's total): exp(cum_i − cum_j) is formed from two
    sums of up to this magnitude, each rounded to its fp32 ulp, so a decay
    term carries a relative error of a few ulps of it (2⁻²⁰ · span is
    eight) — a rounding both chunked versions share and no summation order
    removes."""
    x = np.asarray(a, np.float64)
    Q = min(chunk, x.shape[1])
    nc = -(-x.shape[1] // Q)
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, nc * Q - x.shape[1])
    x = np.pad(x, pad).reshape(x.shape[0], nc, Q, *x.shape[2:])
    return float(-x.sum(axis=2).min())


def scan_inputs(seed, Bt, S, H, P, N, G=1, decay=40.0):
    """x·dt, a = dt·A with A = −decay·(1…H) and dt in [1e-3, 0.1] (at 40 a
    chunk of 256 steps sums to about −1 500 at the last head; at 1 the
    model's A = −(1…H)), B and C ((Bt, S, N), or (Bt, S, G, N) for G
    groups)."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(1e-3, 0.1, (Bt, S, H)).astype(np.float32)
    x = (rng.standard_normal((Bt, S, H, P)) * dt[..., None]).astype(
        np.float32)
    a = (dt * -decay * np.arange(1, H + 1, dtype=np.float32)).astype(
        np.float32)
    bc = (Bt, S, N) if G == 1 else (Bt, S, G, N)
    Bm = rng.standard_normal(bc).astype(np.float32)
    Cm = rng.standard_normal(bc).astype(np.float32)
    return x, a, Bm, Cm


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
def staged_scan(x, a, Bm, Cm, chunk, tile=64, mm=None):
    """The CUDA kernel's staged algorithm (``csrc/ssm_scan.cu``) in plain
    PyTorch fp32, tile for tile: 1. C·Bᵀ per (b, chunk) over the 64 × 64
    tiles J ≤ I only, j-major (the other tiles stay NaN, so reading one
    shows); 2. the cumulative sums and each chunk's state contribution
    dS_c = Bᵀ diag(exp(cum_Q − cum)) x; 3. the pass S_c = exp(cum_Q) S_{c−1}
    + dS_c, keeping the state entering each chunk; 4. y per 64-row block,
    the inter-chunk term plus the tiles J ≤ I with the decay masked before
    the exponential.  Every tile product is ``mm(a, b, split_a, split_b)``
    (a plain fp32 product when None), each operand marked as the kernel
    splits it: B and C when fp32 (a bf16 B or C is exact in TF32), x, the
    state, w∘x and the decayed C·Bᵀ always.  Grouped B / C ((Bt, S, G, N))
    run once per group over its H / G heads.  Returns (y, final state)."""
    if Bm.dim() == 4:
        hg = x.shape[2] // Bm.shape[2]
        parts = [staged_scan(x[:, :, g * hg:(g + 1) * hg],
                             a[..., g * hg:(g + 1) * hg], Bm[:, :, g],
                             Cm[:, :, g], chunk, tile, mm)
                 for g in range(Bm.shape[2])]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([st for _, st in parts], dim=1))
    if mm is None:
        def mm(p, q, split_p, split_q):
            return p @ q
    sp = Bm.dtype == torch.float32
    F = torch.nn.functional
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xs = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, Q, H, P)
    As = F.pad(a, (0, 0, 0, pad)).reshape(Bt, nc, Q, H)
    Bs = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bt, nc, Q, N)
    Cs = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bt, nc, Q, N)
    nb = -(-Q // tile)
    blk = [slice(k * tile, min(Q, (k + 1) * tile)) for k in range(nb)]
    cb = torch.full((Bt, nc, Q, Q), float("nan"))                 # step 1
    for I in range(nb):
        for J in range(I + 1):
            cb[:, :, blk[J], blk[I]] = mm(
                Bs[:, :, blk[J]], Cs[:, :, blk[I]].transpose(-1, -2), sp, sp)
    cum = torch.cumsum(As, dim=2)                                 # step 2
    total = cum[:, :, -1]                                         # (Bt,nc,H)
    w = torch.exp(total[:, :, None] - cum)
    dS = mm(Bs.transpose(-1, -2)[:, :, None],                      # (b,c,h,n,p)
            (w[..., None] * xs).transpose(2, 3), sp, True)
    st = torch.empty_like(dS)                                     # step 3
    s = torch.zeros(Bt, H, N, P)
    for c in range(nc):
        st[:, c] = s
        s = torch.exp(total[:, c])[..., None, None] * s + dS[:, c]
    y = torch.zeros(Bt, nc, Q, H, P)                              # step 4
    rows = torch.arange(Q)
    for I in range(nb):
        i = blk[I]
        yI = torch.exp(cum[:, :, i])[..., None] * mm(
            Cs[:, :, i][:, :, None], st, sp, True).transpose(2, 3)
        for J in range(I + 1):
            j = blk[J]
            live = (rows[j][:, None] <= rows[i][None, :])[..., None]
            d = torch.where(live, cum[:, :, i][:, :, None]
                            - cum[:, :, j][:, :, :, None], -torch.inf)
            A = torch.where(live, cb[:, :, j, i][..., None] * torch.exp(d),
                            0.0)                                  # (b,c,j,i,h)
            yI = yI + mm(A.permute(0, 1, 4, 3, 2),                 # (b,c,h,i,j)
                         xs[:, :, j].transpose(2, 3), True, True
                         ).transpose(2, 3)
        y[:, :, i] = yI
    return y.reshape(Bt, nc * Q, H, P)[:, :S], s


@pytest.mark.parametrize("S,N,P,chunk", [(100, 16, 8, 32), (333, 8, 8, 256),
                                         (300, 16, 4, 128),
                                         (200, 8, 8, 64)])
def test_staged_scan_matches_plain_and_pallas_interpret(S, N, P, chunk, J):
    """The kernel's decomposition on the CPU, before any card: against
    ``ssm_scan_plain`` and the reference's Pallas kernel in interpret mode,
    within this file's CPU tolerance, at ragged S and 1 to 4 row blocks
    per chunk."""
    x, a, Bm, Cm = scan_inputs(S + chunk, 2, S, 3, P, N)
    y, s = staged_scan(*(_t(t) for t in (x, a, Bm, Cm)), chunk)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    py, ps = sk.ssm_scan_plain(*(_t(t) for t in (x, a, Bm, Cm)), chunk=chunk)
    want_y, want_s = J.sk.ssm_scan(*(_j(t) for t in (x, a, Bm, Cm)),
                                   chunk=chunk, interpret=True)
    span = 2.0 ** -20 * decay_span(a, chunk)
    for got, want in ((y, py), (s, ps), (y, want_y), (s, want_s)):
        _near(got, want, 2e-5 + span)


def _split_mm(p, q, split_p, split_q):
    return tf32_split.matmul_split(p, q, split_p, split_q)


def _big_mm(p, q, split_p, split_q):
    return tf32_split.matmul_tf32(p, q)


def _emulation_case(bc, N, G, decay):
    """The kernel's split-TF32 staged scan and the plain version on one
    input: B 1, a ragged S = 300 (a 256-row chunk of four row blocks, then
    a chunk of 44 rows), H 4, P 32, chunk 256; B and C rounded to ``bc``
    first, as the kernel receives them.  Returns (y, state, plain y, plain
    state, the card test's limit as a share of max |plain|)."""
    x, a, Bm, Cm = scan_inputs(N + G, 1, 300, 4, 32, N, G, decay)
    Bt, Ct = (_t(t, bc) for t in (Bm, Cm))
    y, s = staged_scan(_t(x), _t(a), Bt, Ct, 256, mm=_split_mm)
    py, ps = sk.ssm_scan_plain(_t(x), _t(a), Bt, Ct, chunk=256)
    return y, s, py, ps, 1e-5 + 2.0 ** -20 * decay_span(a, 256)


@pytest.mark.parametrize("decay", [40.0, 1.0])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("bc", ["bfloat16", "float32"])
def test_staged_scan_split_tf32_emulation_matches_plain(bc, N, G, decay):
    """The CUDA kernel's products as it takes them on the tensor cores
    (``csrc/ssm_scan.cu``: split TF32, each operand rounded by bit masks as
    ``cvt.rna`` rounds): an fp32 operand split into its TF32 big part and
    the TF32 rounding of its remainder, a bf16 B or C exact and unsplit.
    Through the staged scan, within the card test's tolerance of
    ``ssm_scan_plain`` (1e-5 + 2⁻²⁰ · decay span of max |plain|), at the
    strong decay (a span of ~2 000: exp above the diagonal overflows) and
    the model's."""
    y, s, py, ps, rel = _emulation_case(bc, N, G, decay)
    if decay > 1:
        assert rel > 1e-3          # the large span the kernel must mask
    _near(y, py, rel)
    _near(s, ps, rel)


def test_scan_tf32_big_products_alone_miss_the_tolerance():
    """The split is needed: with big·big alone (one TF32 pass, ~2⁻¹¹
    relative per operand) the staged scan misses the card test's tolerance
    at the model's decay, where the split products hold it."""
    x, a, Bm, Cm = scan_inputs(130, 1, 300, 4, 32, 128, 1, 1.0)
    ops = (_t(x), _t(a), _t(Bm), _t(Cm))
    py, ps = sk.ssm_scan_plain(*ops, chunk=256)
    rel = 1e-5 + 2.0 ** -20 * decay_span(a, 256)
    lim = rel * float(py.abs().max())
    one, _ = staged_scan(*ops, 256, mm=_big_mm)
    three, _ = staged_scan(*ops, 256, mm=_split_mm)
    assert float((one - py).abs().max()) > lim
    assert float((three - py).abs().max()) <= lim


@pytest.mark.parametrize("S,N,chunk", [(32, 8, 16), (100, 16, 32),
                                       (128, 16, 64), (100, 8, 256)])
def test_ssm_scan_plain_matches_pallas_interpret_and_oracle(S, N, chunk, J):
    x, a, Bm, Cm = scan_inputs(S + N, 2, S, 3, 8, N)
    if chunk >= 32:     # exp(cum_i − cum_j) above the diagonal is inf
        assert np.cumsum(a[0, :min(chunk, S), -1]).min() < -89
    want_y, want_s = J.sk.ssm_scan(*(_j(t) for t in (x, a, Bm, Cm)),
                                   chunk=chunk, interpret=True)
    ref_y, ref_s = ref.ssm_ref(*(_t(t) for t in (x, a, Bm, Cm)))
    sk.reset_launches()
    y, s = ops.ssm_scan(*(_t(t) for t in (x, a, Bm, Cm)), chunk=chunk)
    assert sk.launches["ssm_scan"] == 0               # no kernel on the CPU
    assert y.shape == x.shape and y.dtype == torch.float32
    assert s.shape == (2, 3, N, 8) and s.dtype == torch.float32
    span = 2.0 ** -20 * decay_span(a, chunk)
    _near(y, want_y, 2e-5 + span)
    _near(s, want_s, 2e-5 + span)
    _near(y, ref_y, 5e-5 + span)
    _near(s, ref_s, 5e-5 + span)
    _near(ref_y, J.ref.ssm_ref(*(_j(t) for t in (x, a, Bm, Cm)))[0], 5e-5)


def test_segsum_masks_before_the_exponential():
    """Above the diagonal the difference of a strong decay's cumulative sum
    is +thousands: masked to −inf before exp, so the decay matrix is finite
    and a product with it is never inf · 0."""
    cum = torch.cumsum(torch.full((256,), -12.0), 0)
    seg = sk.segsum(cum)
    assert torch.isneginf(seg.triu(1)[seg.triu(1) != 0]).all()
    decay = torch.exp(seg)
    assert torch.isfinite(decay).all() and (decay.triu(1) == 0).all()
    assert float(decay[5, 5]) == 1.0
    assert torch.isfinite(torch.matmul(torch.ones(256, 256) * decay,
                                       torch.ones(256, 4))).all()


def test_ssm_scan_wrapper_checks_operands():
    x, a, Bm, Cm = (_t(t) for t in scan_inputs(0, 1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="fp32"):
        ops.ssm_scan(x.double(), a, Bm, Cm)
    with pytest.raises(ValueError, match="one dtype"):
        ops.ssm_scan(x, a, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="a must be"):
        ops.ssm_scan(x, a[:, :4], Bm, Cm)
    with pytest.raises(ValueError, match="Bm/Cm"):
        ops.ssm_scan(x, a, Bm, Cm[..., :2])
    with pytest.raises(ValueError, match="chunk"):
        ops.ssm_scan(x, a, Bm, Cm, chunk=0)


def test_ssd_chunked_from_a_state_and_decode_step(J):
    """``ssd_chunked`` (the XLA-path counterpart) from a nonzero state at a
    ragged S, and one ``ssd_decode_step``, against the reference's."""
    x, a, Bm, Cm = scan_inputs(7, 2, 70, 3, 8, 16)
    s0 = np.random.default_rng(8).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    want_y, want_s = J.ssm.ssd_chunked(*(_j(t) for t in (x, a, Bm, Cm)),
                                       chunk=32, init_state=_j(s0))
    y, s = ssm.ssd_chunked(*(_t(t) for t in (x, a, Bm, Cm)), 32,
                           init_state=_t(s0))
    span = 2.0 ** -20 * decay_span(a, 32)
    _near(y, want_y, 2e-5 + span)
    _near(s, want_s, 2e-5 + span)
    want_y, want_s = J.ssm.ssd_decode_step(_j(s0), _j(x[:, 0]), _j(a[:, 0]),
                                           _j(Bm[:, 0]), _j(Cm[:, 0]))
    y, s = ssm.ssd_decode_step(_t(s0), _t(x[:, 0]), _t(a[:, 0]),
                               _t(Bm[:, 0]), _t(Cm[:, 0]))
    _near(y, want_y, 2e-6)
    _near(s, want_s, 2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_with_history(dtype, J):
    """The K products summed in the input dtype in order; the trailing
    K − 1 inputs as the new history."""
    rng = np.random.default_rng(9)
    xc, w, b, hist = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, 5, 12), (4, 12), (12,), (2, 3, 12)))
    for h in (None, hist):
        want, want_h = J.ssm._causal_conv(
            _j(xc, dtype), _j(w, dtype), _j(b, dtype),
            None if h is None else _j(h, dtype))
        got, got_h = causal_conv_plain(_t(xc, dtype), _t(w, dtype),
                                       _t(b, dtype),
                                       None if h is None else _t(h, dtype))
        assert got.dtype == got_h.dtype == _T[dtype]
        np.testing.assert_array_equal(_np(got_h), _np(want_h))
        # bf16: XLA may keep the K-term sum in fp32 before rounding once
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=1e-6 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _carried_mamba(J, dtype, chunk):
    """(reference cfg, reference params, port cfg, port params) of one
    mamba layer of zamba2's SMOKE config at ``chunk``."""
    jcfg = dataclasses.replace(J.get_smoke("zamba2_7b"), dtype=dtype,
                               ssm_chunk=chunk)
    cfg = dataclasses.replace(get_smoke("zamba2_7b"), dtype=dtype,
                              ssm_chunk=chunk)
    jd = J.jnp.bfloat16 if dtype == "bfloat16" else J.jnp.float32
    jp = J.ssm.init_mamba(J.jax.random.PRNGKey(4), jcfg, jd)
    p = {k: _tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jcfg, jp, cfg, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_leaves(dtype, J):
    """Leaf for leaf the reference's shapes and dtypes, stacked over a lead
    axis; A_log, D and dt_bias are fp32 in any model dtype and equal the
    reference's (numpy constants in both packages)."""
    jcfg, jp, cfg, _ = _carried_mamba(J, dtype, 256)
    units = J.jax.vmap(lambda k: J.ssm.init_mamba(k, jcfg, jp["w_z"].dtype))(
        J.jax.random.split(J.jax.random.PRNGKey(0), 3))
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, _T[dtype],
                       "cpu", (3,))
    assert set(p) == set(units)
    for k, v in units.items():
        got = _tensor_from_numpy(np.asarray(v))
        assert tuple(p[k].shape) == tuple(got.shape), k
        assert p[k].dtype == got.dtype, k
    for k in ("A_log", "D", "dt_bias"):
        assert p[k].dtype == torch.float32
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(units[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_forward_matches_reference(use_pallas, dtype, J):
    """At chunk 4 and S = 10: three chunks, the last one padded."""
    jcfg, jp, cfg, p = _carried_mamba(J, dtype, 4)
    x = np.random.default_rng(10).standard_normal((2, 10, cfg.d_model))
    want = J.jax.jit(lambda p_, x_: J.ssm.mamba_forward(
        jcfg, p_, x_, use_pallas=use_pallas))(jp, _j(x, dtype))
    got = ssm.mamba_forward(cfg, p, _t(x, dtype), use_pallas=use_pallas)
    assert got.dtype == _T[dtype] and got.shape == (2, 10, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=5e-5 if dtype == "float32" else 7e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_writes_its_cache_in_place(dtype, J):
    """Six decode steps from an empty cache against the reference's, the
    cache written in place (views into a stacked cache), and the outputs
    against the full-sequence forward."""
    jcfg, jp, cfg, p = _carried_mamba(J, dtype, 4)
    x = np.random.default_rng(11).standard_normal((2, 6, cfg.d_model))
    stacked = ssm.init_mamba_cache(cfg, 2, _T[dtype], "cpu", (2,))
    cache = {k: v[1] for k, v in stacked.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    jcache = J.ssm.init_mamba_cache(jcfg, 2, _j(x, dtype).dtype)
    outs = []
    for t in range(6):
        want, jcache = J.ssm.mamba_decode(jcfg, jp, _j(x[:, t:t + 1], dtype),
                                          jcache)
        got, out = ssm.mamba_decode(cfg, p, _t(x[:, t:t + 1], dtype), cache)
        assert out is cache
        np.testing.assert_allclose(
            _np(got), _np(want), atol=5e-5 if dtype == "float32" else 7e-2)
        outs.append(got)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert all(float(v[0].abs().sum()) == 0 for v in stacked.values())
    for k in cache:
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   atol=5e-5 if dtype == "float32" else 7e-2)
    full = ssm.mamba_forward(cfg, p, _t(x, dtype))
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full),
                               atol=5e-5 if dtype == "float32" else 7e-2)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA ssm_scan kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,P,N,chunk,S,bc", [
    (112, 64, 64, 256, 1000, "bfloat16"),    # zamba2's head, ragged S
    (16, 32, 16, 256, 300, "float32"),       # zamba2's SMOKE head
    (8, 64, 32, 64, 200, "bfloat16"),
    (4, 128, 128, 128, 130, "float32")])
def test_ssm_scan_kernel_matches_plain_on_card(H, P, N, chunk, S, bc, cuda):
    """B and C as column slices of one (B, S, 2N) tensor, as the block
    passes them.  Tolerance: 1e-5 of the largest |y| and |state| (fp32
    sums in another order, FMAs allowed) plus the cumulative decay's
    rounding (:func:`decay_span`)."""
    x, a, Bm, Cm = scan_inputs(H + S, 2, S, H, P, N)
    bcm = _t(np.concatenate([Bm, Cm], -1), bc).to(cuda)
    xs, as_ = _t(x).to(cuda), _t(a).to(cuda)
    sk.reset_launches()
    y, s = ops.ssm_scan(xs, as_, bcm[..., :N], bcm[..., N:], chunk=chunk)
    assert sk.launches["ssm_scan"] == 1
    py, ps = sk.ssm_scan_plain(xs, as_, bcm[..., :N], bcm[..., N:],
                               chunk=chunk)
    torch.cuda.synchronize()
    span = 2.0 ** -20 * decay_span(a, chunk)
    _near(y.cpu(), py.cpu(), 1e-5 + span)
    _near(s.cpu(), ps.cpu(), 1e-5 + span)


# every (N, P) the kernel is built for, the chunks 64 / 128 / 256 and B / C
# in either dtype, at a ragged S and B 2
_CARD_CELLS = [(N, P, (64, 128, 256)[k % 3], ("bfloat16", "float32")[k % 2])
               for k, (N, P) in enumerate((N, P) for N in sk.STATE_DIMS
                                          for P in sk.HEAD_DIMS)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,chunk,bc", _CARD_CELLS)
def test_ssm_scan_kernel_each_state_and_head_dim_on_card(N, P, chunk, bc,
                                                         cuda):
    """The staged kernel at every N and P it takes, S = 333 (a ragged last
    chunk and a ragged last 64-row block), B 2; the same tolerance as
    above."""
    S, H = 333, 3
    x, a, Bm, Cm = scan_inputs(N + P + chunk, 2, S, H, P, N)
    bcm = _t(np.concatenate([Bm, Cm], -1), bc).to(cuda)
    xs, as_ = _t(x).to(cuda), _t(a).to(cuda)
    sk.reset_launches()
    y, s = sk.ssm_scan(xs, as_, bcm[..., :N], bcm[..., N:], chunk=chunk)
    assert sk.launches["ssm_scan"] == 1
    py, ps = sk.ssm_scan_plain(xs, as_, bcm[..., :N], bcm[..., N:],
                               chunk=chunk)
    torch.cuda.synchronize()
    span = 2.0 ** -20 * decay_span(a, chunk)
    _near(y.cpu(), py.cpu(), 1e-5 + span)
    _near(s.cpu(), ps.cpu(), 1e-5 + span)


@pytest.mark.cuda
def test_ssm_scan_kernel_reads_strided_unaligned_x_on_card(cuda):
    """x as a view whose rows are not 16-byte aligned: the wrapper copies
    it for the kernel's vector loads; the result is the plain version's."""
    x, a, Bm, Cm = scan_inputs(7, 2, 200, 4, 32, 16)
    wide = torch.zeros(2, 200, 4, 33, device=cuda)
    wide[..., 1:] = _t(x).to(cuda)
    xs = wide[..., 1:]
    args = (_t(a).to(cuda), _t(Bm).to(cuda), _t(Cm).to(cuda))
    y, s = sk.ssm_scan(xs, *args, chunk=64)
    py, ps = sk.ssm_scan_plain(xs, *args, chunk=64)
    torch.cuda.synchronize()
    span = 2.0 ** -20 * decay_span(a, 64)
    _near(y.cpu(), py.cpu(), 1e-5 + span)
    _near(s.cpu(), ps.cpu(), 1e-5 + span)


@pytest.mark.cuda
def test_ssm_scan_kernel_refuses_other_shapes(cuda):
    x, a, Bm, Cm = (_t(t).to(cuda) for t in scan_inputs(0, 1, 8, 2, 24, 16))
    with pytest.raises(ValueError, match="head dim"):
        ops.ssm_scan(x, a, Bm, Cm)
    x, a, Bm, Cm = (_t(t).to(cuda) for t in scan_inputs(0, 1, 300, 2, 32,
                                                         16))
    with pytest.raises(ValueError, match="chunks up to"):
        ops.ssm_scan(x, a, Bm, Cm, chunk=512)


# the cells' Mamba2 layers: zamba2_7b.prefill (B 8, S 4 096, 112 heads,
# P = N = 64, 2 groups) and granite_4_0_h_small.prefill_16k (B 1, S 16 384,
# 128 heads, P 64, N 128)
_CELL_LAYERS = {"zamba2_7b": (8, 4096, 112, 64, 64, 2),
                "granite_4_0_h_small": (1, 16384, 128, 64, 128, 1)}


def _card_inputs(dev, Bt, S, H, P, N, G, bc, seed):
    """The scan's operands drawn on the card at the model's decay (A =
    −(1…H), dt in [1e-3, 0.1]), B and C as column slices of one
    (B, S, 2GN) tensor in ``bc`` (grouped views when G > 1), as the mamba
    block passes them; with the decay (a) for :func:`decay_span`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.rand(Bt, S, H, generator=gen, device=dev) * 0.099 + 1e-3
    x = torch.randn(Bt, S, H, P, generator=gen, device=dev) * dt[..., None]
    a = dt * -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
    bcm = torch.randn(Bt, S, 2 * G * N, generator=gen, device=dev).to(_T[bc])
    Bm, Cm = bcm[..., :G * N], bcm[..., G * N:]
    if G > 1:
        Bm, Cm = Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
    return x, a, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("layer", sorted(_CELL_LAYERS))
def test_ssm_scan_kernel_at_the_cells_layers_on_card(layer, cuda):
    """The kernel at each prefill cell's layer shape, bf16 B / C, against
    its plain version within the tolerance above; one launch, counted
    under ``bf16_bc`` (B and C exact in TF32, not split)."""
    x, a, Bm, Cm = _card_inputs(cuda, *_CELL_LAYERS[layer], "bfloat16", 41)
    sk.reset_launches()
    y, s = sk.ssm_scan(x, a, Bm, Cm, chunk=256)
    assert sk.launches == {"ssm_scan": 1}
    assert sk.launches_by_bc == {"bf16_bc": 1, "fp32_bc": 0}
    py, ps = sk.ssm_scan_plain(x, a, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    span = 2.0 ** -20 * decay_span(a.cpu().numpy(), 256)
    _near(y.cpu(), py.cpu(), 1e-5 + span)
    _near(s.cpu(), ps.cpu(), 1e-5 + span)


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["bfloat16", "float32"])
def test_ssm_scan_kernel_is_deterministic_on_card(bc, cuda):
    """No atomics and no split-k across blocks: two calls on the same
    input are bitwise equal (2 groups, N 128, a ragged S)."""
    ops = _card_inputs(cuda, 2, 1000, 16, 64, 128, 2, bc, 42)
    y1, s1 = sk.ssm_scan(*ops, chunk=256)
    y2, s2 = sk.ssm_scan(*ops, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_ssm_scan_counts_calls_by_bc_dtype_on_card(cuda):
    """``launch.ssm_scan.{bf16_bc,fp32_bc}`` count each call by its B / C
    dtype beside ``launch.ssm_scan``; the plain version counts nothing and
    ``reset_launches`` zeroes both groups."""
    sk.reset_launches()
    for bc in ("bfloat16", "float32", "float32"):
        sk.ssm_scan(*_card_inputs(cuda, 1, 100, 4, 32, 16, 1, bc, 43))
    sk.ssm_scan_plain(*_card_inputs(cuda, 1, 100, 4, 32, 16, 1, "float32",
                                    43))
    assert sk.launches == {"ssm_scan": 3}
    assert sk.launches_by_bc == {"bf16_bc": 1, "fp32_bc": 2}
    sk.reset_launches()
    assert sk.launches_by_bc == {"bf16_bc": 0, "fp32_bc": 0}
