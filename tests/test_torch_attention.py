"""The port's attention layer and flash-attention kernel against the
reference (``repro``), on the same numpy-seeded inputs.

* The flash kernel's plain version (``repro_torch.kernels.flash_attention``)
  against the reference's Pallas kernel run in interpret mode and against
  ``ref.attention_ref``, at the reference's own tolerances
  (``tests/test_kernels.py``: 2e-5 in fp32, 3e-2 in bf16).
* ``naive_attention``, ``chunked_attention``, ``decode_attention`` and
  ``cache_insert`` (scalar and per-sequence positions, the sliding-window
  ring), ``rms_norm``, ``apply_rope`` and ``swiglu``.
* The stacked caches: a real allocation per unit, written in place.

* The fp32 kernel's 3×TF32 products emulated by bit masks through the plain
  version's tile loop, against the plain version and the Pallas kernel
  (and big·big alone, which misses the 2e-5).

Tests marked ``cuda`` hold the CUDA kernels against their plain versions on
a card; they skip without one.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer
from tf32_split import matmul_tf32 as _matmul_tf32
from tf32_split import matmul_tf32x3 as _matmul_tf32x3

# fp32: exp and the summation order differ between XLA and PyTorch;
# bf16: the output is rounded to bf16 after that (tests/test_kernels.py)
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def J():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.config import ModelConfig
    from repro.kernels import flash_attention, ref
    from repro.models import attention, layers
    return types.SimpleNamespace(jnp=jax.numpy, fa=flash_attention, ref=ref,
                                 attn=attention, layers=layers,
                                 ModelConfig=ModelConfig)


def _randn(seed, shape, dtype="float32"):
    """Standard normal numpy array (rounded to the dtype)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(_T[dtype]).float().numpy()


def _t(x, dtype="float32"):
    """A torch copy of a numpy array in ``dtype``."""
    return torch.tensor(np.array(x, np.float32)).to(_T[dtype])


def _j(x, dtype="float32"):
    """A private jax copy of a numpy array in ``dtype``."""
    import jax.numpy as jnp
    return jnp.asarray(np.array(x, np.float32, copy=True),
                       jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, B, S, H, KV, D, dtype):
    return (_randn(seed, (B, S, H, D), dtype),
            _randn(seed + 1, (B, S, KV, D), dtype),
            _randn(seed + 2, (B, S, KV, D), dtype))


# ---------------------------------------------------------------------------
# the flash kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_flash_plain_matches_pallas_interpret(causal, window, dtype, J):
    """Unaligned S = 100, GQA 8 heads over 2 KV heads, 32-row tiles in both
    (so the same tiles are skipped), and at the CUDA kernel's own tiles."""
    q, k, v = _qkv(0, 2, 100, 8, 2, 32, dtype)
    want = J.fa.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               causal=causal, window=window, blk_q=32,
                               blk_k=32, interpret=True)
    oracle = J.ref.attention_ref(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                causal=causal, window=window)
    got = fa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal=causal, window=window, blk_q=32,
                             blk_k=32)
    tiles = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                causal=causal, window=window)
    mine = ref.attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal=causal, window=window)
    assert got.dtype == tiles.dtype == _T[dtype]
    assert got.shape == (2, 100, 8, 32)
    for x in (got, tiles, mine):
        np.testing.assert_allclose(_np(x), _np(want), atol=ATOL[dtype])
        np.testing.assert_allclose(_np(x), _np(oracle), atol=ATOL[dtype])


def test_flash_plain_bkgsd_layout_and_tile_skip(J):
    """The (B, KV, G, Sq, D) entry, ragged Sq ≠ Sk tiles, and a window so
    narrow that whole tiles are skipped: plain version ≡ the reference's
    Pallas kernel in interpret mode at the same tiles."""
    B, KV, G, Sq, D = 1, 2, 3, 70, 16
    q = _randn(3, (B, KV, G, Sq, D))
    k = _randn(4, (B, KV, Sq, D))
    v = _randn(5, (B, KV, Sq, D))
    want = J.fa.flash_attention_bkgsd(_j(q), _j(k), _j(v), causal=True,
                                     window=9, blk_q=16, blk_k=8,
                                     interpret=True)
    got = fa.flash_attention_bkgsd(_t(q), _t(k), _t(v), causal=True,
                                   window=9, blk_q=16, blk_k=8)
    assert fa.launches["flash_attention"] == 0       # no kernel on the CPU
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


def test_flash_wrapper_checks_operands():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(torch.zeros(1, 8, 3, 16), k, k)
    # one head per block in both kernels: G does not enter the tiles
    assert fa.kernel_tiles(300, 300) == (128, 32)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.kernel_tiles(8, 8, torch.float16)


# ---------------------------------------------------------------------------
# the fp32 kernel's 3xTF32 arithmetic, emulated through the plain version
# ---------------------------------------------------------------------------
def _bkgsd(seed, B, KV, G, Sq, Sk, D):
    return (_randn(seed, (B, KV, G, Sq, D)), _randn(seed + 1, (B, KV, Sk, D)),
            _randn(seed + 2, (B, KV, Sk, D)))


# chip_smoke.FLASH_CELLS cut to CPU size: (B, KV, G, Sq, Sk, D, causal,
# window); the last two with Sk below the kernel's 32-key tile, so rows
# without a live key average the Sk keys or, in a skipped query tile, are 0
TF32X3_CELLS = [
    (1, 1, 6, 150, 150, 128, True, 0),
    (1, 1, 6, 150, 150, 128, True, 48),
    (1, 1, 6, 60, 100, 128, False, 0),
    (1, 2, 1, 150, 150, 112, True, 0),
    (1, 2, 1, 150, 20, 16, False, 24),
    (1, 1, 6, 70, 20, 16, True, 0),
]


@pytest.mark.parametrize("B,KV,G,Sq,Sk,D,causal,window", TF32X3_CELLS)
def test_flash_tf32x3_emulation_matches_plain_and_pallas_interpret(
        B, KV, G, Sq, Sk, D, causal, window, J):
    """The fp32 kernel's products (3xTF32) through the plain version's tile
    loop at the kernel's tiles: within 2e-5 of the plain version in fp32
    and of the reference's Pallas kernel in interpret mode."""
    q, k, v = _bkgsd(80, B, KV, G, Sq, Sk, D)
    bq, bk = fa.kernel_tiles(Sq, Sk, torch.float32)
    assert (bq, bk) == (min(128, Sq), min(32, Sk))
    kw = dict(causal=causal, window=window, blk_q=bq, blk_k=bk)
    emu = fa.flash_attention_bkgsd_plain(_t(q), _t(k), _t(v),
                                         matmul=_matmul_tf32x3, **kw)
    plain = fa.flash_attention_bkgsd_plain(_t(q), _t(k), _t(v), **kw)
    want = J.fa.flash_attention_bkgsd(_j(q), _j(k), _j(v), interpret=True,
                                     **kw)
    assert bool(torch.isfinite(emu).all())
    np.testing.assert_allclose(_np(emu), _np(plain), atol=2e-5)
    np.testing.assert_allclose(_np(emu), _np(want), atol=2e-5)
    if Sk < 32 and window:   # both kinds of row without a live key
        empty = Sk - 1 + window
        assert float(_np(plain)[..., empty:128, :].std()) > 0
        assert float(np.abs(_np(plain)[..., 128:, :]).max()) == 0.0


def test_flash_tf32_big_products_alone_miss_the_tolerance():
    """The other two products are needed: with big·big alone (one TF32
    pass, ~2^-11 relative per product) the output misses 2e-5 at D 128,
    where the three products hold it."""
    q, k, v = _bkgsd(90, 1, 1, 6, 150, 150, 128)
    kw = dict(causal=True, blk_q=128, blk_k=32)
    plain = fa.flash_attention_bkgsd_plain(_t(q), _t(k), _t(v), **kw)
    one = fa.flash_attention_bkgsd_plain(_t(q), _t(k), _t(v),
                                         matmul=_matmul_tf32, **kw)
    three = fa.flash_attention_bkgsd_plain(_t(q), _t(k), _t(v),
                                           matmul=_matmul_tf32x3, **kw)
    assert float((one - plain).abs().max()) > 2e-5
    assert float((three - plain).abs().max()) <= 2e-5


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_naive_and_chunked_attention(causal, window, J):
    q, k, v = _qkv(10, 2, 23, 4, 2, 16, "float32")
    jq, jk, jv = _j(q), _j(k), _j(v)
    want_naive = J.attn.naive_attention(jq, jk, jv, causal=causal,
                                       window=window)
    want_chunk = J.attn.chunked_attention(jq, jk, jv, causal=causal,
                                         window=window, q_chunk=8,
                                         kv_chunk=6)
    got_naive = attn.naive_attention(_t(q), _t(k), _t(v), causal=causal,
                                     window=window)
    got_chunk = attn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, q_chunk=8, kv_chunk=6)
    got_unroll = attn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                        window=window, q_chunk=8,
                                        kv_chunk=6, unroll=True)
    np.testing.assert_allclose(_np(got_naive), _np(want_naive), atol=2e-6)
    # bf16 probabilities and values in the PV product, in both packages
    np.testing.assert_allclose(_np(got_chunk), _np(want_chunk), atol=2e-5)
    np.testing.assert_allclose(_np(got_unroll), _np(got_chunk), atol=1e-6)


@pytest.mark.parametrize("per_seq", [False, True], ids=["scalar", "per_seq"])
def test_decode_attention_and_cache_insert(per_seq, J):
    """cache_insert writes in place (and returns the same dict); with a
    window of 5 the cache is a ring of 5 and position 7 lands in slot 2."""
    kw = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=48, vocab_size=64, sliding_window=5)
    cfg, pcfg = J.ModelConfig(**kw), ModelConfig(**kw)
    B, C, KV, D = 3, 5, 2, 8
    ck, cv = _randn(20, (B, C, KV, D)), _randn(21, (B, C, KV, D))
    kn, vn = _randn(22, (B, 1, KV, D)), _randn(23, (B, 1, KV, D))
    q = _randn(24, (B, 1, 4, D))
    pos = np.array([7, 3, 11], np.int32) if per_seq else np.int32(7)
    jc = J.attn.cache_insert({"k": _j(ck), "v": _j(cv)}, _j(kn), _j(vn),
                            J.jnp.asarray(pos))
    cache = {"k": _t(ck), "v": _t(cv)}
    k_storage = cache["k"].data_ptr()
    got = attn.cache_insert(cache, _t(kn), _t(vn), torch.tensor(pos))
    assert got is cache and got["k"].data_ptr() == k_storage
    np.testing.assert_array_equal(_np(got["k"]), _np(jc["k"]))
    np.testing.assert_array_equal(_np(got["v"]), _np(jc["v"]))
    slots = np.broadcast_to(pos, (B,)) % C
    for b in range(B):
        np.testing.assert_array_equal(_np(got["k"])[b, slots[b]], kn[b, 0])
    lens = np.minimum(pos + 1, C)
    want = J.attn.decode_attention(_j(q), jc["k"], jc["v"],
                                   J.jnp.asarray(lens),
                                   window=cfg.sliding_window)
    out = attn.decode_attention(_t(q), got["k"], got["v"],
                                torch.tensor(lens), window=5)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-6)
    # the sliding-window cache holds the window, not the sequence
    kv = transformer.init_caches(pcfg, 2, 64, device="cpu")
    assert kv["block_0"]["k"].shape == (2, 2, 5, 2, 8)


def test_attention_decode_positions_by_dim():
    """A 0-dim position broadcasts one RoPE angle over the batch, a (B,)
    position gives each sequence its own: equal positions, equal result."""
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=48, vocab_size=64)
    from repro_torch.config import RunConfig
    p = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu")
    x = torch.randn(3, 1, 32, generator=torch.Generator().manual_seed(1))
    a = attn.init_kv_cache(cfg, 3, 8, torch.float32, "cpu")
    b = attn.init_kv_cache(cfg, 3, 8, torch.float32, "cpu")
    oa, _ = attn.attention_decode(cfg, RunConfig(), p, x,
                                  torch.tensor(4, dtype=torch.int32), a)
    ob, _ = attn.attention_decode(cfg, RunConfig(), p, x,
                                  torch.full((3,), 4, dtype=torch.int32), b)
    torch.testing.assert_close(oa, ob, rtol=0, atol=0)
    torch.testing.assert_close(a["k"], b["k"], rtol=0, atol=0)
    assert a["k"][:, 4].abs().sum() > 0 and a["k"][:, 5:].abs().sum() == 0


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_swiglu(dtype, J):
    x = _randn(30, (2, 6, 4, 16), dtype)
    scale = _randn(31, (16,), dtype)
    tol = {"float32": 2e-6, "bfloat16": 1e-2}[dtype]
    np.testing.assert_allclose(
        _np(layers.rms_norm(_t(x, dtype), _t(scale, dtype))),
        _np(J.layers.rms_norm(_j(x, dtype), _j(scale, dtype))), atol=tol)
    np.testing.assert_array_equal(layers.rope_frequencies(16, 1e6),
                                  J.layers.rope_frequencies(16, 1e6))
    pos = np.arange(6)
    np.testing.assert_allclose(
        _np(layers.apply_rope(_t(x, dtype), torch.tensor(pos), 1e6)),
        _np(J.layers.apply_rope(_j(x, dtype), J.jnp.asarray(pos), 1e6)),
        atol=tol)
    h = _randn(32, (2, 6, 16), dtype)
    p = {"w_gate": _randn(33, (16, 24), dtype),
         "w_up": _randn(34, (16, 24), dtype),
         "w_down": _randn(35, (24, 16), dtype)}
    got = layers.swiglu(_t(h, dtype), {k: _t(w, dtype) for k, w in p.items()})
    want = J.layers.swiglu(_j(h, dtype), {k: _j(w, dtype)
                                         for k, w in p.items()})
    assert got.dtype == _T[dtype]
    # sums of 16 and 24 products of unit-scale values: a few bf16 ulps
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-4 if dtype == "float32" else 0.25)


# ---------------------------------------------------------------------------
# caches: one allocation per unit
# ---------------------------------------------------------------------------
def test_unit_caches_do_not_alias():
    """The reference broadcasts one unit's zero cache over n_units; in torch
    that would be one storage for every unit.  The port allocates them, so
    a decode step writes each unit's K/V into its own slice."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model, model_decode_step
    cfg = dataclasses.replace(get_smoke("qwen2_1_5b"), dtype="float32")
    params = init_model(cfg, 0, device="cpu")
    caches = transformer.init_caches(cfg, 2, 8, device="cpu")
    k = caches["block_0"]["k"]
    assert k.shape[0] == cfg.n_units == 2 and 0 not in k.stride()
    assert k.is_contiguous()
    ptr = k.data_ptr()
    _, out = model_decode_step(cfg, RunConfig(), params,
                               torch.tensor([[3], [4]], dtype=torch.int32),
                               0, caches)
    assert out is caches and out["block_0"]["k"].data_ptr() == ptr
    k0, k1 = k[0, :, 0], k[1, :, 0]
    assert k0.abs().sum() > 0 and k1.abs().sum() > 0
    assert not torch.equal(k0, k1)          # each unit its own K
    assert k[:, :, 1:].abs().sum() == 0     # nothing past position 0


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA flash-attention kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
@pytest.mark.parametrize("H,KV,D", [(12, 2, 128), (8, 2, 32), (4, 4, 16),
                                    (32, 32, 112)])
def test_flash_kernel_matches_plain_on_card(H, KV, D, causal, window, dtype,
                                            cuda):
    """Tolerance: 2e-5 absolute in fp32 (the 3×TF32 kernel: each product
    split into three TF32 products on the tensor cores errs by ~2⁻²¹
    relative, below fp32's other differences — exp and the summation
    order; FMAs are allowed); in bf16 (the sm90 kernel, which rounds P to
    bf16 before P·V) 2⁻⁸ · max|v| + one ulp of the larger output + 2e-5
    (``flash_attention.sm90_error_share``)."""
    q, k, v = _qkv(40, 2, 201, H, KV, D, dtype)
    tq, tk, tv = (_t(x, dtype).to(cuda) for x in (q, k, v))
    fa.reset_launches()
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fa.launches["flash_attention"] == 1
    assert fa.launches_by_path[fa.kernel_path(_T[dtype])] == 1
    G = H // KV
    bq, bk = fa.kernel_tiles(201, 201, _T[dtype])
    view = lambda t: t.reshape(2, 201, KV, G, D).permute(0, 2, 3, 1, 4)
    vb = tv.permute(0, 2, 1, 3)
    plain = fa.flash_attention_bkgsd_plain(
        view(tq), tk.permute(0, 2, 1, 3), vb, causal=causal, window=window,
        blk_q=bq, blk_k=bk)
    torch.cuda.synchronize()
    assert out.dtype == _T[dtype] and bool(torch.isfinite(out).all())
    if dtype == "float32":
        assert float((view(out) - plain).abs().max()) <= 2e-5
    else:
        assert fa.sm90_error_share(view(out), plain, vb) <= 1.0
    np.testing.assert_allclose(_np(out.cpu()), _np(ref.attention_ref(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal,
        window=window)), atol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("G,causal,window", [(2, False, 16), (1, True, 8)])
def test_flash_fp32_rows_without_live_key_at_short_sk_on_card(
        G, causal, window, cuda):
    """Sk = 20 < 32 keys (the fp32 kernel's key tile), Sq = 300 queries in
    a window: the rows past Sk − 1 + window see no live key.  In a
    processed query tile such a row averages the Sk keys of the plain
    version's one Sk-wide key tile, so the kernel's 32-wide tile must give
    its padded keys no weight; a query tile the plain version skips gives
    zeros in both."""
    B, KV, Sq, Sk, D = 1, 2, 300, 20, 32
    rng = np.random.default_rng(41)
    q, k, v = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=cuda)
               for shape in ((B, KV, G, Sq, D), (B, KV, Sk, D),
                             (B, KV, Sk, D)))
    out = fa.flash_attention_bkgsd(q, k, v, causal=causal, window=window)
    bq, bk = fa.kernel_tiles(Sq, Sk, torch.float32)
    plain = fa.flash_attention_bkgsd_plain(q, k, v, causal=causal,
                                           window=window, blk_q=bq, blk_k=bk)
    torch.cuda.synchronize()
    empty = [i for i in range(Sq) if i >= Sk - 1 + window]
    mean = v.mean(dim=2)[:, :, None]                  # (B, KV, 1, D)
    averaged = [i for i in empty if float(
        (plain[:, :, :, i] - mean).abs().max()) <= 2e-5]
    assert averaged and len(averaged) < len(empty)    # both kinds of row
    assert float((out - plain).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_flash_kernel_refuses_other_tiles(cuda):
    q = torch.zeros(1, 64, 4, 16, device=cuda)
    k = torch.zeros(1, 64, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="tiles"):
        fa.flash_attention(q, k, k, blk_q=8)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(torch.zeros(1, 8, 4, 24, device=cuda),
                           torch.zeros(1, 8, 2, 24, device=cuda),
                           torch.zeros(1, 8, 2, 24, device=cuda))
