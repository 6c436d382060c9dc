"""The flash-attention kernels' dispatch and the bf16 path of the port
(``csrc/flash_attention_sm90.cu`` and, for fp32, the 3×TF32
``csrc/flash_attention.cu``, through ``repro_torch.kernels.flash_attention``).

On the CPU: the dispatch by dtype (against stub libraries, so nothing
launches), the TMA precondition on the model's layouts in both dtypes,
``attention_cost`` against a brute-force count of the mask, the bf16 bound
of ``sm90_error_share`` on hand-made tensors, and the plain version at the
bf16 kernel's tiles against the reference's Pallas kernel in interpret mode.

Tests marked ``cuda`` hold the kernels against their plain versions on a
card (they skip without one).  bf16 bound: |kernel − plain| ≤ 2⁻⁸ · max|v|
over the (b, kv head)'s keys + one bf16 ulp of the larger output + 2e-5 —
P is rounded to bf16 before P·V (each p moves by at most 2⁻⁸·p), the output
is rounded once in each, and fp32 sums run in another order.  fp32: 2e-5
absolute (3×TF32 products err by ~2⁻²¹ relative).
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def _randn(seed, shape, dtype=torch.bfloat16):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# ---------------------------------------------------------------------------
# the cost the bound is computed from
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (70, 70, True, 0), (70, 70, True, 48), (70, 70, False, 0),
    (70, 70, False, 48), (40, 97, True, 0), (97, 40, True, 48),
    (97, 40, False, 0)])
def test_attention_cost_counts_the_mask(Sq, Sk, causal, window):
    B, H, KV, D = 2, 6, 2, 16
    i = torch.arange(Sq)[:, None]
    j = torch.arange(Sk)[None, :]
    live = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        live &= j <= i
    if window > 0:
        live &= j > i - window
    nbytes, flops = fa.attention_cost(B, H, KV, Sq, Sk, D, causal, window)
    assert flops == 4 * D * B * H * int(live.sum())
    assert nbytes == 2 * (2 * B * H * Sq * D + 2 * B * KV * Sk * D)
    assert fa.attention_cost(B, H, KV, Sq, Sk, D, causal, window,
                             itemsize=4)[0] == 2 * nbytes


# ---------------------------------------------------------------------------
# the TMA precondition
# ---------------------------------------------------------------------------
def _model_layout(B, S, H, KV, D, dtype=torch.bfloat16):
    """The operands ``flash_attention`` hands the kernel for (B, S, H, D)
    q and (B, S, KV, D) k/v, as views (no copy)."""
    q = torch.zeros(B, S, H, D, dtype=dtype)
    k = torch.zeros(B, S, KV, D, dtype=dtype)
    out = torch.empty_like(q)
    G = H // KV
    view = lambda t: t.reshape(B, S, KV, G, D).permute(0, 2, 3, 1, 4)
    return view(q), k.permute(0, 2, 1, 3), view(out)


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 64, 12, 2, 128),     # qwen2_1_5b
    (2, 40, 32, 32, 112),    # zamba2_7b
    (1, 48, 16, 16, 80),     # hubert_xlarge
    (1, 33, 4, 4, 16), (2, 7, 8, 2, 32), (1, 201, 6, 1, 64)])
def test_tma_precondition_accepts_the_model_layouts(B, S, H, KV, D):
    for dtype in (torch.bfloat16, torch.float32):
        for t in _model_layout(B, S, H, KV, D, dtype):
            assert fa.tma_error(t) is None
    G = H // KV
    bkgsd = torch.zeros(B, KV, G, S, D, dtype=torch.bfloat16)
    assert fa.tma_error(bkgsd) is None
    assert fa.tma_error(torch.zeros(B, KV, S, D, dtype=torch.bfloat16)) is None


def test_tma_precondition_refuses_what_the_tma_cannot_read():
    base = torch.zeros(2 * 3 * 40 * 128 + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + 2 * 3 * 40 * 128].view(2, 3, 40, 128)
    assert "16-byte" in fa.tma_error(shifted)
    wide = torch.zeros(2, 3, 40, 132, dtype=torch.bfloat16)[..., :128]
    assert "stride 132" in fa.tma_error(wide)            # 264 bytes
    assert "contiguous" in fa.tma_error(
        torch.zeros(2, 3, 128, 40, dtype=torch.bfloat16).transpose(-1, -2))
    expanded = torch.zeros(1, 1, 40, 128, dtype=torch.bfloat16).expand(
        2, 3, 40, 128)
    assert "nonzero" in fa.tma_error(expanded)
    # a dim of size 1 is free: its stride is never used, and the packed one
    # goes to the tensor map
    one = torch.zeros(2, 3, 40, 132, dtype=torch.bfloat16)[:, :1, :1, :128]
    assert fa.tma_error(one) is None
    assert fa._tma_strides(one) == (40 * 3 * 132, 128, 128)


# ---------------------------------------------------------------------------
# dispatch by dtype, against stub libraries
# ---------------------------------------------------------------------------
class _StubLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def stubs(monkeypatch):
    libs = types.SimpleNamespace(sm90=_StubLib(), tf32x3=_StubLib())
    monkeypatch.setattr(fa, "_sm90_library", lambda: libs.sm90)
    monkeypatch.setattr(fa, "_library", lambda: libs.tf32x3)
    return libs


def test_dispatch_by_dtype(stubs):
    assert fa.kernel_path(torch.bfloat16) == "sm90"
    assert fa.kernel_path(torch.float32) == "tf32x3"
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.kernel_path(torch.float16)
    B, S, H, KV, D = 2, 40, 12, 2, 128
    for dtype in (torch.bfloat16, torch.float32):
        q, k, out = _model_layout(B, S, H, KV, D, dtype)
        fa._launch(q, k, k, out, True, 48, 7)
    # both kernels take the same arguments: q and out (b, kv, g, s), k and
    # v (b, kv, s) as element strides of the model's (B, S, H, D) layout,
    # read in place
    for stub, fwd in ((stubs.sm90, "flash_attention_sm90_fwd"),
                      (stubs.tf32x3, "flash_attention_fwd")):
        (name, args), = stub.calls
        assert name == fwd
        assert args[5:] == (B, KV, H // KV, S, S, D, args[11], 1, 48, 7)
        assert args[11] == pytest.approx(D ** -0.5)
        assert list(args[4]) == [S * H * D, 6 * D, D, H * D,
                                 S * KV * D, D, KV * D,
                                 S * KV * D, D, KV * D,
                                 S * H * D, 6 * D, D, H * D]
    # tiles: 128 positions of one head against 128 keys (bf16) or 32 keys
    # (fp32)
    assert fa.kernel_tiles(1000, 777, torch.bfloat16) == (128, 128)
    assert fa.kernel_tiles(40, 777, torch.bfloat16) == (40, 128)
    assert fa.kernel_tiles(40, 70, torch.bfloat16) == (40, 70)
    assert fa.kernel_tiles(1000, 777) == (128, 32)
    assert fa.kernel_tiles(40, 20) == (40, 20)


def test_sm90_launch_refuses_misaligned_operands(stubs):
    q, k, out = _model_layout(1, 40, 4, 2, 16)
    wide = torch.zeros(1, 40, 2, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="k: stride 20 .*sm90 kernel's TMA"):
        fa._launch(q, wide.permute(0, 2, 1, 3), k, out, True, 0, 0)
    assert stubs.sm90.calls == []


def test_tf32x3_launch_refuses_misaligned_operands(stubs):
    """The fp32 kernel reads through tensor maps too: a stride of 18 floats
    (72 bytes) or a base 4 bytes off a 16-byte boundary is refused before
    anything launches; a stride of 20 floats (80 bytes) is taken."""
    q, k, out = _model_layout(1, 40, 4, 2, 16, torch.float32)
    wide = torch.zeros(1, 40, 2, 18)[..., :16].permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="k: stride 18 .*tf32x3 kernel's"):
        fa._launch(q, wide, k, out, True, 0, 0)
    flat = torch.zeros(4 * 40 * 16 + 4)
    shifted = flat[1:1 + 4 * 40 * 16].view(1, 40, 4, 16)
    with pytest.raises(ValueError, match="q: .*16-byte"):
        fa._launch(shifted.reshape(1, 40, 2, 2, 16).permute(0, 2, 3, 1, 4),
                   k, k, out, True, 0, 0)
    assert stubs.tf32x3.calls == []
    ok = torch.zeros(1, 40, 2, 20)[..., :16].permute(0, 2, 1, 3)
    fa._launch(q, ok, k, out, True, 0, 0)
    (name, args), = stubs.tf32x3.calls
    # k's (b, kv, s) strides; b has size 1 and takes the packed stride
    assert name == "flash_attention_fwd" and list(args[4])[4:7] == [
        2 * 20, 20, 2 * 20]


def test_cpu_calls_launch_nothing():
    q, k, v = (_randn(s, shape) for s, shape in (
        (1, (1, 50, 4, 32)), (2, (1, 50, 2, 32)), (3, (1, 50, 2, 32))))
    fa.reset_launches()
    fa.flash_attention(q, k, v, causal=True)
    fa.flash_attention(q.float(), k.float(), v.float(), causal=True)
    assert fa.launches == {"flash_attention": 0}
    assert fa.launches_by_path == {"sm90": 0, "tf32x3": 0}


# ---------------------------------------------------------------------------
# the bf16 bound
# ---------------------------------------------------------------------------
def test_sm90_error_share_formula():
    want = torch.tensor([0.0, 1.0, -3.0, 100.0], dtype=torch.bfloat16)
    want = want.reshape(1, 1, 1, 4, 1).repeat(2, 1, 1, 1, 1)
    v = torch.tensor([[2.0, -0.5], [4.0, 1.0]]).reshape(2, 1, 2, 1)
    # batch 0: max|v| = 2 -> 2^-8 * 2 = 1/128; batch 1: max|v| = 4 -> 1/64
    assert fa.sm90_error_share(want, want, v) == 0.0
    got = want.float().clone()
    diff = 2.0 ** -8                    # at 2^-8 a bf16 ulp is 2^-15
    got[0, 0, 0, 0, 0] += diff
    assert fa.sm90_error_share(got, want, v) == pytest.approx(
        diff / (1 / 128 + 2.0 ** -15 + 2e-5), rel=1e-5)
    got = want.float().clone()
    # at 100 a bf16 ulp is 0.5: the bound is 1/64 + 0.5 + 2e-5
    got[1, 0, 0, 3, 0] += 1 / 64 + 0.5 + 2e-5
    assert fa.sm90_error_share(got, want, v) == pytest.approx(
        1.0, rel=1e-3)
    assert fa.sm90_error_share(got, want, v, fp32_tol=0) > 1.0


# ---------------------------------------------------------------------------
# the plain version at the bf16 kernel's tiles against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_plain_at_sm90_tiles_matches_pallas_interpret(causal, window):
    """Two 128-row query tiles and two 128-key tiles (S = 201, ragged), so
    the kernel's tile skip and its masked edge tiles are both reached."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
    B, KV, G, S, D = 1, 2, 3, 201, 16
    q = _randn(50, (B, KV, G, S, D), torch.float32)
    k = _randn(51, (B, KV, S, D), torch.float32)
    v = _randn(52, (B, KV, S, D), torch.float32)
    bq, bk = fa.kernel_tiles(S, S, torch.bfloat16)
    want = jfa.flash_attention_bkgsd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
        window=window, blk_q=bq, blk_k=bk, interpret=True)
    got = fa.flash_attention_bkgsd_plain(q, k, v, causal=causal,
                                         window=window, blk_q=bq, blk_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the sm90 flash-attention kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk", [(40, 777), (201, 40), (201, 201),
                                   (777, 201)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
@pytest.mark.parametrize("G", [1, 4, 6])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 112, 128])
def test_sm90_matches_plain_on_card(D, G, causal, window, Sq, Sk, cuda):
    B, KV = 2, 2
    q = _randn(60, (B, Sq, KV * G, D)).to(cuda)
    k = _randn(61, (B, Sk, KV, D)).to(cuda)
    v = _randn(62, (B, Sk, KV, D)).to(cuda)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches_by_path == {"sm90": 1, "tf32x3": 0}
    view = lambda t, S: t.reshape(B, S, KV, G, D).permute(0, 2, 3, 1, 4)
    kb, vb = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    bq, bk = fa.kernel_tiles(Sq, Sk, torch.bfloat16)
    plain = fa.flash_attention_bkgsd_plain(view(q, Sq), kb, vb,
                                           causal=causal, window=window,
                                           blk_q=bq, blk_k=bk)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert fa.sm90_error_share(view(out, Sq), plain, vb) <= 1.0
    if Sq == Sk:      # no row without a live key: the oracle applies
        np.testing.assert_allclose(
            out.float().cpu().numpy(),
            ref.attention_ref(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                              window=window).float().numpy(), atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk", [(40, 777), (201, 20), (201, 201),
                                   (777, 201)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
@pytest.mark.parametrize("G", [1, 4, 6])
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
def test_tf32x3_matches_plain_on_card(D, G, causal, window, Sq, Sk, cuda):
    """The fp32 kernel at every head dim, G, mask and ragged Sq / Sk (Sk 20
    below its 32-key tile): within 2e-5 of its plain version at its tiles,
    and of the oracle where every row has a live key."""
    B, KV = 2, 2
    q = _randn(63, (B, Sq, KV * G, D), torch.float32).to(cuda)
    k = _randn(64, (B, Sk, KV, D), torch.float32).to(cuda)
    v = _randn(65, (B, Sk, KV, D), torch.float32).to(cuda)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches_by_path == {"sm90": 0, "tf32x3": 1}
    view = lambda t, S: t.reshape(B, S, KV, G, D).permute(0, 2, 3, 1, 4)
    kb, vb = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    bq, bk = fa.kernel_tiles(Sq, Sk, torch.float32)
    plain = fa.flash_attention_bkgsd_plain(view(q, Sq), kb, vb,
                                           causal=causal, window=window,
                                           blk_q=bq, blk_k=bk)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert float((view(out, Sq) - plain).abs().max()) <= 2e-5
    if Sq == Sk:
        np.testing.assert_allclose(
            out.cpu().numpy(),
            ref.attention_ref(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                              window=window).numpy(), atol=2e-5)


@pytest.mark.cuda
def test_sm90_bkgsd_entry_and_launch_counts(cuda):
    """The (B, KV, G, S, D) entry on contiguous operands, then one fp32 and
    one bf16 call: each path counts its own launches."""
    B, KV, G, Sq, Sk, D = 2, 2, 6, 300, 260, 128
    q = _randn(70, (B, KV, G, Sq, D)).to(cuda)
    k = _randn(71, (B, KV, Sk, D)).to(cuda)
    v = _randn(72, (B, KV, Sk, D)).to(cuda)
    fa.reset_launches()
    out = fa.flash_attention_bkgsd(q, k, v, causal=False)
    plain = fa.flash_attention_bkgsd_plain(
        q, k, v, causal=False, blk_q=128, blk_k=128)
    torch.cuda.synchronize()
    assert fa.sm90_error_share(out, plain, v) <= 1.0
    fa.flash_attention_bkgsd(q.float(), k.float(), v.float(), causal=False)
    fa.flash_attention_bkgsd(q, k, v, causal=True)
    assert fa.launches == {"flash_attention": 3}
    assert fa.launches_by_path == {"sm90": 2, "tf32x3": 1}


@pytest.mark.cuda
def test_sm90_refuses_what_the_tma_cannot_read(cuda):
    q = torch.zeros(1, 40, 4, 16, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 40, 2, 16, dtype=torch.bfloat16, device=cuda)
    wide = torch.zeros(1, 40, 2, 20, dtype=torch.bfloat16,
                       device=cuda)[..., :16]
    flat = torch.zeros(4 * 40 * 16 + 8, dtype=torch.bfloat16, device=cuda)
    fa.reset_launches()
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, wide, k)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(flat[1:1 + 4 * 40 * 16].view(1, 40, 4, 16), k, k)
    assert fa.launches == {"flash_attention": 0}
    # the same operands in fp32 go to the 3×TF32 kernel: a stride of 20
    # floats is 80 bytes, which its tensor maps take; an fp32 base 4 bytes
    # off a 16-byte boundary is refused there too
    fa.flash_attention(q.float(), wide.float(), k.float())
    assert fa.launches_by_path == {"sm90": 0, "tf32x3": 1}
    flat32 = torch.zeros(4 * 40 * 16 + 4, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(flat32[1:1 + 4 * 40 * 16].view(1, 40, 4, 16),
                           k.float(), k.float())
    assert fa.launches == {"flash_attention": 1}
