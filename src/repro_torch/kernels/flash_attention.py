"""Blockwise (flash) attention: one kernel launch per attention layer of a
prefill (CUDA, Hopper).

Counterpart of ``repro/kernels/flash_attention.py``, whose Pallas TPU kernel
(``flash_attention_bkgsd``: ``_attn_kernel`` / ``_attn_block``) becomes two
hand-written CUDA C++ kernels, built by ``kernels/build.py`` and bound with
``ctypes``, chosen by the operands' dtype (:func:`kernel_path`).  Both run
both products on the tensor cores (``wgmma``) with K/V tiles fed by TMA
through a ring in shared memory, one head of 128 query positions per block:

* ``"sm90"`` — bf16 operands, ``csrc/flash_attention_sm90.cu``, against
  128-key tiles.  P is rounded to bf16 before P·V (the TPU kernel keeps it
  in fp32), so it is held to its plain version within
  :func:`sm90_error_share`'s bound.
* ``"tf32x3"`` — fp32 operands, ``csrc/flash_attention.cu``, against 32-key
  tiles.  Each product runs as 3×TF32: every operand split into a TF32 big
  part and a TF32 small remainder, a·b ≈ a_small·b_big + a_big·b_small +
  a_big·b_big, about fp32's accuracy; within 2e-5 of its plain version.

Their tensor maps impose the TMA's alignment rules (:func:`tma_error`): the
wrapper refuses operands that break them.  Both compute online-softmax
attention with causal and sliding-window masks: q is read as
(B, KV, G, Sq, D), k/v as (B, KV, Sk, D); head ``h`` of the model's
(B, S, H, D) layout is ``kv * G + g``; the softmax statistics and the
accumulator are fp32; the output has q's dtype.

The mask constant is the TPU kernel's finite ``NEG_INF = -1e30`` and the
normaliser is floored at 1e-30: a row whose first processed tile holds no
live key accumulates ``exp(0) = 1`` terms that the next tile's
``alpha = exp(-1e30 - m) = 0`` wipes out exactly (with ``-inf`` that step
would be ``exp(-inf + inf) = NaN``).  Fully masked tiles are skipped as on
the TPU: causal tiles strictly above the diagonal, tiles before the window.

``flash_attention_bkgsd`` checks device, dtype, shapes and the TMA's rules
(the axes other than the head dim may be strided, so the model's layout
launches without a copy), then launches the dtype's kernel on CUDA tensors
— or, for CPU tensors, runs :func:`flash_attention_bkgsd_plain`, the same
tile loop, online softmax, mask constant and tile skip in plain PyTorch, at
the tiles of the kernel the dtype would launch (:func:`kernel_tiles`),
which the kernels are held against on the card.  Nothing falls back: a
CUDA call launches or raises.  ``launches["flash_attention"]`` counts kernel
launches of both kernels, ``launches_by_path`` each kernel's (plain-version
calls do not count).

Tiling: ``BLK_Q = 128`` positions of one head per query tile in both; K
tiles of ``SM90_BLK_K = 128`` keys (bf16) or ``TF32X3_BLK_K = 32`` (fp32,
whose big and small copies of K and Vᵀ fill the shared memory).  A bf16
head dim over 128 (zamba2_7b_instruct's 224) launches the sm90 source's
wide kernel, whose 64 KB query tile leaves room for K/V tiles of
``SM90_WIDE_BLK_K = 64`` keys in rings of their own.  The softmax scale is
1/√D unless the caller gives another (Zamba2's shared attention takes
(D/2)^-½).
:func:`attention_cost` counts the work of the mask itself, which no tiling
changes: the bound the kernels are measured against.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build

NEG_INF = -1e30
BLK_Q = 128          # both kernels: query positions (of one head) per block
SM90_BLK_K = 128     # csrc/flash_attention_sm90.cu: keys per K/V tile
SM90_WIDE_BLK_K = 64  # the same source's wide kernel (D over 128)
TF32X3_BLK_K = 32    # csrc/flash_attention.cu: keys per K/V tile
# the head dims each kernel is built for: the sm90 kernel pads any D over 64
# to 128 with the TMA's zeros (D 80: hubert_xlarge; D 112: zamba2_7b), and
# its wide kernel D 224 to 256 (zamba2_7b_instruct)
HEAD_DIMS = {"sm90": (16, 32, 64, 80, 112, 128, 224),
             "tf32x3": (16, 32, 64, 112, 128)}
_PATHS = {torch.bfloat16: "sm90", torch.float32: "tf32x3"}
_BLK_K = {"sm90": SM90_BLK_K, "tf32x3": TF32X3_BLK_K}

# kernel launches since the last reset_launches(): both kernels, and each
launches = obs.counter_group("launch", ("flash_attention",))
launches_by_path = obs.counter_group("launch.flash_attention",
                                     ("sm90", "tf32x3"))


def reset_launches() -> None:
    launches["flash_attention"] = 0
    for path in launches_by_path:
        launches_by_path[path] = 0


def kernel_path(dtype: torch.dtype) -> str:
    """The CUDA kernel that operands of ``dtype`` launch: ``"sm90"`` (bf16:
    ``csrc/flash_attention_sm90.cu``) or ``"tf32x3"`` (fp32:
    ``csrc/flash_attention.cu``)."""
    if dtype not in _PATHS:
        raise ValueError(f"flash_attention takes fp32 or bf16, not {dtype}")
    return _PATHS[dtype]


def kernel_tiles(Sq: int, Sk: int, dtype: torch.dtype = torch.float32,
                 D: int = 0) -> Tuple[int, int]:
    """(blk_q, blk_k) of the CUDA kernel that ``dtype`` and head dim
    ``D`` launch, in the plain version's terms (``blk_q`` positions of all
    G heads per query tile; both kernels put one head's 128 positions in a
    block, so G does not enter)."""
    path = kernel_path(dtype)
    blk_k = SM90_WIDE_BLK_K if path == "sm90" and D > 128 else _BLK_K[path]
    return min(BLK_Q, Sq), min(blk_k, Sk)


def attention_cost(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                   causal: bool, window: int = 0,
                   itemsize: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one attention call: q, k and v read once and the
    output written once, in ``itemsize``-byte elements; 4·D flops (q·k and
    p·v, a multiply-add counted as two) for every live (query row, key)
    pair of the mask — row i sees key j < Sk when (not causal or j <= i)
    and (window <= 0 or j > i - window).  No tile size enters."""
    pairs = 0
    for i in range(Sq):
        hi = min(Sk - 1, i) if causal else Sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    nbytes = itemsize * (2 * B * H * Sq * D + 2 * B * KV * Sk * D)
    return nbytes, 4 * D * B * H * pairs


def tma_error(t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot read or write ``t`` (None when it can): their
    tensor maps need a contiguous last dim, a 16-byte aligned base and
    every other stride a nonzero multiple of 16 bytes (dims of size 1 are
    free: their stride is never used)."""
    if t.stride(-1) != 1:
        return "the head dim must be contiguous"
    if t.data_ptr() % 16:
        return f"base address {t.data_ptr():#x} is not 16-byte aligned"
    for d in range(t.dim() - 1):
        nbytes = t.stride(d) * t.element_size()
        if t.shape[d] > 1 and (nbytes == 0 or nbytes % 16):
            return (f"stride {t.stride(d)} of dim {d} is {nbytes} bytes, "
                    f"not a nonzero multiple of 16")
    return None


def _tma_strides(t: torch.Tensor) -> Tuple[int, ...]:
    """``t``'s element strides without the last (contiguous) dim, a dim of
    size 1 given the packed stride (its own may break the TMA's rules and
    is never used)."""
    out = [0] * (t.dim() - 1)
    packed = t.shape[-1]
    for d in range(t.dim() - 2, -1, -1):
        out[d] = t.stride(d) if t.shape[d] > 1 else packed
        packed = out[d] * t.shape[d]
    return tuple(out)


def sm90_error_share(got: torch.Tensor, want: torch.Tensor,
                     v: torch.Tensor, fp32_tol: float = 2e-5) -> float:
    """max |got − want| as a share of the sm90 kernel's bound against its
    plain version, over two (B, KV, G, Sq, D) outputs; v: (B, KV, Sk, D).

    The bound: 2⁻⁸ · max|v| over the (b, kv head)'s keys (P is rounded to
    bf16 before P·V: each p moves by at most 2⁻⁸·p, and the p of a row sum
    to l) + one bf16 ulp of the larger of |got|, |want| (each rounded once)
    + ``fp32_tol`` (fp32 sums in another order).  At most 1 when within."""
    a, b = got.float(), want.float()
    vmax = v.float().abs().amax(dim=(-2, -1))[:, :, None, None, None]
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return float(((a - b).abs() / (2.0 ** -8 * vmax + ulp + fp32_tol)).max())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The fp32 (3×TF32) kernel with its C signature declared; its tiles
    must be the ones this module assumes."""
    lib = build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f,
                                        i, i, p]
    lib.flash_attention_fwd.restype = i
    for name, want in (("flash_attention_block_q", BLK_Q),
                       ("flash_attention_block_k", TF32X3_BLK_K)):
        fn = getattr(lib, name)
        fn.restype = i
        if fn() != want:
            raise RuntimeError(f"{name}() = {fn()}, expected {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _sm90_library() -> ctypes.CDLL:
    """The bf16 kernel with its C signature declared."""
    lib = build.load("flash_attention_sm90")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_sm90_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                             f, i, i, p]
    lib.flash_attention_sm90_fwd.restype = i
    for name, want in (("flash_attention_sm90_block", SM90_BLK_K),
                       ("flash_attention_sm90_wide_block", SM90_WIDE_BLK_K)):
        fn = getattr(lib, name)
        fn.restype = i
        if fn() != want:
            raise RuntimeError(f"{name}() = {fn()}, expected {want}")
    return lib


def _shapes(q, k, v) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, Sq, D) and k/v (B, KV, Sk, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, KV, G, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(k.shape) != (B, KV, Sk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be {(B, KV, Sk, D)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _PATHS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of fp32 / bf16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if min(B, KV, G, Sq, Sk, D) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    return B, KV, G, Sq, Sk, D


def _launch(q, k, v, out, causal, window, stream,
            scale: Optional[float] = None) -> None:
    """Both kernels take the same arguments: 14 element strides of q, k, v
    and out, read through tensor maps after the TMA's rules are checked."""
    B, KV, G, Sq, Sk, D = _shapes(q, k, v)
    path = kernel_path(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        why = tma_error(t)
        if why is not None:
            raise ValueError(f"{name}: {why} (the {path} kernel's TMA rules)")
    strides = (_tma_strides(q) + _tma_strides(k) + _tma_strides(v)
               + _tma_strides(out))
    if path == "sm90":
        lib, source, fwd = (_sm90_library(), "flash_attention_sm90",
                            "flash_attention_sm90_fwd")
    else:
        lib, source, fwd = _library(), "flash_attention", "flash_attention_fwd"
    err = getattr(lib, fwd)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 14)(*strides), B, KV, G, Sq, Sk, D,
        float(1.0 / math.sqrt(D)) if scale is None else float(scale),
        int(causal), int(window), stream)
    build.raise_on(lib, source, err, "flash_attention")


def flash_attention_bkgsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int = 0,
                          blk_q: Optional[int] = None,
                          blk_k: Optional[int] = None,
                          out: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None
                          ) -> torch.Tensor:
    """q: (B, KV, G, Sq, D); k/v: (B, KV, Sk, D).  Returns a q-shaped
    output in q's dtype (written into ``out`` when given: a q-shaped view
    with a contiguous head dim).  ``blk_q`` / ``blk_k`` tile the plain
    version on the CPU; each CUDA kernel has its own (:func:`kernel_tiles`)
    and refuses others.  ``scale`` multiplies q·k (1/√D when None)."""
    B, KV, G, Sq, Sk, D = _shapes(q, k, v)
    dev = q.device
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    elif (tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype
          or out.device != dev):
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype} on {dev}")
    kq, kk = kernel_tiles(Sq, Sk, q.dtype, D)
    if dev.type == "cpu":
        out.copy_(flash_attention_bkgsd_plain(
            q, k, v, causal=causal, window=window, blk_q=blk_q or kq,
            blk_k=blk_k or kk, scale=scale))
        return out
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    if (blk_q or kq, blk_k or kk) != (kq, kk):
        raise ValueError(f"the CUDA kernel tiles {(kq, kk)}, not "
                         f"{(blk_q, blk_k)}")
    dims = HEAD_DIMS[kernel_path(q.dtype)]
    if D not in dims:
        raise ValueError(f"head dim {D}; the {kernel_path(q.dtype)} kernel "
                         f"takes {dims}")
    _launch(q, k, v, out, causal, window,
            torch.cuda.current_stream(dev).cuda_stream, scale)
    launches["flash_attention"] += 1
    launches_by_path[kernel_path(q.dtype)] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    blk_q: Optional[int] = None,
                    blk_k: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Layout adapter.  q: (B, Sq, H, D); k/v: (B, Sk, KV, D).  Returns
    (B, Sq, H, D) — ``models.attention``'s conventions.  The kernel reads
    and writes these layouts through strides: nothing is transposed or
    copied."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D) and k/v (B, Sk, KV, D), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    Bb, Sq, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    G = H // KV
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_bkgsd(
        q.reshape(Bb, Sq, KV, G, D).permute(0, 2, 3, 1, 4),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=causal,
        window=window, blk_q=blk_q, blk_k=blk_k,
        out=out.view(Bb, Sq, KV, G, D).permute(0, 2, 3, 1, 4), scale=scale)
    return out


def flash_attention_bkgsd_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                window: int = 0, blk_q: int = 128,
                                blk_k: int = 128,
                                matmul: Callable = torch.matmul,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same tile loop over K
    tiles in order, online softmax, mask constant, tile skip and fp32 math,
    vectorised over the query tiles (the kernel's parallel axis).  For each
    K tile only the query tiles for which it is live take part, so no tile
    the kernel skips is computed here either.  ``matmul`` takes both
    products (Q·Kᵀ and P·V) of a tile; a test may pass one that emulates a
    kernel's arithmetic."""
    B, KV, G, Sq, Sk, D = _shapes(q, k, v)
    blk_q, blk_k = min(blk_q, Sq), min(blk_k, Sk)
    nq, nk = -(-Sq // blk_q), -(-Sk // blk_k)
    pq, pk = nq * blk_q - Sq, nk * blk_k - Sk
    dev, f32 = q.device, torch.float32
    R = G * blk_q
    # (B·KV, nq, G·blk_q, D): the G heads of a q tile as one block of rows
    qf = torch.nn.functional.pad(q.to(f32), (0, 0, 0, pq))
    qf = qf.reshape(B * KV, G, nq, blk_q, D).transpose(1, 2).reshape(
        B * KV, nq, R, D)
    kf = torch.nn.functional.pad(k.to(f32), (0, 0, 0, pk)).reshape(
        B * KV, nk, blk_k, D)
    vf = torch.nn.functional.pad(v.to(f32), (0, 0, 0, pk)).reshape(
        B * KV, nk, blk_k, D)
    scale = float(1.0 / math.sqrt(D)) if scale is None else float(scale)
    q_pos = (torch.arange(nq, device=dev)[:, None] * blk_q
             + torch.arange(blk_q, device=dev)).repeat(1, G)   # (nq, R)
    m = torch.full((B * KV, nq, R), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B * KV, nq, R), dtype=f32, device=dev)
    acc = torch.zeros((B * KV, nq, R, D), dtype=f32, device=dev)
    for j in range(nk):
        k0 = j * blk_k
        lo, hi = 0, nq            # the query tiles for which tile j is live
        if causal:                # k0 <= q_hi = i * blk_q + blk_q - 1
            lo = max(lo, -(-(k0 - blk_q + 1) // blk_q))
        if window > 0:            # k0 + blk_k - 1 > q_lo - window
            hi = min(hi, -(-(k0 + blk_k - 1 + window) // blk_q))
        if lo >= hi:
            continue
        s = matmul(qf[:, lo:hi], kf[:, j].unsqueeze(1).transpose(
            -1, -2)) * scale                         # (BKV, n, R, bk)
        kp = k0 + torch.arange(blk_k, device=dev)
        qp = q_pos[lo:hi, :, None]
        mask = (kp < Sk).expand(hi - lo, R, blk_k)
        if causal:
            mask = mask & (kp <= qp)
        if window > 0:
            mask = mask & (kp > qp - window)
        s = torch.where(mask, s, NEG_INF)
        m_prev = m[:, lo:hi]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l[:, lo:hi] = l[:, lo:hi] * alpha + p.sum(dim=-1)
        acc[:, lo:hi] = (acc[:, lo:hi] * alpha[..., None]
                         + matmul(p, vf[:, j].unsqueeze(1)))
        m[:, lo:hi] = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    o = o.reshape(B, KV, nq, G, blk_q, D).transpose(2, 3).reshape(
        B, KV, G, nq * blk_q, D)
    return o[:, :, :, :Sq].to(q.dtype)
