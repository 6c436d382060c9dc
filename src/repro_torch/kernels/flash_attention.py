"""Blockwise (flash) attention: one kernel launch per attention layer of a
prefill (CUDA, Hopper).

Counterpart of ``repro/kernels/flash_attention.py``, whose Pallas TPU kernel
(``flash_attention_bkgsd``: ``_attn_kernel`` / ``_attn_block``) becomes
hand-written CUDA C++ in ``csrc/flash_attention.cu``, built by
``kernels/build.py`` and bound with ``ctypes``.  Online-softmax attention
with causal and sliding-window masks and the GQA fold: q is read as
(B, KV, G, Sq, D), k/v as (B, KV, Sk, D), and the G query heads of one KV
head share each K/V tile.  Head ``h`` of the model's (B, S, H, D) layout is
``kv * G + g``.  The math is fp32 whatever the input type (as the TPU
kernel's upcast); the output has q's dtype.

The mask constant is the TPU kernel's finite ``NEG_INF = -1e30`` and the
normaliser is floored at 1e-30: a row whose first processed tile holds no
live key accumulates ``exp(0) = 1`` terms that the next tile's
``alpha = exp(-1e30 - m) = 0`` wipes out exactly (with ``-inf`` that step
would be ``exp(-inf + inf) = NaN``).  Fully masked tiles are skipped as on
the TPU: causal tiles strictly above the diagonal, tiles before the window.

``flash_attention_bkgsd`` checks device, dtype, shapes and that the head dim
is contiguous (the other axes may be strided, so the model's layout launches
without a copy), then launches the kernel on CUDA tensors — or, for CPU
tensors, runs :func:`flash_attention_bkgsd_plain`, the same tile loop,
online softmax, mask constant and tile skip in plain PyTorch, which the
kernel is held against on the card.  Nothing falls back: a CUDA call
launches or raises.  ``launches["flash_attention"]`` counts kernel launches
(plain-version calls do not count).

Tiling: the kernel takes ``ROWS = 64`` query rows (G heads × ``blk_q``
positions, ``blk_q = min(ROWS // G, Sq)``) against ``BLK_K = 64`` keys per
tile; :func:`kernel_tiles` gives them, and the plain version uses them
unless told otherwise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
ROWS = 64            # csrc/flash_attention.cu: query rows per block
BLK_K = 64           # csrc/flash_attention.cu: keys per K/V tile
HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches()
launches = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def kernel_tiles(G: int, Sq: int, Sk: int) -> Tuple[int, int]:
    """(blk_q, blk_k) of the CUDA kernel for G query heads per KV head."""
    if not 1 <= G <= ROWS:
        raise ValueError(f"G = {G} query heads per KV head; the kernel "
                         f"takes 1 to {ROWS}")
    return min(ROWS // G, Sq), min(BLK_K, Sk)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel with its C signature declared; its tile constants
    must be the ones this module assumes."""
    lib = build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, f, i, i, p]
    lib.flash_attention_fwd.restype = i
    for name, want in (("flash_attention_rows", ROWS),
                       ("flash_attention_block_k", BLK_K)):
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of fp32 / bf16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if min(B, KV, G, Sq, Sk, D) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    return B, KV, G, Sq, Sk, D


def flash_attention_bkgsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int = 0,
                          blk_q: Optional[int] = None,
                          blk_k: Optional[int] = None,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q: (B, KV, G, Sq, D); k/v: (B, KV, Sk, D).  Returns a q-shaped
    output in q's dtype (written into ``out`` when given: a q-shaped view
    with a contiguous head dim).  ``blk_q`` / ``blk_k`` tile the plain
    version on the CPU; the CUDA kernel has its own (:func:`kernel_tiles`)
    and refuses others."""
    B, KV, G, Sq, Sk, D = _shapes(q, k, v)
    kq, kk = kernel_tiles(G, Sq, Sk)
    dev = q.device
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    elif (tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype
          or out.device != dev):
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype} on {dev}")
    if dev.type == "cpu":
        out.copy_(flash_attention_bkgsd_plain(
            q, k, v, causal=causal, window=window, blk_q=blk_q or kq,
            blk_k=blk_k or kk))
        return out
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    if (blk_q or kq, blk_k or kk) != (kq, kk):
        raise ValueError(f"the CUDA kernel tiles {(kq, kk)} at G = {G}, "
                         f"not {(blk_q, blk_k)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}; the kernel takes {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    strides = (q.stride(0), q.stride(1), q.stride(2), q.stride(3),
               k.stride(0), k.stride(1), 0, k.stride(2),
               v.stride(0), v.stride(1), 0, v.stride(2),
               out.stride(0), out.stride(1), out.stride(2), out.stride(3))
    lib = _library()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 16)(*strides), B, KV, G, Sq, Sk, D,
        _DTYPES[q.dtype], kq, float(1.0 / math.sqrt(D)), int(causal),
        int(window), torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(lib, "flash_attention", err, "flash_attention")
    launches["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    blk_q: Optional[int] = None,
                    blk_k: Optional[int] = None) -> torch.Tensor:
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
        out=out.view(Bb, Sq, KV, G, D).permute(0, 2, 3, 1, 4))
    return out


def flash_attention_bkgsd_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                window: int = 0, blk_q: int = 128,
                                blk_k: int = 128) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same tile loop over K
    tiles in order, online softmax, mask constant, tile skip and fp32 math,
    vectorised over the query tiles (the kernel's parallel axis).  For each
    K tile only the query tiles for which it is live take part, so no tile
    the kernel skips is computed here either."""
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
    scale = float(1.0 / math.sqrt(D))
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
        s = torch.matmul(qf[:, lo:hi], kf[:, j].unsqueeze(1).transpose(
            -1, -2)) * scale                                 # (BKV, n, R, bk)
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
                         + torch.matmul(p, vf[:, j].unsqueeze(1)))
        m[:, lo:hi] = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    o = o.reshape(B, KV, nq, G, blk_q, D).transpose(2, 3).reshape(
        B, KV, G, nq * blk_q, D)
    return o[:, :, :, :Sq].to(q.dtype)
