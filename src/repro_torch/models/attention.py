"""Grouped-query attention with RoPE, qk-norm, QKV-bias and sliding window
(counterpart of ``repro/models/attention.py``).

Three implementations, selected by ``RunConfig.attn_impl`` (its three
values are the reference's):

* ``naive``   — materializes the full score matrix; the test oracle.
* ``chunked`` — online softmax over KV chunks, one Q chunk at a time; the
                plain PyTorch fallback (its P·V product takes bf16
                probabilities and values with fp32 accumulation, as the
                reference's).
* ``pallas``  — in the port, the hand-written CUDA flash-attention kernels
                through ``kernels.ops.flash_attention``: bf16 operands
                launch ``kernels/csrc/flash_attention_sm90.cu`` (tensor
                cores), fp32 ones ``kernels/csrc/flash_attention.cu``; on
                CPU tensors that wrapper runs the kernels' plain PyTorch
                version.

The decode path (one new token against a cache) is a plain einsum, as in
the reference: the score row is (B, H, C), which is small.  Sliding-window
models keep a ring-buffer cache of ``window`` entries.

Caches are written **in place**: ``cache_insert`` writes the new entry into
the cache tensors it is given and returns the same dict (the reference
returns new arrays).  A per-unit cache is a view into the model's stacked
``(n_units, B, C, KV, Dh)`` tensors, so the write lands in that unit's
slice and nowhere else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models.layers import Lead, apply_rope, normal, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_attention(gen, cfg: ModelConfig, dtype, device,
                   lead: Lead = ()) -> dict:
    M, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = float(1.0 / np.sqrt(M))
    p = {
        "w_q": normal(gen, lead + (M, H, Dh), dtype, device, s),
        "w_k": normal(gen, lead + (M, KV, Dh), dtype, device, s),
        "w_v": normal(gen, lead + (M, KV, Dh), dtype, device, s),
        "w_o": normal(gen, lead + (H, Dh, M), dtype, device,
                      float(1.0 / np.sqrt(H * Dh))),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros(lead + (H, Dh), dtype=dtype, device=device)
        p["b_k"] = torch.zeros(lead + (KV, Dh), dtype=dtype, device=device)
        p["b_v"] = torch.zeros(lead + (KV, Dh), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsm,mhd->bshd", x, w) as one matmul."""
    M, Hh, Dh = w.shape
    return torch.matmul(x, w.reshape(M, Hh * Dh)).unflatten(-1, (Hh, Dh))


def project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, M) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), RoPE applied."""
    q = _proj(x, p["w_q"])
    k = _proj(x, p["w_k"])
    v = _proj(x, p["w_v"])
    if cfg.qkv_bias:
        q = q + p["b_q"]
        k = k + p["b_k"]
        v = v + p["b_v"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def output_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    """einsum("bshd,hdm->bsm", o, w_o) as one matmul."""
    H, Dh, M = p["w_o"].shape
    return torch.matmul(o.flatten(-2), p["w_o"].reshape(H * Dh, M))


# ---------------------------------------------------------------------------
# Score-matrix (naive) implementation — the oracle
# ---------------------------------------------------------------------------
def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_positions: Optional[torch.Tensor] = None,
                    k_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: (B,Sq,H,Dh) k/v: (B,Sk,KV,Dh). Returns (B,Sq,H,Dh)."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(Dh)
    qg = q.reshape(B, Sq, KV, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    dev = q.device
    qp = (q_positions if q_positions is not None
          else torch.arange(Sq, device=dev))[:, None]          # (Sq, 1)
    kp = (k_positions if k_positions is not None
          else torch.arange(Sk, device=dev))[None, :]          # (1, Sk)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax implementation
# ---------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024,
                      unroll: bool = False) -> torch.Tensor:
    """Blockwise attention: a loop over Q chunks, and inside it over KV
    chunks in order.  Equivalent to naive_attention for self-attention with
    aligned positions.  ``unroll`` skips the fully masked KV chunks (the
    reference skips them only in its unrolled roofline probe; otherwise
    every chunk is visited)."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    pq, pk = nq * q_chunk - Sq, nk * kv_chunk - Sk
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, pq))
    kp_ = pad(k, (0, 0, 0, 0, 0, pk))
    vp = pad(v, (0, 0, 0, 0, 0, pk))
    scale = 1.0 / np.sqrt(Dh)
    dev, f32, bf16 = q.device, torch.float32, torch.bfloat16

    qb = qp.reshape(B, nq, q_chunk, KV, G, Dh).permute(1, 0, 3, 4, 2, 5)
    kb = kp_.reshape(B, nk, kv_chunk, KV, Dh).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(B, nk, kv_chunk, KV, Dh).permute(1, 0, 3, 2, 4)
    # qb: (nq, B, KV, G, Qc, Dh); kb/vb: (nk, B, KV, Kc, Dh)

    outs = []
    for i in range(nq):
        q0 = i * q_chunk
        qc = qb[i].to(f32)
        qpos = q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, Dh), dtype=f32, device=dev)
        for j in range(nk):
            k0 = j * kv_chunk
            if unroll:
                if causal and k0 > q0 + q_chunk - 1:
                    continue                      # strictly-above-diagonal
                if window > 0 and (k0 + kv_chunk - 1) <= q0 - window:
                    continue                      # beyond the window
            s = torch.einsum("bkgqd,bksd->bkgqs", qc,
                             kb[j].to(f32)) * scale
            kpos = k0 + torch.arange(kv_chunk, device=dev)
            mask = (kpos[None, :] < Sk).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            # bf16 probabilities and values into the PV product, fp32
            # accumulation (the reference's preferred_element_type=f32): a
            # product of two bf16 values is exact in fp32
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p.to(bf16).to(f32),
                vb[j].to(bf16).to(f32))
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs)                       # (nq, B, KV, G, Qc, Dh)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * q_chunk, H, Dh)
    return out[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# Decode step against a cache
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, 1, H, Dh); cache_k/v: (B, C, KV, Dh); cache_len: () or (B,).

    Full-attention models: C = max seq, positions [0, cache_len) are valid.
    Sliding-window models: C = window (ring buffer) and all slots < min(len, C)
    are valid (ring order does not matter for attention, which is a set
    operation over (k, v) pairs — RoPE was already applied at insert time).
    Per-sequence ``cache_len`` supports continuous batching.
    """
    B, _, H, Dh = q.shape
    C, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(Dh)
    qg = q.reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     cache_k.to(torch.float32)) * scale
    lens = torch.as_tensor(cache_len, device=q.device).expand(B)
    valid = (torch.arange(C, device=q.device)[None, None, None, :]
             < lens[:, None, None, None])
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache_v.to(torch.float32))
    return o.reshape(B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Cache plumbing
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  lead: Lead = ()) -> dict:
    """Cache for ONE attention layer (``lead`` stacks it: each leading index
    is a separate allocation's slice, never a broadcast view).
    Sliding-window models only keep the window (ring buffer)."""
    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = lead + (batch, C, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 position: torch.Tensor) -> dict:
    """Write a single (B, 1, KV, Dh) entry at ``position`` (ring if full),
    in place; returns ``cache``.

    ``position`` is a 0-dim tensor (whole batch aligned — the dry-run
    shapes) or a (B,) tensor (continuous batching: every sequence at its own
    depth).  Neither path reads the position on the host."""
    C = cache["k"].shape[1]
    if position.dim() == 0:
        slot = (position % C).reshape(1).long()
        cache["k"].index_copy_(1, slot, k_new)
        cache["v"].index_copy_(1, slot, v_new)
        return cache
    slots = (position % C).long()                            # (B,)
    rows = torch.arange(k_new.shape[0], device=slots.device)
    cache["k"][rows, slots] = k_new[:, 0]
    cache["v"][rows, slots] = v_new[:, 0]
    return cache


# ---------------------------------------------------------------------------
# Top-level attention entry points
# ---------------------------------------------------------------------------
def attention_forward(cfg: ModelConfig, run: RunConfig, p: dict,
                      x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Self-attention over a full sequence (prefill)."""
    q, k, v = project_qkv(cfg, p, x, positions)
    window = cfg.sliding_window
    if run.attn_impl == "naive":
        o = naive_attention(q, k, v, causal=cfg.causal, window=window)
    elif run.attn_impl == "pallas":
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    else:
        o = chunked_attention(q, k, v, causal=cfg.causal, window=window,
                              q_chunk=run.attn_q_chunk,
                              kv_chunk=run.attn_kv_chunk,
                              unroll=run.unroll)
    return output_proj(p, o)


def attention_decode(cfg: ModelConfig, run: RunConfig, p: dict,
                     x: torch.Tensor, position: torch.Tensor,
                     cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, M); position: 0-dim int tensor (aligned
    batch) or (B,) (continuous batching — per-sequence depths).  Writes the
    new K/V into ``cache`` in place."""
    if position.dim() == 0:
        pos = position.reshape(1, 1)                        # broadcast rope
    else:
        pos = position[:, None]                             # (B, 1)
    q, k, v = project_qkv(cfg, p, x, pos)
    cache = cache_insert(cache, k, v, position)
    C = cache["k"].shape[1]
    cache_len = torch.clamp(position + 1, max=C)
    o = decode_attention(q, cache["k"], cache["v"], cache_len,
                         window=cfg.sliding_window)
    return output_proj(p, o), cache
