"""Literal oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``; ``ps_update_ref`` and ``attention_ref`` so far).

Each oracle is the most literal implementation of the math, independent of
the kernel's slot-order loop: the tests hold the kernel's plain version
against it within stated ulps.
"""

from __future__ import annotations

import torch


def ps_update_ref(w, v, g, coef, *, momentum: float, lr: float):
    """w/v: (D,); g: (c, D); coef: (c,)."""
    weighted = torch.einsum("cd,c->d", g.to(torch.float32),
                            torch.as_tensor(coef, dtype=torch.float32,
                                            device=g.device))
    v_new = momentum * v.to(torch.float32) + weighted
    w_new = w.to(torch.float32) - lr * v_new
    return w_new.to(w.dtype), v_new.to(v.dtype)


def attention_ref(q, k, v, *, causal: bool, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) — materialized softmax."""
    from repro_torch.models.attention import naive_attention
    return naive_attention(q, k, v, causal=causal, window=window)
