"""Literal oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``: ``ps_update_ref``, ``attention_ref``,
``ssm_ref`` and ``wkv6_ref``).

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


def ssm_ref(x, a, Bm, Cm):
    """x: (B,S,H,P); a: (B,S,H); Bm/Cm: (B,S,N) — the sequential
    recurrence S_t = exp(a_t)·S_{t-1} + B_t ⊗ x_t ;  y_t = C_t · S_t.
    Returns (y in x's dtype, final state (B,H,N,P) fp32)."""
    Bt, S, H, P = x.shape
    f32 = torch.float32
    xf, af, Bf, Cf = (t.to(f32) for t in (x, a, Bm, Cm))
    state = torch.zeros((Bt, H, Bm.shape[-1], P), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        state = (torch.exp(af[:, t])[..., None, None] * state
                 + torch.einsum("bn,bhp->bhnp", Bf[:, t], xf[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def wkv6_ref(r, k, v, w, u):
    """r/k/v/w: (B,S,H,P); u: (H,P) — the literal recurrence."""
    from repro_torch.models.rwkv import wkv_recurrent
    return wkv_recurrent(r, k, v, w, u)
