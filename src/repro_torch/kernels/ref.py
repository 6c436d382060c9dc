"""Literal oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``: ``ps_update_ref``, ``attention_ref``,
``ssm_ref`` and ``wkv6_ref``).

Each oracle is the most literal implementation of the math, independent of
the kernel's slot-order loop: the tests hold the kernel's plain version
against it within stated ulps.  :func:`naive_attention` and
:func:`wkv_recurrent` live here, below the model stack, which runs them as
its ``naive`` attention and its exact WKV recurrence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def ps_update_ref(w, v, g, coef, *, momentum: float, lr: float):
    """w/v: (D,); g: (c, D); coef: (c,)."""
    weighted = torch.einsum("cd,c->d", g.to(torch.float32),
                            torch.as_tensor(coef, dtype=torch.float32,
                                            device=g.device))
    v_new = momentum * v.to(torch.float32) + weighted
    w_new = w.to(torch.float32) - lr * v_new
    return w_new.to(w.dtype), v_new.to(v.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_positions: Optional[torch.Tensor] = None,
                    k_positions: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,Dh) k/v: (B,Sk,KV,Dh). Returns (B,Sq,H,Dh).  ``scale``
    multiplies q·k (1/√Dh when None)."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
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


def attention_ref(q, k, v, *, causal: bool, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) — materialized softmax."""
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
    return wkv_recurrent(r, k, v, w, u)


def wkv_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact recurrence, a loop over time.

    r/k/v: (B, S, H, P); w: (B, S, H, P) log-decay (< 0); u: (H, P) bonus.
    Returns (out (B,S,H,P) fp32, final state (B,H,P,P))."""
    B, S, H, P = r.shape
    f32 = torch.float32
    rf, kf, vf, wf = (t.to(f32) for t in (r, k, v, w))
    state = (torch.zeros((B, H, P, P), dtype=f32, device=r.device)
             if init_state is None else init_state)
    uu = u[None, :, :, None]
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # key ⊗ value
        outs.append(torch.einsum("bhp,bhpq->bhq", rf[:, t],
                                 state + uu * kv))
        state = torch.exp(wf[:, t])[..., None] * state + kv
    return torch.stack(outs, dim=1), state
