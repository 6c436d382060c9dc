"""Mixture-of-Experts with capacity-based scatter dispatch (counterpart of
``repro/models/moe.py``, GShard-style grouping, Megablocks-style
dense-capacity buffers).

Tokens are cut into groups — ``GROUP_T`` = 2 048 tokens at most, halved
until the group divides the sequence; one group of all B·S tokens when
S < E, which is the decode path — and each group routes on its own: an
fp32 router, softmax, top-k, and a slot per routed token in its expert's
buffer of ``capacity`` rows.  A token whose slot is past the capacity is
dropped (it contributes nothing, and its share of the output is 0).

The expert products, the scatter and the gather are PyTorch calls
(``torch.bmm``, ``index_put_``, indexing), as the reference computes them
outside any Pallas kernel (``repro/models/moe.py:79-113``): a large plain
product stays a library product, and there is no TPU kernel to port here.

Where the port must differ in mechanism to give the reference's numbers:

* **Dropped slots.** A dropped token's slot is ``pos >= C``.  JAX drops an
  out-of-bounds scatter update and clamps an out-of-bounds gather; torch
  raises on both (a device-side assert on the card).  So the dispatch
  buffer has one spare row, slot C, that every dropped token is written to
  and that is sliced off, and the combine clamps its gather index to C − 1
  (the row it reads there is multiplied by ``keep = 0``, as in JAX).
* **Slot order.** ``pos`` is a running count over the flattened (T·k)
  axis, token-major and k-minor, as the reference's cumsum: which tokens
  drop depends on that order.
* **top-k ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  :func:`route` takes the first
  k of a stable descending sort, which keeps the lower index first.
* **Rounding.** The router runs in fp32 whatever the model dtype (on the
  card TF32 must be off for it to be fp32); the gate activation is
  ``silu(g in fp32)`` rounded to the model dtype, times ``u``.

Prefill and decode group differently (2 048 tokens of one sequence against
the B tokens of one step), so their capacities, and which tokens drop,
differ by design: an MoE model's decode-replay prefill is not its
full-sequence forward.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Lead, normal

GROUP_T = 2048


def init_moe(gen, cfg: ModelConfig, dtype, device, lead: Lead = ()) -> dict:
    """Router (fp32 whatever ``dtype``) and the E experts' SwiGLU
    weights."""
    M = cfg.d_model
    F = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    s_in, s_out = float(1.0 / np.sqrt(M)), float(1.0 / np.sqrt(F))
    return {
        "w_router": normal(gen, lead + (M, E), torch.float32, device, s_in),
        "w_gate": normal(gen, lead + (E, M, F), dtype, device, s_in),
        "w_up": normal(gen, lead + (E, M, F), dtype, device, s_in),
        "w_down": normal(gen, lead + (E, F, M), dtype, device, s_out),
    }


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    E, k = cfg.n_experts, cfg.top_k
    c = int(math.ceil(tokens_per_group * k / E * cfg.capacity_factor))
    return max(c, 1)


def groups(B: int, S: int, E: int) -> Tuple[int, int]:
    """(G, T): the number of groups and the tokens per group of a (B, S)
    batch."""
    if S >= E:
        T = min(S, GROUP_T)
        while S % T:
            T //= 2
        return B * (S // T), T
    return 1, B * S


def route(cfg: ModelConfig, p: dict, x: torch.Tensor) -> dict:
    """The routing of x (B, S, M): the grouped tokens ``xg`` (G, T, M), the
    fp32 router ``logits`` and ``probs`` (G, T, E), the normalised gate
    weights and expert ids ``gate_w`` / ``idx`` (G, T, k), each routed
    token's slot ``pos`` (G, T·k) and ``keep`` (pos < C), and ``C``."""
    B, S, M = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G, T = groups(B, S, E)
    xg = x.reshape(G, T, M)
    C = capacity(T, cfg)
    logits = torch.matmul(xg.to(torch.float32), p["w_router"])
    probs = torch.softmax(logits, dim=-1)
    # the first k of a stable descending sort: ties keep the lower index
    # first, as jax.lax.top_k
    gate_w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, idx = gate_w[..., :k], idx[..., :k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    # slot of each routed token: how many earlier (token-major, k-minor)
    # routed tokens of its group chose the same expert
    fidx = idx.reshape(G, T * k)
    onehot = (fidx[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)                                          # (G, T·k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - 1, 2,
                       fidx[..., None])[..., 0]
    return {"xg": xg, "logits": logits, "probs": probs, "gate_w": gate_w,
            "idx": idx, "fidx": fidx, "pos": pos, "keep": pos < C, "C": C}


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, M).  Returns (out (B, S, M), aux dict with losses and the
    dropped fraction)."""
    B, S, M = x.shape
    E, k = cfg.n_experts, cfg.top_k
    r = route(cfg, p, x)
    xg, fidx, pos, keep, C = r["xg"], r["fidx"], r["pos"], r["keep"], r["C"]
    G, T = xg.shape[:2]

    # ---- aux losses: Switch-style load balance and the router z-loss -----
    me = r["probs"].mean(dim=(0, 1))                          # (E,)
    ce = (r["idx"][..., 0, None] == torch.arange(E, device=x.device)).to(
        torch.float32).mean(dim=(0, 1))
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1)))

    # ---- dispatch into (G, E, C + 1, M); row C takes the dropped tokens --
    slot_tokens = torch.repeat_interleave(xg, k, dim=1)       # (G, T·k, M)
    contrib = slot_tokens * keep[..., None].to(x.dtype)
    gi = torch.arange(G, device=x.device)[:, None].expand(G, T * k)
    buf = torch.zeros((G, E, C + 1, M), dtype=x.dtype, device=x.device)
    buf.index_put_((gi, fidx, torch.clamp_max(pos, C)), contrib,
                   accumulate=True)
    buf = buf[:, :, :C]

    # ---- expert compute (SwiGLU), one batched product per weight ---------
    be = buf.transpose(0, 1).reshape(E, G * C, M)
    g = torch.bmm(be, p["w_gate"])
    u = torch.bmm(be, p["w_up"])
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    eo = torch.bmm(h, p["w_down"]).reshape(E, G, C, M).transpose(0, 1)

    # ---- combine: gather each slot's row (clamped), weight, sum over k ---
    gathered = eo[gi, fidx, torch.clamp_max(pos, C - 1)]      # (G, T·k, M)
    w = (r["gate_w"].reshape(G, T * k) * keep).to(x.dtype)
    out = (gathered * w[..., None]).reshape(G, T, k, M).sum(dim=2)
    out = out.reshape(B, S, M)

    dropped = 1.0 - keep.to(torch.float32).mean()
    aux = {
        "lb_loss": lb_loss * cfg.load_balance_loss,
        "z_loss": z_loss * cfg.router_z_loss,
        "dropped_fraction": dropped,
    }
    return out, aux
