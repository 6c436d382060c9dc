"""RWKV6 ("Finch") block (counterpart of ``repro/models/rwkv.py``):
attention-free token mixing with data-dependent per-channel decay
(arXiv:2404.05892).

Recurrence per head (key dim P_k = value dim P_v = P)::

    S_t   = diag(exp(w_t)) · S_{t-1} + k_t ⊗ v_t      (w_t < 0, data-dependent)
    out_t = r_t · (S_{t-1} + diag(u) · (k_t ⊗ v_t))

The prefill runs ``kernels.ops.wkv6`` (the CUDA kernel on the card) with
``RunConfig.use_pallas``; without it the exact recurrence
(``kernels.ref.wkv_recurrent``, a loop over time) or, with
``RunConfig.unroll``, :func:`wkv_chunked` — the reference's roofline-probe
path, whose chunked closed form is the kernel's: the port keeps one plain
implementation of it, beside the kernel (``kernels.wkv6.wkv6_plain``).
Decode is one recurrence step in both packages (``_time_mix`` with
``use_pallas`` left False): no kernel.

``decay_w0`` and ``bonus_u`` are fp32 whatever the model dtype; the other
leaves have the model dtype.  Decode writes the block's cache (``wkv``,
``shift_tm``, ``shift_cm``) in place, as ``models/attention.py`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ref import wkv_recurrent
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models.layers import (Lead, init_sqrelu_ffn, normal,
                                       rms_norm, sqrelu_ffn)

_DECAY_LORA = 64


def init_rwkv(gen, cfg: ModelConfig, dtype, device, lead: Lead = ()) -> dict:
    M = cfg.d_model
    H, P = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    s = float(1.0 / np.sqrt(M))

    def full(value, dt):
        return torch.full(lead + (M,), value, dtype=dt, device=device)

    def mat(rows, cols, scale):
        return normal(gen, lead + (rows, cols), dtype, device, scale)

    return {
        # token-shift interpolation coefficients (static per-channel mix)
        "mu_r": full(0.5, dtype),
        "mu_k": full(0.5, dtype),
        "mu_v": full(0.5, dtype),
        "mu_w": full(0.5, dtype),
        "mu_g": full(0.5, dtype),
        "w_r": mat(M, M, s),
        "w_k": mat(M, M, s),
        "w_v": mat(M, M, s),
        "w_g": mat(M, M, s),
        "w_o": mat(M, M, s),
        # data-dependent decay LoRA:  w = w0 + tanh(x@A)@B
        "decay_w0": full(-6.0, torch.float32),
        "decay_A": mat(M, _DECAY_LORA, s),
        "decay_B": mat(_DECAY_LORA, M, float(1.0 / np.sqrt(_DECAY_LORA))),
        "bonus_u": normal(gen, lead + (H, P), torch.float32, device, 0.1),
        "ln_x_scale": full(1.0, dtype),
        "mu_ck": full(0.5, dtype),
        "ffn": init_sqrelu_ffn(gen, M, cfg.d_ff, dtype, device, lead),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Previous-token tensor.  x: (B, S, M); last: (B, M) decode carry."""
    if last is None:
        last = torch.zeros_like(x[:, 0])
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, chunk: int = 32,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV, the closed form per chunk (the reference's unrolled
    roofline-probe path; the same algorithm as ``kernels.wkv6``).  Every
    exponent used is ≤ 0."""
    return wkv6_plain(r, k, v, w, u, chunk=chunk, init_state=init_state)


def _time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
              shifted: torch.Tensor, state=None, use_pallas: bool = False,
              unroll: bool = False):
    B, S, M = x.shape
    H, P = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    xr = _mix(x, shifted, p["mu_r"])
    xk = _mix(x, shifted, p["mu_k"])
    xv = _mix(x, shifted, p["mu_v"])
    xw = _mix(x, shifted, p["mu_w"])
    xg = _mix(x, shifted, p["mu_g"])
    r = torch.matmul(xr, p["w_r"]).reshape(B, S, H, P)
    k = torch.matmul(xk, p["w_k"]).reshape(B, S, H, P)
    v = torch.matmul(xv, p["w_v"]).reshape(B, S, H, P)
    g = F.silu(torch.matmul(xg, p["w_g"]).to(torch.float32))
    lora = torch.tanh(torch.matmul(xw, p["decay_A"]).to(torch.float32))
    wdec = p["decay_w0"] + torch.matmul(lora, p["decay_B"].to(torch.float32))
    # log decay: -exp(w)  in (-inf, 0)
    w = -torch.exp(wdec).reshape(B, S, H, P)
    if use_pallas:
        from repro_torch.kernels import ops as kops
        out, new_state = kops.wkv6(r, k, v, w, p["bonus_u"],
                                   init_state=state)
    elif unroll and S > 1:
        # the reference's roofline probe: at most 128 chunks per sequence
        out, new_state = wkv_chunked(r, k, v, w, p["bonus_u"],
                                     chunk=max(32, S // 128),
                                     init_state=state)
    else:
        out, new_state = wkv_recurrent(r, k, v, w, p["bonus_u"],
                                       init_state=state)
    out = out.reshape(B, S, M)
    out = rms_norm(out.to(x.dtype), p["ln_x_scale"], cfg.norm_eps)
    out = (out.to(torch.float32) * g).to(x.dtype)
    return torch.matmul(out, p["w_o"]), new_state


def rwkv_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 use_pallas: bool = False, unroll: bool = False
                 ) -> torch.Tensor:
    """Full-sequence time mix (the caller places the pre-norm residuals and
    the channel mix, :func:`rwkv_channel_mix`)."""
    out, _ = _time_mix(cfg, p, x, _token_shift(x), use_pallas=use_pallas,
                       unroll=unroll)
    return out


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     last: Optional[torch.Tensor] = None) -> torch.Tensor:
    xk = _mix(x, _token_shift(x, last), p["mu_ck"])
    return sqrelu_ffn(xk, p["ffn"])


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device,
                    lead: Lead = ()) -> dict:
    """Cache for ONE rwkv layer (``lead`` stacks it: a real allocation)."""
    H, P, M = cfg.rwkv_n_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "wkv": torch.zeros(lead + (batch, H, P, P), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros(lead + (batch, M), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros(lead + (batch, M), dtype=dtype,
                                device=device),
    }


def rwkv_decode_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                         cache: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, M).  Writes ``wkv`` and ``shift_tm`` in place."""
    out, state = _time_mix(cfg, p, x, cache["shift_tm"][:, None],
                           state=cache["wkv"])
    cache["wkv"].copy_(state)
    cache["shift_tm"].copy_(x[:, 0])
    return out, cache


def rwkv_decode_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            cache: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, M).  Writes ``shift_cm`` in place."""
    out = rwkv_channel_mix(cfg, p, x, last=cache["shift_cm"])
    cache["shift_cm"].copy_(x[:, 0])
    return out, cache
