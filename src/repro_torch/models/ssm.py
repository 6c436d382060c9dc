"""Mamba2 (SSD) block (counterpart of ``repro/models/ssm.py``): the chunked
state-space scan of a full sequence and the single-step decode.

Parameters are the reference's leaves: the projections ``w_z`` / ``w_x`` /
``w_bc`` / ``w_dt`` / ``w_out``, the depthwise convolutions and their
biases, ``norm_scale`` in the model dtype, and ``A_log``, ``D`` and
``dt_bias`` in fp32 whatever the model dtype.  ``dt_bias`` comes from
``np.random.RandomState(0)`` in both packages, so it is equal leaf for leaf.

The prefill scan is ``kernels.ops.ssm_scan`` (the CUDA kernel on the card)
with ``RunConfig.use_pallas`` and :func:`ssd_chunked` without it.  The
reference's ``ssd_chunked`` and its Pallas kernel compute the same chunked
algorithm; the port keeps one plain implementation of it, beside the kernel
(``kernels.ssm_scan.ssm_scan_plain``, with the reference's ``_segsum`` as
``kernels.ssm_scan.segsum``).  Decode is the plain single-step recurrence
in both packages: no kernel.

Decode writes the block's cache (``state``, ``conv_x``, ``conv_bc``) in
place, as ``models/attention.py`` does: a unit's cache is a view into the
model's stacked cache tensors, which ``model_decode_step`` does not
reassemble.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.mamba_glue import causal_conv_plain
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.models.layers import Lead, normal, rms_norm


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _fp32_leaf(arr: np.ndarray, device, lead: Lead) -> torch.Tensor:
    """A numpy fp32 vector repeated over ``lead`` (the reference's vmap
    over units stacks the same constant), on ``device``."""
    return torch.from_numpy(np.broadcast_to(arr, lead + arr.shape).copy()) \
        .to(device)


def init_mamba(gen, cfg: ModelConfig, dtype, device, lead: Lead = ()) -> dict:
    M = cfg.d_model
    Din = cfg.ssm_d_inner
    H = cfg.ssm_n_heads
    N = cfg.ssm_state
    K = cfg.ssm_conv
    s = float(1.0 / np.sqrt(M))
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1]
    dt = np.exp(np.random.RandomState(0).uniform(
        np.log(1e-3), np.log(1e-1), size=(H,))).astype(np.float32)
    dt_bias = dt + np.log(-np.expm1(-dt))
    return {
        "w_z": normal(gen, lead + (M, Din), dtype, device, s),
        "w_x": normal(gen, lead + (M, Din), dtype, device, s),
        "w_bc": normal(gen, lead + (M, 2 * N), dtype, device, s),
        "w_dt": normal(gen, lead + (M, H), dtype, device, s),
        "conv_x": normal(gen, lead + (K, Din), dtype, device,
                         float(1.0 / np.sqrt(K))),
        "conv_bc": normal(gen, lead + (K, 2 * N), dtype, device,
                          float(1.0 / np.sqrt(K))),
        "conv_bx": torch.zeros(lead + (Din,), dtype=dtype, device=device),
        "conv_bbc": torch.zeros(lead + (2 * N,), dtype=dtype, device=device),
        "A_log": _fp32_leaf(np.log(np.arange(1, H + 1, dtype=np.float32)),
                            device, lead),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "dt_bias": _fp32_leaf(dt_bias, device, lead),
        "norm_scale": torch.ones(lead + (Din,), dtype=dtype, device=device),
        "w_out": normal(gen, lead + (Din, M), dtype, device,
                        float(1.0 / np.sqrt(Din))),
    }


# ---------------------------------------------------------------------------
# Chunked SSD scan
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective-state-space scan.

    x: (Bt, S, H, P) inputs (already multiplied by dt); a: (Bt, S, H)
    per-step log decay (= dt * A, negative); B / C: (Bt, S, N) input and
    output projections (n_groups = 1).  Returns (y (Bt,S,H,P) in x's dtype,
    final_state (Bt,H,N,P) fp32).

    Recurrence: S_t = exp(a_t)·S_{t-1} + B_t ⊗ x_t ;  y_t = C_t · S_t.
    (The reference's ``unroll`` flag picks a Python loop over chunks
    instead of ``lax.scan``; here the loop is always a Python loop.)
    """
    return ssm_scan_plain(x, a, B, C, chunk=chunk, init_state=init_state)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  state (Bt,H,N,P); x (Bt,H,P); a (Bt,H);
    B/C (Bt,N).  Returns (y (Bt,H,P), new state)."""
    f32 = torch.float32
    xf, Bf, Cf = x.to(f32), B.to(f32), C.to(f32)
    state = (torch.exp(a)[..., None, None] * state
             + torch.einsum("bn,bhp->bhnp", Bf, xf))
    y = torch.einsum("bn,bhnp->bhp", Cf, state)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------
def _project(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, M) -> z (B,S,Din), xs (B,S,Din), BC (B,S,2N), dt (B,S,H)."""
    return (torch.matmul(x, p["w_z"]), torch.matmul(x, p["w_x"]),
            torch.matmul(x, p["w_bc"]), torch.matmul(x, p["w_dt"]))


def _gate_out(cfg: ModelConfig, p: dict, y: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """rms_norm(y · silu(z)) @ w_out (y: (B, S, Din) in ``dtype``)."""
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(dtype), p["norm_scale"],
                 cfg.norm_eps)
    return torch.matmul(y, p["w_out"])


def mamba_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  use_pallas: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (B, S, M) -> (B, S, M)."""
    Bt, S, M = x.shape
    Din, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                    cfg.ssm_head_dim)
    z, xs, bc, dt = _project(cfg, p, x)
    xs, _ = causal_conv_plain(xs, p["conv_x"], p["conv_bx"])
    bc, _ = causal_conv_plain(bc, p["conv_bc"], p["conv_bbc"])
    xs = xs.reshape(Bt, S, H, P)
    Bm = bc[..., :N]
    Cm = bc[..., N:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])         # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,) < 0
    a = dt * A                                                   # log decay
    xdt = xs.to(torch.float32) * dt[..., None]
    if use_pallas:
        from repro_torch.kernels import ops as kops
        y, _ = kops.ssm_scan(xdt, a, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, _ = ssd_chunked(xdt, a, Bm, Cm, cfg.ssm_chunk)
    y = y.to(x.dtype) + xs * p["D"][None, None, :, None].to(x.dtype)
    return _gate_out(cfg, p, y.reshape(Bt, S, Din), z, x.dtype)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     lead: Lead = ()) -> dict:
    """Cache for ONE mamba layer (``lead`` stacks it: a real allocation)."""
    return {
        "state": torch.zeros(lead + (batch, cfg.ssm_n_heads, cfg.ssm_state,
                                     cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                      cfg.ssm_d_inner),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                       2 * cfg.ssm_state),
                               dtype=dtype, device=device),
    }


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, M).  Writes ``cache`` in place and
    returns it."""
    Bt, _, M = x.shape
    Din, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                    cfg.ssm_head_dim)
    z, xs, bc, dt = _project(cfg, p, x)
    xs, conv_x = causal_conv_plain(xs, p["conv_x"], p["conv_bx"],
                                   cache["conv_x"])
    bc, conv_bc = causal_conv_plain(bc, p["conv_bc"], p["conv_bbc"],
                                    cache["conv_bc"])
    xs = xs[:, 0].reshape(Bt, H, P)
    Bm = bc[:, 0, :N]
    Cm = bc[:, 0, N:]
    dt = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
    a = dt * -torch.exp(p["A_log"])
    xdt = xs.to(torch.float32) * dt[..., None]
    y, state = ssd_decode_step(cache["state"], xdt, a, Bm, Cm)
    y = y.to(x.dtype) + xs * p["D"][None, :, None].to(x.dtype)
    out = _gate_out(cfg, p, y.reshape(Bt, 1, Din), z, x.dtype)
    cache["state"].copy_(state)
    cache["conv_x"].copy_(conv_x)
    cache["conv_bc"].copy_(conv_bc)
    return out, cache
