"""Block zoo (counterpart of ``repro/models/blocks.py``): one
init / forward / cache / decode quadruple per block type.

A model is a repeating *unit* (``ModelConfig.block_pattern``) of these blocks
stacked ``n_units`` times.  All blocks are pre-norm residual.  ``shared``
carries the weight-shared attention block of zamba2 (``BLOCK_SHARED_ATTN``):
its attention and MLP weights (:func:`init_shared_block`) have no unit axis
and serve every unit, while each unit keeps its own norms and its own KV
cache.  ``moe`` is attention and a top-k MoE in place of the MLP;
``moe_dense`` (arctic) is attention and the MoE beside a dense MLP, both
reading the same normed input (``models/moe.py``).  The MoE blocks' aux
dict carries their load-balance and z losses and the dropped fraction.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import config as C
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Lead, init_rms_norm, init_swiglu,
                                       rms_norm, swiglu)

ZERO_AUX = {"lb_loss": 0.0, "z_loss": 0.0, "dropped_fraction": 0.0}

_ATTENTION = (C.BLOCK_ATTN, C.BLOCK_MOE, C.BLOCK_MOE_DENSE_RESIDUAL,
              C.BLOCK_SHARED_ATTN)


def _check(block_type: str) -> None:
    if block_type not in _ATTENTION + (C.BLOCK_MAMBA, C.BLOCK_RWKV):
        raise ValueError(block_type)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_block(block_type: str, gen, cfg: ModelConfig, dtype, device,
               lead: Lead = ()) -> dict:
    _check(block_type)
    M = cfg.d_model
    norm = init_rms_norm(M, dtype, device, lead)
    if block_type == C.BLOCK_ATTN:
        return {"norm1": norm,
                "attn": attn.init_attention(gen, cfg, dtype, device, lead),
                "norm2": init_rms_norm(M, dtype, device, lead),
                "mlp": init_swiglu(gen, M, cfg.d_ff, dtype, device, lead)}
    if block_type == C.BLOCK_MOE:
        return {"norm1": norm,
                "attn": attn.init_attention(gen, cfg, dtype, device, lead),
                "norm2": init_rms_norm(M, dtype, device, lead),
                "moe": moe_mod.init_moe(gen, cfg, dtype, device, lead)}
    if block_type == C.BLOCK_MOE_DENSE_RESIDUAL:
        return {"norm1": norm,
                "attn": attn.init_attention(gen, cfg, dtype, device, lead),
                "norm2": init_rms_norm(M, dtype, device, lead),
                "mlp": init_swiglu(gen, M, cfg.d_ff, dtype, device, lead),
                "moe": moe_mod.init_moe(gen, cfg, dtype, device, lead)}
    if block_type == C.BLOCK_MAMBA:
        return {"norm1": norm,
                "mamba": ssm_mod.init_mamba(gen, cfg, dtype, device, lead)}
    if block_type == C.BLOCK_RWKV:
        return {"norm1": norm,
                "norm2": init_rms_norm(M, dtype, device, lead),
                "rwkv": rwkv_mod.init_rwkv(gen, cfg, dtype, device, lead)}
    # shared_attn: per-unit parameters are the norms only; the attention and
    # MLP weights live in the shared trunk (init_shared_block)
    return {"norm1": norm, "norm2": init_rms_norm(M, dtype, device, lead)}


def init_shared_block(gen, cfg: ModelConfig, dtype,
                      device) -> Optional[dict]:
    """The shared trunk of a model with ``shared_attn`` blocks (no unit
    axis), else None."""
    if C.BLOCK_SHARED_ATTN not in cfg.block_pattern:
        return None
    return {"attn": attn.init_attention(gen, cfg, dtype, device),
            "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def _attn_weights(block_type: str, p: dict, shared: Optional[dict]) -> dict:
    """The attention and MLP weights of an attention block: its own, or
    the shared trunk's."""
    return shared if block_type == C.BLOCK_SHARED_ATTN else p


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def block_forward(block_type: str, cfg: ModelConfig, run: RunConfig,
                  p: dict, shared: Optional[dict], x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    _check(block_type)
    h1 = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    if block_type == C.BLOCK_MAMBA:
        return x + ssm_mod.mamba_forward(cfg, p["mamba"], h1,
                                         use_pallas=run.use_pallas), ZERO_AUX
    if block_type == C.BLOCK_RWKV:
        x = x + rwkv_mod.rwkv_forward(cfg, p["rwkv"], h1,
                                      use_pallas=run.use_pallas,
                                      unroll=run.unroll)
        return x + rwkv_mod.rwkv_channel_mix(
            cfg, p["rwkv"], rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
        ), ZERO_AUX
    w = _attn_weights(block_type, p, shared)
    x = x + attn.attention_forward(cfg, run, w["attn"], h1, positions)
    return _feed_forward(block_type, cfg, p, w, x)


def _feed_forward(block_type: str, cfg: ModelConfig, p: dict, w: dict,
                  x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """The second half of an attention block: the MLP, the MoE, or (arctic)
    both on the same normed input."""
    xn = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if block_type == C.BLOCK_MOE:
        mo, aux = moe_mod.moe_forward(cfg, p["moe"], xn)
        return x + mo, aux
    if block_type == C.BLOCK_MOE_DENSE_RESIDUAL:
        mo, aux = moe_mod.moe_forward(cfg, p["moe"], xn)
        return x + mo + swiglu(xn, p["mlp"]), aux
    return x + swiglu(xn, w["mlp"]), ZERO_AUX


# ---------------------------------------------------------------------------
# caches & decode
# ---------------------------------------------------------------------------
def init_block_cache(block_type: str, cfg: ModelConfig, batch: int,
                     max_len: int, dtype, device,
                     lead: Lead = ()) -> Dict[str, Any]:
    _check(block_type)
    if block_type == C.BLOCK_MAMBA:
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device, lead)
    if block_type == C.BLOCK_RWKV:
        return rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device, lead)
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device, lead)


def block_decode(block_type: str, cfg: ModelConfig, run: RunConfig,
                 p: dict, shared: Optional[dict], x: torch.Tensor,
                 position: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict, dict]:
    """One-token decode; writes the block's cache in place."""
    _check(block_type)
    h1 = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    if block_type == C.BLOCK_MAMBA:
        h, cache = ssm_mod.mamba_decode(cfg, p["mamba"], h1, cache)
        return x + h, cache, ZERO_AUX
    if block_type == C.BLOCK_RWKV:
        h, cache = rwkv_mod.rwkv_decode_time_mix(cfg, p["rwkv"], h1, cache)
        x = x + h
        h, cache = rwkv_mod.rwkv_decode_channel_mix(
            cfg, p["rwkv"], rms_norm(x, p["norm2"]["scale"], cfg.norm_eps),
            cache)
        return x + h, cache, ZERO_AUX
    w = _attn_weights(block_type, p, shared)
    h, cache = attn.attention_decode(cfg, run, w["attn"], h1, position,
                                     cache)
    x, aux = _feed_forward(block_type, cfg, p, w, x + h)
    return x, cache, aux
