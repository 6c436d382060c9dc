"""Block zoo (counterpart of ``repro/models/blocks.py``): one
init / forward / cache / decode quadruple per block type.

A model is a repeating *unit* (``ModelConfig.block_pattern``) of these blocks
stacked ``n_units`` times.  All blocks are pre-norm residual.  The port has
the dense attention block (``BLOCK_ATTN``); every other type raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import config as C
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Lead, init_rms_norm, init_swiglu,
                                       rms_norm, swiglu)

ZERO_AUX = {"lb_loss": 0.0, "z_loss": 0.0, "dropped_fraction": 0.0}

_NOT_PORTED = {
    C.BLOCK_MOE: "moe (ROADMAP.md queue 1 item 10)",
    C.BLOCK_MOE_DENSE_RESIDUAL: "moe (ROADMAP.md queue 1 item 10)",
    C.BLOCK_SHARED_ATTN: "shared_attn (ROADMAP.md queue 1 item 10)",
    C.BLOCK_MAMBA: "mamba and its ssm_scan kernel (ROADMAP.md queue 2 "
                   "item 5)",
    C.BLOCK_RWKV: "rwkv and its wkv6 kernel (ROADMAP.md queue 2 item 6)",
}


def _check(block_type: str) -> None:
    if block_type == C.BLOCK_ATTN:
        return
    if block_type in _NOT_PORTED:
        raise NotImplementedError(f"block type {block_type!r} is not ported "
                                  f"yet: {_NOT_PORTED[block_type]}")
    raise ValueError(block_type)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_block(block_type: str, gen, cfg: ModelConfig, dtype, device,
               lead: Lead = ()) -> dict:
    _check(block_type)
    M = cfg.d_model
    return {"norm1": init_rms_norm(M, dtype, device, lead),
            "attn": attn.init_attention(gen, cfg, dtype, device, lead),
            "norm2": init_rms_norm(M, dtype, device, lead),
            "mlp": init_swiglu(gen, M, cfg.d_ff, dtype, device, lead)}


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def block_forward(block_type: str, cfg: ModelConfig, run: RunConfig,
                  p: dict, shared: Optional[dict], x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    _check(block_type)
    h = attn.attention_forward(cfg, run, p["attn"],
                               rms_norm(x, p["norm1"]["scale"], cfg.norm_eps),
                               positions)
    x = x + h
    x = x + swiglu(rms_norm(x, p["norm2"]["scale"], cfg.norm_eps), p["mlp"])
    return x, ZERO_AUX


# ---------------------------------------------------------------------------
# caches & decode
# ---------------------------------------------------------------------------
def init_block_cache(block_type: str, cfg: ModelConfig, batch: int,
                     max_len: int, dtype, device,
                     lead: Lead = ()) -> Dict[str, Any]:
    _check(block_type)
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device, lead)


def block_decode(block_type: str, cfg: ModelConfig, run: RunConfig,
                 p: dict, shared: Optional[dict], x: torch.Tensor,
                 position: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict, dict]:
    """One-token decode; writes the block's cache in place."""
    _check(block_type)
    h, cache = attn.attention_decode(
        cfg, run, p["attn"], rms_norm(x, p["norm1"]["scale"], cfg.norm_eps),
        position, cache)
    x = x + h
    x = x + swiglu(rms_norm(x, p["norm2"]["scale"], cfg.norm_eps), p["mlp"])
    return x, cache, ZERO_AUX
