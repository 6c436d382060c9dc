"""Primitive layers (counterpart of ``repro/models/layers.py``).

All layers are plain functions over explicit parameter trees (nested dicts
of tensors, the reference's pytree layout).  Norm and activation arithmetic
runs in fp32 whatever the compute dtype, and results are cast back where the
reference casts: ``swiglu`` takes silu in fp32, rounds it to the parameter
dtype and multiplies by ``u`` there; ``sqrelu_ffn`` squares the relu in
fp32 and rounds it to the input dtype; ``lm_head`` multiplies in the
parameter dtype and then casts to fp32.

The ``init_*`` functions draw from an explicit ``torch.Generator`` (the
reference's ``jax.random`` keys give other numbers; the tests carry the
reference's weights across instead, ``experiments/carry.py``).  ``lead``
prefixes every leaf's shape, so the stacked per-unit parameters of a model
are drawn in one call.

Not ported here: ``layer_norm`` (no model calls it), the losses and
``accuracy`` (training, ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

Lead = Tuple[int, ...]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def normal(gen: Optional[torch.Generator], shape, dtype, device,
           scale: float) -> torch.Tensor:
    """N(0, 1) in ``dtype`` times ``scale`` (rounded in ``dtype``, as the
    reference's ``jax.random.normal(key, shape, dtype) * s``)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) \
        * scale


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def init_rms_norm(d: int, dtype, device, lead: Lead = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(d_head: int, theta: float,
                         device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` copied to ``device`` once: a copy from host
    memory waits for the card, and RoPE runs twice per layer and step."""
    return torch.from_numpy(rope_frequencies(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to (..., seq)."""
    d_head = x.shape[-1]
    freqs = _rope_frequencies_on(d_head, float(theta), x.device)
    angles = positions.to(torch.float32)[..., None] * freqs   # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU MLP.  p: {w_gate (M,F), w_up (M,F), w_down (F,M)}."""
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.matmul(h, p["w_down"])


def init_swiglu(gen, d_model: int, d_ff: int, dtype, device,
                lead: Lead = ()) -> dict:
    s_in = float(1.0 / np.sqrt(d_model))
    s_out = float(1.0 / np.sqrt(d_ff))
    return {
        "w_gate": normal(gen, lead + (d_model, d_ff), dtype, device, s_in),
        "w_up": normal(gen, lead + (d_model, d_ff), dtype, device, s_in),
        "w_down": normal(gen, lead + (d_ff, d_model), dtype, device, s_out),
    }


def sqrelu_ffn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """RWKV channel-mix FFN: squared relu.  p: {w_k (M,F), w_v (F,M)}."""
    k = torch.matmul(x, p["w_k"])
    k = torch.square(torch.relu(k.to(torch.float32))).to(x.dtype)
    return torch.matmul(k, p["w_v"])


def init_sqrelu_ffn(gen, d_model: int, d_ff: int, dtype, device,
                    lead: Lead = ()) -> dict:
    return {
        "w_k": normal(gen, lead + (d_model, d_ff), dtype, device,
                      float(1.0 / np.sqrt(d_model))),
        "w_v": normal(gen, lead + (d_ff, d_model), dtype, device,
                      float(1.0 / np.sqrt(d_ff))),
    }


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def init_embedding(gen, vocab: int, d_model: int, dtype,
                   device) -> torch.Tensor:
    return normal(gen, (vocab, d_model), dtype, device, 0.02)


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., M), w: (M, V) -> logits (..., V) in fp32."""
    return torch.matmul(x, w).to(torch.float32)


def init_lm_head(gen, d_model: int, vocab: int, dtype,
                 device) -> torch.Tensor:
    return normal(gen, (d_model, vocab), dtype, device,
                  float(1.0 / np.sqrt(d_model)))
