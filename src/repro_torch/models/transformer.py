"""Model spine (counterpart of ``repro/models/transformer.py``): a language
model of ``n_units`` repeats of ``cfg.block_pattern``.

Parameters are the reference's nested dict of tensors, leaf for leaf:
``embed``, ``units`` (each leaf stacked on a leading ``n_units`` axis),
``final_norm``, ``head`` and, for a model with ``shared_attn`` blocks
(zamba2), ``shared`` — the weight-shared attention and MLP, with no unit
axis, read by every unit.  So ``experiments/carry.py`` maps the
reference's pytree onto them path by path.  The reference's
``lax.scan`` over units is a loop over units here, each unit's parameters
and caches a view (``[u]``) into the stacked leaves.

Caches are real tensors with a leading ``n_units`` axis (attention K/V,
the mamba state and convolution history, the rwkv state and token shifts)
— never a broadcast view, whose units would share one storage — and
``model_decode_step`` writes them in place and returns the same dict.

``RunConfig.remat`` and ``residual_spec`` steer training and sharding in the
reference; the port's single-card inference path does not read them.
Not ported yet: ``model_loss`` (training, ROADMAP.md queue 1 item 9), the
audio and vision frontends and the moe blocks (queue 1 item 10; see
``models/blocks.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import (dtype_of, embed, init_embedding,
                                       init_lm_head, init_rms_norm, lm_head,
                                       rms_norm)


def _unit(tree, u: int):
    """Unit ``u``'s slice of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def _check_model(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported "
                                  f"yet (ROADMAP.md queue 1 item 10)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                device) -> dict:
    """The parameter tree drawn from ``gen`` on ``device`` as given (no
    card check; ``device="meta"`` with ``gen=None`` gives shapes and dtypes
    only)."""
    _check_model(cfg)
    dtype = dtype_of(cfg.dtype)
    lead = (cfg.n_units,)
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                device),
        "units": {f"block_{i}": B.init_block(bt, gen, cfg, dtype, device,
                                             lead)
                  for i, bt in enumerate(cfg.block_pattern)},
        "final_norm": init_rms_norm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, cfg.d_model, cfg.padded_vocab,
                                      dtype, device)
    shared = B.init_shared_block(gen, cfg, dtype, device)
    if shared is not None:
        params["shared"] = shared
    return params


def init_model(cfg: ModelConfig, gen=0, *, device="cuda") -> dict:
    """Random weights for ``cfg`` on ``device`` (default the card; raises
    without one unless ``device="cpu"``).  ``gen`` is a ``torch.Generator``
    on that device or an int seed for one."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return init_params(cfg, gen, dev)


# ---------------------------------------------------------------------------
# input embedding
# ---------------------------------------------------------------------------
def embed_inputs(cfg: ModelConfig, params: dict,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Returns (B, S, M) input activations (token embeddings)."""
    _check_model(cfg)
    return embed(batch["tokens"], params["embed"])


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def model_forward(cfg: ModelConfig, run: RunConfig, params: dict,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits fp32 (B,S,V), aux)."""
    x = embed_inputs(cfg, params, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    shared = params.get("shared")
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(cfg.n_units):
        unit_params = _unit(params["units"], u)
        for i, bt in enumerate(cfg.block_pattern):
            x, aux = B.block_forward(bt, cfg, run, unit_params[f"block_{i}"],
                                     shared, x, positions)
            lb = lb + aux["lb_loss"]
            zl = zl + aux["z_loss"]
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head_w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = _mask_padded(cfg, lm_head(x, head_w))
    return logits, {"lb_loss": lb, "z_loss": zl}


def _mask_padded(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab is padded to a multiple of 256 (config.padded_vocab); padded
    ids get -1e30 so argmax and sampling never see them.  Writes the fresh
    logits tensor in place (the reference's ``where`` makes a copy, which at
    a long prefill is gigabytes)."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda") -> dict:
    """Stacked (n_units leading axis) per-block caches: one real
    allocation per leaf, so no two units share storage."""
    _check_model(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return {f"block_{i}": B.init_block_cache(bt, cfg, batch, max_len, dtype,
                                             dev, (cfg.n_units,))
            for i, bt in enumerate(cfg.block_pattern)}


def model_decode_step(cfg: ModelConfig, run: RunConfig, params: dict,
                      token: torch.Tensor, position, caches: dict
                      ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1) int; position: 0-dim (aligned
    batch) or (B,) int tensor (an int is moved to the device).  Writes
    ``caches`` in place; returns (logits (B, 1, V) fp32, caches)."""
    x = embed(token, params["embed"])
    if not torch.is_tensor(position):
        position = torch.as_tensor(position, dtype=torch.int32,
                                   device=x.device)
    shared = params.get("shared")
    for u in range(cfg.n_units):
        unit_params = _unit(params["units"], u)
        unit_cache = _unit(caches, u)
        for i, bt in enumerate(cfg.block_pattern):
            x, _, _ = B.block_decode(bt, cfg, run, unit_params[f"block_{i}"],
                                     shared, x, position,
                                     unit_cache[f"block_{i}"])
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head_w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return _mask_padded(cfg, lm_head(x, head_w)), caches


# ---------------------------------------------------------------------------
# convenience: parameter counting on the real tree
# ---------------------------------------------------------------------------
def _leaves(tree):
    """The tensors of a nested dict, depth first in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def count_params(params: dict) -> int:
    return sum(t.numel() for t in _leaves(params))
