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

Training (:func:`model_loss`) runs through autograd on the plain layers.
With ``RunConfig.remat`` (the default) each unit is a
``torch.utils.checkpoint`` region (``use_reentrant=False``), the
reference's ``jax.checkpoint`` of its scan body: only a unit's input is
kept for the backward, its inside recomputed.  The stacked unit leaves are
``unbind``-ed once per forward, so the backward writes each stacked
gradient once (an index per unit would add n_units full-size zero tensors).
``attn_impl="pallas"`` and ``use_pallas`` have no backward, in the
reference as here: :func:`model_loss` refuses them.  ``residual_spec``
steers sharding in the reference; the single-card port does not read it.

Modality frontends are stubs, as in the reference: an audio model
(hubert) takes precomputed frame embeddings ``frames`` (B, S, M), a VLM
(internvl2) precomputed patch embeddings ``patches`` (B, P, M) prepended to
its token embeddings, each through the learned ``frontend_proj`` (M × M).
An encoder-only model has no decode step (``config.validate_pairing``).

A published model that is a list of layers, not a repeating unit, has a
config type of its own and a family module that holds its
``init_params``, ``forward``, ``init_caches`` and ``decode_step``:
``config.HybridConfig`` (Zamba2) → ``models/hybrid.py``,
``config.GraniteConfig`` (Granite 4.0-H) → ``models/granite.py``.
:func:`family` is the one seam: ``init_params``, ``model_forward``,
``init_caches`` and ``model_decode_step`` hand such a config to its
module.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (GraniteConfig, HybridConfig, ModelConfig,
                                RunConfig)
from repro_torch.core.distributed import check_trainable
from repro_torch.core.engine import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import granite, hybrid
from repro_torch.models.layers import (dtype_of, embed, init_embedding,
                                       init_lm_head, init_rms_norm, lm_head,
                                       normal, rms_norm,
                                       softmax_cross_entropy)


# a published layer-list model's config type → its family module
FAMILIES = {HybridConfig: hybrid, GraniteConfig: granite}


def family(cfg: ModelConfig):
    """The family module of a published layer-list model, or None for the
    reference's unit grammar."""
    return FAMILIES.get(type(cfg))


def _unit(tree, u: int):
    """Unit ``u``'s slice of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def _unit_trees(tree, n: int) -> list:
    """The ``n`` per-unit trees of a stacked tree: every leaf ``unbind``-ed
    once (views; one stacked gradient in the backward)."""
    if isinstance(tree, dict):
        per = {k: _unit_trees(v, n) for k, v in tree.items()}
        return [{k: per[k][u] for k in tree} for u in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                device) -> dict:
    """The parameter tree drawn from ``gen`` on ``device`` as given (no
    card check; ``device="meta"`` with ``gen=None`` gives shapes and dtypes
    only)."""
    if (fam := family(cfg)) is not None:
        return fam.init_params(cfg, gen, device)
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
    if cfg.frontend != "none":
        params["frontend_proj"] = normal(
            gen, (cfg.d_model, cfg.d_model), dtype, device,
            float(1.0 / np.sqrt(cfg.d_model)))
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
    """Returns (B, S, M) input activations: the projected frames (audio),
    the projected patches followed by the token embeddings (vision), or the
    token embeddings."""
    if cfg.frontend == "audio":
        return torch.matmul(batch["frames"], params["frontend_proj"])
    if cfg.frontend == "vision":
        patches = torch.matmul(batch["patches"], params["frontend_proj"])
        toks = embed(batch["tokens"], params["embed"])
        return torch.cat([patches, toks], dim=1)
    return embed(batch["tokens"], params["embed"])


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def model_forward(cfg: ModelConfig, run: RunConfig, params: dict,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits fp32 (B,S,V), aux)."""
    if (fam := family(cfg)) is not None:
        return fam.forward(cfg, run, params, batch)
    x = embed_inputs(cfg, params, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    shared = params.get("shared")
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit_body(x, lb, zl, unit_params):
        for i, bt in enumerate(cfg.block_pattern):
            x, aux = B.block_forward(bt, cfg, run, unit_params[f"block_{i}"],
                                     shared, x, positions)
            lb = lb + aux["lb_loss"]
            zl = zl + aux["z_loss"]
        return x, lb, zl

    remat = run.remat and torch.is_grad_enabled()
    for unit_params in _unit_trees(params["units"], cfg.n_units):
        if remat:
            x, lb, zl = checkpoint(unit_body, x, lb, zl, unit_params,
                                   use_reentrant=False)
        else:
            x, lb, zl = unit_body(x, lb, zl, unit_params)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head_w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = _mask_padded(cfg, lm_head(x, head_w))
    return logits, {"lb_loss": lb, "z_loss": zl}


def _mask_padded(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab is padded to a multiple of 256 (config.padded_vocab); padded
    ids get -1e30 so CE, argmax and sampling never see them.  Writes the
    fresh logits tensor in place (the reference's ``where`` makes a copy,
    which at a long prefill is gigabytes).  Autograd takes the write: no
    backward saved the tensor it overwrites, and the overwritten columns
    pass exactly zero gradient back to the head, as the ``where`` does."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def model_loss(cfg: ModelConfig, run: RunConfig, params: dict,
               batch: Dict[str, torch.Tensor], sample_weights=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy (+ the blocks' aux losses).  ``batch`` carries labels
    and loss_mask; ``sample_weights`` (B,) are per-sample loss weights (the
    fused softsync engine's staleness-weighted gradient combination),
    folded into the mask.  Raises on the forward-only kernel paths."""
    check_trainable(run)
    logits, aux = model_forward(cfg, run, params, batch)
    mask = batch.get("loss_mask")
    if sample_weights is not None:
        w = sample_weights[:, None]
        mask = w if mask is None else mask * w
    ce = softmax_cross_entropy(logits, batch["labels"], mask)
    loss = ce + aux["lb_loss"] + aux["z_loss"]
    return loss, {"loss": loss, "ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda") -> dict:
    """Stacked (n_units leading axis) per-block caches: one real
    allocation per leaf, so no two units share storage."""
    dev = resolve_device(device)
    if (fam := family(cfg)) is not None:
        return fam.init_caches(cfg, batch, max_len, dev)
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
    if not torch.is_tensor(position):
        position = torch.as_tensor(position, dtype=torch.int32,
                                   device=token.device)
    if (fam := family(cfg)) is not None:
        return fam.decode_step(cfg, run, params, token, position, caches)
    x = embed(token, params["embed"])
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
