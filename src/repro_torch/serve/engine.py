"""Serving engine (counterpart of ``repro/serve/engine.py``): batched
prefill and decode with per-layer KV caches.

``prefill_step`` is the full-sequence forward (one flash-attention kernel
launch per layer with ``attn_impl="pallas"``); ``serve_step`` decodes ONE
new token for every sequence of the batch against its cache; ``prefill``
fills the caches by replaying decode steps (the functional reference that
leaves the caches ready for decode) and ``generate`` is greedy generation
on top of it.

Caches are written in place (``models/attention.py``): a state returned by
``prefill`` shares its caches with the state it was given.  The whole path
runs under ``torch.inference_mode()``; no step reads a device value on the
host except sampling's result.  ``prefill_step`` is the span ``prefill``
(on the device's clock too), counting the batch's ``tokens``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import init_caches, model_decode_step, model_forward


@dataclasses.dataclass
class ServeState:
    caches: dict
    position: torch.Tensor       # () int32 — next write index
    last_tokens: torch.Tensor    # (B, 1) most recent token per sequence


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int, *,
                     device="cuda") -> ServeState:
    """Empty caches on ``device`` (default the card; raises without one
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return ServeState(
        caches=init_caches(cfg, batch, max_len, device=dev),
        position=torch.zeros((), dtype=torch.int32, device=dev),
        last_tokens=torch.zeros((batch, 1), dtype=torch.int32, device=dev),
    )


@torch.inference_mode()
def prefill(cfg: ModelConfig, run: RunConfig, params: dict,
            batch: Dict[str, torch.Tensor], state: ServeState
            ) -> Tuple[torch.Tensor, ServeState]:
    """Process the full prompt, filling the caches by replaying decode steps.
    Returns (logits (B, S, V) fp32, the new state)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    caches, pos = state.caches, state.position
    all_logits = []
    for t in range(S):
        logits, caches = model_decode_step(cfg, run, params,
                                           tokens[:, t:t + 1], pos, caches)
        all_logits.append(logits[:, 0])
        pos = pos + 1
    return torch.stack(all_logits, dim=1), ServeState(caches, pos,
                                                      tokens[:, -1:])


@torch.inference_mode()
def prefill_step(cfg: ModelConfig, run: RunConfig, params: dict,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward — what the prefill_32k dry-run shape lowers."""
    with obs.span("prefill"):
        obs.count("tokens", batch["tokens"].numel())
        logits, _ = model_forward(cfg, run, params, batch)
    return logits


@torch.inference_mode()
def serve_step(cfg: ModelConfig, run: RunConfig, params: dict,
               tokens: torch.Tensor, position: torch.Tensor, caches: dict,
               *, greedy: bool = True, temperature: float = 1.0,
               rng: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step for the whole batch: (B,1) token in, (B,1) token out.
    Sampling (``greedy=False``) draws from ``rng``, a ``torch.Generator``
    on the logits' device."""
    logits, caches = model_decode_step(cfg, run, params, tokens, position,
                                       caches)
    logits = logits[:, 0]                       # (B, V)
    if greedy:
        nxt = torch.argmax(logits, dim=-1)
    else:
        if rng is None:
            raise ValueError("sampling needs rng=: a torch.Generator on the "
                             "logits' device")
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
    return nxt[:, None].to(torch.int32), caches


@torch.inference_mode()
def generate(cfg: ModelConfig, run: RunConfig, params: dict, prompt,
             max_new_tokens: int, max_len: Optional[int] = None
             ) -> torch.Tensor:
    """Greedy generation on the parameters' device: prefill the prompt then
    decode autoregressively.  Returns (B, max_new_tokens) int32."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    B, S = prompt.shape
    max_len = max_len or (S + max_new_tokens)
    state = init_serve_state(cfg, B, max_len, device=dev)
    _, state = prefill(cfg, run, params, {"tokens": prompt}, state)
    tok, pos, caches = state.last_tokens, state.position, state.caches
    out = []
    for _ in range(max_new_tokens):
        tok, caches = serve_step(cfg, run, params, tok, pos, caches)
        pos = pos + 1
        out.append(tok[:, 0])
    return torch.stack(out, dim=1)
