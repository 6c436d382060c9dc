"""Continuous batching (counterpart of ``repro/serve/scheduler.py``):
requests enter and leave the decode batch at any step, each sequence at its
own depth (per-sequence positions and cache lengths — see
``models.attention.cache_insert`` / ``decode_attention``).

The engine keeps a fixed-size slot array:

  * ``submit()`` queues a prompt;
  * free slots are filled by prefilling the prompt at batch 1 and scattering
    the resulting caches into the slot (every cache leaf has the batch on
    axis 1 of the stacked cache tree);
  * ``step()`` decodes ONE token for every active slot with a single batched
    decode step; finished sequences free their slot for the queue.

It runs eagerly.  ``step()`` waits for the card once, for the argmax that
the host's bookkeeping reads (the reference's ``np.asarray``); the token and
position vectors go up through pinned memory without a wait.  Caches are
written in place, the slot scatter too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import init_caches, model_decode_step
from repro_torch.serve.engine import init_serve_state, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _scatter_slot(big, small, slot: int):
    """Write a batch-1 cache tree into batch slot ``slot`` of the engine's
    stacked caches (every leaf: (units, B, ...)), in place; returns
    ``big``."""
    if isinstance(big, dict):
        for k in big:
            _scatter_slot(big[k], small[k], slot)
        return big
    big[:, slot:slot + 1].copy_(small)
    return big


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the card: the values are
    copied into pinned memory at once, so the caller may change ``arr``."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t.clone()
    return t.pin_memory().to(dev, non_blocking=True)


class ContinuousBatchingEngine:
    def __init__(self, cfg: ModelConfig, run: RunConfig, params,
                 max_batch: int = 8, max_len: int = 256,
                 eos_id: Optional[int] = None):
        self.cfg, self.run, self.params = cfg, run, params
        self.max_batch, self.max_len, self.eos_id = max_batch, max_len, eos_id
        self.device = params["embed"].device
        self.caches = init_caches(cfg, max_batch, max_len,
                                  device=self.device)
        self.positions = np.zeros((max_batch,), np.int32)
        self.last_tokens = np.zeros((max_batch, 1), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._next_rid = 0
        self.completed: Dict[int, Request] = {}

    # ---- request lifecycle -------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            # batch-1 prefill, then scatter the caches into the slot
            state = init_serve_state(self.cfg, 1, self.max_len,
                                     device=self.device)
            prompt = _upload(np.asarray([req.prompt], np.int32), self.device)
            _, state = prefill(self.cfg, self.run, self.params,
                               {"tokens": prompt}, state)
            _scatter_slot(self.caches, state.caches, slot)
            self.positions[slot] = len(req.prompt)
            self.last_tokens[slot, 0] = req.prompt[-1]
            self.slot_req[slot] = req

    # ---- one decode step for the whole batch --------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Admit, decode one token for every active slot; returns number of
        active sequences this step."""
        self._admit()
        active = [s for s in range(self.max_batch)
                  if self.slot_req[s] is not None]
        if not active:
            return 0
        logits, self.caches = model_decode_step(
            self.cfg, self.run, self.params,
            _upload(self.last_tokens, self.device),
            _upload(self.positions, self.device), self.caches)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.generated.append(tok)
            self.positions[s] += 1
            self.last_tokens[s, 0] = tok
            if (len(req.generated) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self.positions[s] >= self.max_len):
                req.done = True
                self.completed[req.rid] = req
                self.slot_req[s] = None
                self.positions[s] = 0
        return len(active)

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.completed
