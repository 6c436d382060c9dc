"""Data pipeline: per-learner sharded sampling with background prefetch
(counterpart of ``repro/data/pipeline.py``).

Mirrors the paper's Data Server (§3.2): each learner has an I/O thread that
prefetches the next mini-batch via random sampling, overlapped with
compute.  Here the "global file system" is a synthetic generator (numpy,
bitwise the reference's batches); the prefetch is a real double-buffered
background thread, and the consumer moves each batch to the device it was
given.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import lm_token_stream


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int,
                  seed: int = 0) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns step -> batch dict (numpy) matching the model's input
    layout."""

    def fn(step: int) -> Dict[str, np.ndarray]:
        if cfg.frontend == "audio":
            rng = np.random.default_rng(seed * 7919 + step)
            frames = rng.normal(0, 1, (batch, seq, cfg.d_model)
                                ).astype(np.float32)
            labels = rng.integers(0, cfg.vocab_size, (batch, seq)
                                  ).astype(np.int32)
            return {"frames": frames, "labels": labels,
                    "loss_mask": np.ones((batch, seq), np.float32)}
        if cfg.frontend == "vision":
            npfx = cfg.n_prefix_embeds
            rng = np.random.default_rng(seed * 7919 + step)
            b = lm_token_stream(cfg.vocab_size, batch, seq - npfx,
                                seed=seed, step=step)
            patches = rng.normal(0, 1, (batch, npfx, cfg.d_model)
                                 ).astype(np.float32)
            # labels over the full fused sequence; prefix positions masked out
            labels = np.concatenate(
                [np.zeros((batch, npfx), np.int32), b["labels"]], axis=1)
            mask = np.concatenate(
                [np.zeros((batch, npfx), np.float32), b["loss_mask"]], axis=1)
            return {"patches": patches, "tokens": b["tokens"],
                    "labels": labels, "loss_mask": mask}
        return lm_token_stream(cfg.vocab_size, batch, seq,
                               seed=seed, step=step)

    return fn


class PrefetchIterator:
    """Double-buffered background prefetch (the paper's I/O thread).

    ``device``: where the batches land (tensors), or None to yield the
    numpy batches as ``batch_fn`` made them."""

    def __init__(self, batch_fn: Callable[[int], Dict], steps: int,
                 prefetch: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._steps = steps
        self._device = None if device is None else resolve_device(device)
        self._thread = threading.Thread(
            target=self._worker, args=(batch_fn,), daemon=True)
        self._thread.start()

    def _worker(self, batch_fn):
        for step in range(self._steps):
            self._q.put(batch_fn(step))
        self._q.put(None)

    def __iter__(self) -> Iterator[Dict]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._device is not None:
                item = {k: torch.as_tensor(v, device=self._device)
                        for k, v in item.items()}
            yield item


def shard_batch_for_learner(batch: Dict[str, np.ndarray], learner: int,
                            n_learners: int) -> Dict[str, np.ndarray]:
    """Split a global batch into the per-learner μ-sized slice."""
    def slc(x):
        per = x.shape[0] // n_learners
        return x[learner * per:(learner + 1) * per]
    return {k: slc(v) for k, v in batch.items()}
