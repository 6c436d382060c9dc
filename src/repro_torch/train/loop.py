"""Training loop: protocol-aware trainer over the round-based engines
(counterpart of ``repro/train/loop.py``).

One "round" of softsync = n PS update events (DESIGN.md §2); one hardsync
step = one update over the global batch.  The trainer draws the reference's
synthetic batches (``data/pipeline.py``, numpy), moves them to the device
in a prefetch thread's wake, and steps ``core/distributed.make_train_step``
on the model's loss (``models.model_loss``, autograd on the plain layers).
Runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.distributed import check_trainable, make_train_step
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import PrefetchIterator, make_batch_fn
from repro_torch.models import init_model, model_loss
from repro_torch.optim import init_state, spec_from_run


@dataclasses.dataclass
class TrainResult:
    params: object
    opt_state: object
    history: List[Dict]
    steps: int
    wallclock: float


def train(cfg: ModelConfig, run: RunConfig, *, steps: int,
          batch: int, seq: int, engine: str = "sequential",
          eval_every: int = 0,
          eval_fn: Optional[Callable] = None,
          params=None,
          warmstart_steps: int = 0,
          log: Optional[Callable[[str], None]] = None,
          device="cuda") -> TrainResult:
    """Train ``steps`` rounds of the configured protocol on synthetic data.

    ``params``: a parameter tree on ``device`` (default: ``init_model``
    seeded by ``run.seed``; the reference's ``jax.random`` draw is not
    reproduced, so carry its weights across to compare).
    ``warmstart_steps`` implements the paper's §5.5 strategy: initialize a
    softsync run from hardsync training (the paper warm-starts ImageNet
    1-softsync from 1 hardsync epoch to stabilize AdaGrad).  ``wallclock``
    ends with a device synchronisation."""
    dev = resolve_device(device)
    check_trainable(run)
    if params is None:
        params = init_model(cfg, run.seed, device=dev)
    opt = init_state(spec_from_run(run), params)

    def loss_fn(p, b, sample_weights=None):
        return model_loss(cfg, run, p, b, sample_weights=sample_weights)

    if warmstart_steps and run.protocol != "hardsync":
        warm_run = dataclasses.replace(run, protocol="hardsync",
                                       lr_policy="sqrt_scale")
        warm = train(cfg, warm_run, steps=warmstart_steps, batch=batch,
                     seq=seq, eval_every=0, params=params, log=log,
                     device=dev)
        params = warm.params
        if log:
            log(f"warm-start: {warmstart_steps} hardsync rounds done")

    step_fn = make_train_step(run, loss_fn, engine=engine)
    batch_fn = make_batch_fn(cfg, batch, seq, seed=run.seed)
    it = iter(PrefetchIterator(batch_fn, steps, device=dev))

    history: List[Dict] = []
    t0 = time.perf_counter()
    for step, b in enumerate(it):
        params, opt, metrics = step_fn(params, opt, b)
        if eval_every and (step + 1) % eval_every == 0:
            entry = {"step": step + 1,
                     "loss": float(metrics["loss"]),
                     "ce": float(metrics["ce"])}
            if eval_fn is not None:
                entry.update(eval_fn(params))
            history.append(entry)
            if log:
                log(f"step {step+1}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in entry.items() if k != "step"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return TrainResult(params, opt, history, steps, wall)
