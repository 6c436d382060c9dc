"""The round engines' event semantics, written from the protocol's
description (Rudra's n-softsync, realised as rounds in one process).

softsync, the sequential engine: a round splits the global batch along its
rows into n learner groups of equal size; every group's gradient is taken
at the round-start weights θ(i); the n optimizer events then apply in group
order, each with its own learning rate (``staleness_inverse``: α₀/⟨σ⟩ with
⟨σ⟩ = max(1, (n−1)/2), the mean staleness of a round's events;
``const``: α₀), each rounded to fp32.  hardsync: one event a round over the
mean gradient of the whole batch, at α₀.

Momentum: v ← m·v + g, θ ← θ − α·v, in fp32.  The rounds come in
segments, one for each call of the trainer, and the velocity starts at 0
at the start of every segment, as each call starts its optimizer state.
The trainer logs one loss a round: hardsync's is the loss of the whole
batch, softsync's the last event's.

The readings the benchmark compares are taken here as the program's
readings are taken: every round's logged loss, the velocity after the
first round (the first gradients as the optimizer holds them), and θ
after the last round less the initial θ, each as a norm per leaf slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch


def event_lrs(protocol: str, n: int, lr_policy: str,
              base_lr: float) -> List[float]:
    if protocol == "hardsync":
        return [float(np.float32(base_lr))]
    if lr_policy == "staleness_inverse":
        lr = base_lr / max(1.0, (n - 1) / 2.0)
    elif lr_policy == "const":
        lr = base_lr
    else:
        raise ValueError(f"lr_policy {lr_policy!r} is not in the reference")
    return [float(np.float32(lr))] * n


def _rows(batch: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def slice_norms(tree: Dict[str, torch.Tensor],
                stacked: Callable[[str], bool]) -> Dict[str, float]:
    """‖x‖₂ in float64 per leaf, per unit slice of a stacked leaf."""
    out = {}
    for name, x in tree.items():
        parts = x.unbind(0) if stacked(name) else (x,)
        for i, p in enumerate(parts):
            key = f"{name}[{i}]" if stacked(name) else name
            out[key] = float(torch.linalg.vector_norm(p, dtype=torch.float64))
    return out


def run_rounds(weights: Dict[str, torch.Tensor],
               segments: List[List[Dict]], loss_and_grad: Callable,
               initial: Callable[[str], torch.Tensor], *, protocol: str,
               n: int, lr_policy: str, base_lr: float, momentum: float,
               block_rows: int, stacked: Callable[[str], bool]) -> Dict:
    """Train the rounds of ``segments`` (lists of batches, the velocity
    restarting at each) from fp32 ``weights`` (consumed).
    ``loss_and_grad(weights, rows) -> (loss, grads)`` over a block of
    rows; hardsync's whole-batch gradient is the mean over equal blocks of
    ``block_rows`` rows (the loss is a mean over equal token counts).
    ``initial(name)`` draws a leaf of the initial weights again, in fp32,
    so that the change is read without a second copy of the model.
    Returns each round's logged loss and the two readings."""
    theta = weights
    lrs = event_lrs(protocol, n, lr_policy, base_lr)
    losses, first_grad = [], None
    for batches in segments:
        vel = {k: torch.zeros_like(v) for k, v in theta.items()}
        for batch in batches:
            theta = _round(theta, vel, batch, loss_and_grad, losses, lrs,
                           protocol=protocol, n=n, momentum=momentum,
                           block_rows=block_rows)
            if first_grad is None:
                first_grad = slice_norms(vel, stacked)
        del vel
    change = {}
    for k in list(theta):
        change.update(slice_norms({k: theta.pop(k).sub_(initial(k))},
                                  stacked))
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _round(theta, vel, batch, loss_and_grad, losses, lrs, *, protocol, n,
           momentum, block_rows):
    """One round in place of ``vel``; returns the new θ and appends the
    round's logged loss to ``losses``."""
    rows = batch["tokens"].shape[0]
    if protocol == "hardsync":
        groups = [[(lo, lo + block_rows)
                   for lo in range(0, rows, block_rows)]]
    else:
        per = rows // n
        groups = [[(j * per, (j + 1) * per)] for j in range(n)]
    theta0 = theta
    event_losses = []
    for j, blocks in enumerate(groups):
        g, l_sum = None, 0.0
        for lo, hi in blocks:
            loss, gb = loss_and_grad(theta0, _rows(batch, lo, hi))
            l_sum = l_sum + float(loss)
            if g is None:
                g = gb
            else:
                for k in g:
                    g[k].add_(gb[k])
            del gb
        if len(blocks) > 1:
            for k in g:
                g[k].div_(len(blocks))
        event_losses.append(l_sum / len(blocks))
        for k in vel:
            vel[k].mul_(momentum).add_(g[k])
        del g
        if j == 0:           # θ(i) stays the round-start weights
            theta = {k: theta0[k] - lrs[j] * vel[k] for k in theta0}
        else:
            for k in theta:
                theta[k].sub_(lrs[j] * vel[k])
    losses.append(event_losses[-1])
    return theta
