"""The trace-driven what-if replay, written from its definition, over a
subset of the parameter server's columns.

The problem is the diagonal quadratic ½·mean(a·(w − w*)²) over D columns,
with column i's curvature a = 0.5 + ((i + 37·s) mod 1000)/1000 and target
w* = sin(10⁻³·i + s), in fp32 (i rounded to fp32), for the problem seed s.

The server keeps the weights as a ring of K snapshots, the snapshot of
timestamp t in row t mod K, stored in the ring's dtype; with a bf16 ring
an fp32 residue carries what the stored row lost, so the weights entering
an update are the row plus the residue.  Update event j (timestamp j →
j+1) folds the c gradients of its slots, each a·(snapshot of the slot's
pulled timestamp − w*) with coefficient 1/c, summed in arrival order
(ĝ ← ĝ + (1/c)·gⱼ), then the optimizer event
(sgd: w − α·ĝ) and stores the result in row (j+1) mod K, and its rounding
loss in the residue.  Every column's arithmetic is its own, so the replay
of a subset of columns gives exactly those columns of the whole replay.

``arith="bf16"`` is the control: the event's fp32 arithmetic rounded to
bf16 after every operation, the bf16 residue dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.lowprec import round_bf16


def coefficients(cols: torch.Tensor, seed: int):
    """(a, w*) at the int64 column indices ``cols``."""
    i = cols.to(torch.float32)
    thousand = torch.full((), 1000.0, device=cols.device)
    a = 0.5 + torch.remainder(i + 37.0 * seed, 1000.0) / thousand
    return a, torch.sin(1e-3 * i + seed)


def replay(cols: torch.Tensor, pulled: np.ndarray, *, seed: int, lr: float,
           ring_dtype: str, arith: str = "fp32") -> torch.Tensor:
    """The final fp32 weights at ``cols`` after every event of the
    schedule ``pulled`` (steps, c), from w = 0, with sgd at rate ``lr``."""
    steps, c = pulled.shape
    sigma = np.arange(steps)[:, None] - pulled
    K = int(sigma.max()) + 1
    a, wstar = coefficients(cols, seed)
    rnd = round_bf16 if arith == "bf16" else (lambda x: x)
    store = torch.bfloat16 if ring_dtype == "bf16" else torch.float32
    n = cols.numel()
    ring = torch.zeros(K, n, dtype=store, device=cols.device)
    res = torch.zeros(n, device=cols.device)
    lr32 = float(np.float32(lr))
    coef = float(np.float32(1.0 / c))
    for j in range(steps):
        terms = {}                         # equal rows give equal terms
        for r in set((pulled[j] % K).tolist()):
            snap = ring[r].to(torch.float32)
            terms[r] = rnd(coef * rnd(a * rnd(snap - wstar)))
        g = torch.zeros(n, device=cols.device)
        for ts in pulled[j].tolist():      # the slots in arrival order
            g = rnd(g + terms[ts % K])
        w = ring[j % K].to(torch.float32)
        if arith != "bf16" and ring_dtype == "bf16":
            w = w + res
        w = rnd(w - rnd(lr32 * g))
        q = w.to(store)
        ring[(j + 1) % K] = q
        res = w - q.to(torch.float32)
    w = ring[steps % K].to(torch.float32)
    if arith != "bf16" and ring_dtype == "bf16":
        w = w + res
    return w


def sample_columns(D: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` distinct columns of D drawn from the seed, sorted, with
    the first and the last column among them."""
    rng = np.random.default_rng([seed, 0x5A3])
    picks = rng.choice(D - 2, size=count - 2, replace=False) + 1
    cols = np.concatenate([[0], np.sort(picks), [D - 1]]).astype(np.int64)
    return torch.from_numpy(cols).to(device)


def w_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap between the program's and the reference's weights,
    as a share of the reference's largest weight."""
    scale = float(reference.abs().max().clamp_min(1e-30))
    return float((program - reference).abs().max()) / scale
