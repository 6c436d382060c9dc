"""The n-softsync arrival schedule, rewritten from the protocol and the
duration model (Rudra's parameter server; the paper's §3 and Eq. 5).

λ learners each compute a minibatch of μ samples, push the gradient and
pull the weights again.  The parameter server fires an update once
c = ⌊λ/n⌋ gradients have arrived; a learner that pushes picks up the
timestamp of the weights as they are after its push.  Compute times are
homogeneous: (0.5 + μ·0.01 / (μ/(μ+8))) seconds times a lognormal jitter of
σ 0.05, drawn from ``numpy.random.default_rng(seed)`` in dispatch order
(all learners at time 0 in learner order, then each learner as it pushes).
Arrivals are taken in time order; equal times go to the earlier dispatch.
"""

from __future__ import annotations

import heapq
from typing import Dict

import numpy as np


def nsoftsync(seed: int, n_learners: int, n_softsync: int, minibatch: int,
              steps: int) -> Dict[str, np.ndarray]:
    """``pulled`` (steps, c): the timestamp of the weights each folded
    gradient was computed from, in arrival order; ``times`` (steps,): the
    simulated time each update fired."""
    rng = np.random.default_rng(seed)
    mu = minibatch
    c = max(1, n_learners // n_softsync)

    def duration() -> float:
        base = 0.5 + mu * 0.01 / (mu / (mu + 8.0))
        return base * rng.lognormal(mean=0.0, sigma=0.05)

    heap = []
    for p in range(n_learners):
        heapq.heappush(heap, (0.0 + duration(), p, p))
    pulled = np.zeros((steps, c), np.int64)
    times = np.zeros(steps)
    weights_ts = [0] * n_learners
    ts, slot, arrivals = 0, 0, 0
    while ts < steps:
        t, _, p = heapq.heappop(heap)
        arrivals += 1
        pulled[ts, slot] = weights_ts[p]
        slot += 1
        if slot == c:
            times[ts] = t
            ts += 1
            slot = 0
        weights_ts[p] = ts
        heapq.heappush(heap, (t + duration(), arrivals + n_learners, p))
    return {"pulled": pulled, "times": times}


def statistics(sched: Dict[str, np.ndarray]) -> Dict:
    """What a replay reports of its schedule: ring size, staleness mean,
    max and histogram, updates, minibatches, simulated time."""
    pulled = sched["pulled"]
    steps, c = pulled.shape
    sigma = np.arange(steps)[:, None] - pulled
    vals = sigma.reshape(-1)
    top = int(vals.max())
    hist = np.bincount(vals, minlength=top + 1) / len(vals)
    return {"ring_buffer_K": top + 1, "mean": float(vals.mean()),
            "max": float(top), "histogram": hist.tolist(),
            "updates": steps, "minibatches": steps * c,
            "simulated_time": float(sched["times"][-1])}
