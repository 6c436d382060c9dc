"""Competing staleness-control baselines from the paper's related work (§6;
counterpart of ``repro/core/baselines.py``).

* **SSP** — Stale Synchronous Parallel (Ho et al. 2013 / Cui et al. 2014):
  asynchronous PS, but a learner whose clock is more than ``slack`` ahead
  of the slowest learner BLOCKS until the laggard catches up.
* **EASGD** — Elastic Averaging SGD (Zhang et al. 2014): learners keep
  local weights x_l and interact with a center x̃ through an elastic
  penalty:  x_l ← x_l − η∇f(x_l) − α(x_l − x̃);  x̃ ← x̃ + α Σ_l (x_l − x̃).
* **Accrual (Downpour npush)** — learners sum ``npush`` local gradients
  before pushing (DistBelief's npush knob); the PS is the host PS of
  ``core/protocols.py``, so on a card every update is a ``ps_apply``
  kernel launch.

All three reuse the event-queue machinery of ``core/simulator.py`` (same
durations, same data order, same clocks as the reference), take
``device=`` (default ``"cuda"``; without a card they raise unless asked for
``"cpu"``) and move the initial parameters and every minibatch there.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.core.clock import VectorClockLog
from repro_torch.core.engine import resolve_device
from repro_torch.core.lr_policies import make_lr_policy
from repro_torch.core.protocols import ParameterServerState
from repro_torch.core.simulator import (SimResult, _default_duration_sampler,
                                        on_device)
from repro_torch.optim import sgd_step
from repro_torch.optim.flatten import tree_map


# ---------------------------------------------------------------------------
# SSP
# ---------------------------------------------------------------------------
def simulate_ssp(run: RunConfig, *, steps: int, slack: int,
                 grad_fn: Optional[Callable] = None,
                 init_params=None, batch_fn: Optional[Callable] = None,
                 duration_sampler: Callable = _default_duration_sampler,
                 device="cuda") -> SimResult:
    """SSP: async PS (c = 1) where a learner with local clock > min_clock +
    slack blocks until the slowest learner advances.  Blocking is modelled
    by re-queueing the fast learner at the laggard's next completion time.
    The result carries ``stalls``, the number of blocked wake-ups."""
    dev = resolve_device(device)
    lam = run.n_learners
    rng = np.random.default_rng(run.seed)
    lr_policy = make_lr_policy(run)
    log = VectorClockLog()
    sgd = grad_fn is not None

    params = on_device(init_params, dev) if sgd else init_params
    pulled_ts = [0] * lam
    pulled_params: List = [params] * lam
    local_clock = [0] * lam
    done_mb = [0] * lam
    next_time = [0.0] * lam
    heap = []
    for i in range(lam):
        next_time[i] = duration_sampler(rng, run.minibatch)
        heapq.heappush(heap, (next_time[i], i, i))
    timestamp = 0
    updates = mb = 0
    t = 0.0
    stalls = 0
    while updates < steps:
        t, tb, li = heapq.heappop(heap)
        if local_clock[li] > min(local_clock) + slack:
            # blocked: sleep until the LAGGARD finishes its in-flight
            # minibatch (re-queueing any earlier would livelock)
            stalls += 1
            lag = min(range(lam), key=lambda j: local_clock[j])
            wake = max(next_time[lag], t) + 1e-9
            next_time[li] = wake
            heapq.heappush(heap, (wake, tb + lam * 1000, li))
            continue
        mb += 1
        if sgd:
            grad = grad_fn(pulled_params[li],
                           on_device(batch_fn(li, done_mb[li]), dev))
            lr = lr_policy(timestamp, [pulled_ts[li]])
            if isinstance(lr, list):
                lr = lr[0]
            params = sgd_step(params, grad, lr)
        timestamp += 1
        updates += 1
        log.record(timestamp, [pulled_ts[li]])
        done_mb[li] += 1
        local_clock[li] += 1
        pulled_ts[li] = timestamp
        pulled_params[li] = params
        next_time[li] = t + duration_sampler(rng, run.minibatch)
        heapq.heappush(heap, (next_time[li], mb + lam, li))
    res = SimResult(log, updates, t, mb, params if sgd else None)
    res.stalls = stalls      # type: ignore[attr-defined]
    return res


# ---------------------------------------------------------------------------
# EASGD
# ---------------------------------------------------------------------------
def simulate_easgd(run: RunConfig, *, steps: int, rho: float = 0.1,
                   comm_every: int = 1,
                   grad_fn: Callable = None, init_params=None,
                   batch_fn: Callable = None,
                   duration_sampler: Callable = _default_duration_sampler,
                   device="cuda") -> SimResult:
    """Asynchronous EASGD: each learner does local SGD on its own replica
    and every ``comm_every`` minibatches performs the elastic exchange with
    the center.  ``rho`` is the elastic coefficient (α = η·ρ in the paper's
    notation, folded)."""
    dev = resolve_device(device)
    lam = run.n_learners
    rng = np.random.default_rng(run.seed)
    log = VectorClockLog()
    eta = run.base_lr

    center = on_device(init_params, dev)
    local = [center] * lam
    done_mb = [0] * lam
    since_comm = [0] * lam
    heap = []
    for i in range(lam):
        heapq.heappush(heap, (duration_sampler(rng, run.minibatch), i, i))
    updates = mb = 0
    t = 0.0
    center_ts = 0
    pulled_ts = [0] * lam
    while updates < steps:
        t, _, li = heapq.heappop(heap)
        mb += 1
        grad = grad_fn(local[li], on_device(batch_fn(li, done_mb[li]), dev))
        local[li] = sgd_step(local[li], grad, eta)
        done_mb[li] += 1
        since_comm[li] += 1
        if since_comm[li] >= comm_every:
            since_comm[li] = 0
            diff = tree_map(lambda x, c: x - c, local[li], center)
            local[li] = tree_map(lambda x, d: x - rho * d, local[li], diff)
            center = tree_map(lambda c, d: c + rho * d, center, diff)
            center_ts += 1
            updates += 1
            log.record(center_ts, [pulled_ts[li]])
            pulled_ts[li] = center_ts
        heapq.heappush(heap, (t + duration_sampler(rng, run.minibatch),
                              mb + lam, li))
    return SimResult(log, updates, t, mb, center)


# ---------------------------------------------------------------------------
# Downpour-style gradient accrual (npush)
# ---------------------------------------------------------------------------
def simulate_accrual(run: RunConfig, *, steps: int, npush: int,
                     grad_fn: Callable = None, init_params=None,
                     batch_fn: Callable = None,
                     duration_sampler: Callable = _default_duration_sampler,
                     device="cuda") -> SimResult:
    """Each learner locally SUMS npush gradients (all computed at its
    pulled weights) before pushing — DistBelief's npush.  The paper's §3.3
    claim: this is effectively a μ·npush minibatch.  Protocol at the PS is
    1-softsync over the accrued pushes."""
    dev = resolve_device(device)
    lam = run.n_learners
    rng = np.random.default_rng(run.seed)
    lr_policy = make_lr_policy(run)
    log = VectorClockLog()
    ps = ParameterServerState(on_device(init_params, dev), c=lam,
                              optimizer="sgd")
    pulled = [(ps.params, 0)] * lam
    acc: List = [None] * lam
    acc_count = [0] * lam
    done_mb = [0] * lam
    heap = []
    for i in range(lam):
        heapq.heappush(heap, (duration_sampler(rng, run.minibatch), i, i))
    updates = mb = 0
    t = 0.0
    while updates < steps:
        t, _, li = heapq.heappop(heap)
        mb += 1
        p, ts = pulled[li]
        g = grad_fn(p, on_device(batch_fn(li, done_mb[li]), dev))
        done_mb[li] += 1
        acc[li] = g if acc[li] is None else tree_map(
            lambda a, b: a + b, acc[li], g)
        acc_count[li] += 1
        if acc_count[li] >= npush:
            mean_g = tree_map(lambda x: x / npush, acc[li])
            clocks = ps.push_gradient(mean_g, ts, lr_policy)
            acc[li], acc_count[li] = None, 0
            if clocks is not None:
                updates += 1
                log.record(ps.timestamp, clocks)
            pulled[li] = (ps.params, ps.timestamp)
        heapq.heappush(heap, (t + duration_sampler(rng, run.minibatch),
                              mb + lam, li))
    return SimResult(log, updates, t, mb, ps.params)
