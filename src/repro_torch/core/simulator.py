"""Event-driven parameter-server simulator — the per-arrival oracle
(counterpart of ``repro/core/simulator.py``).

λ learners with stochastic compute durations push gradients into a
priority queue; the PS fires an update every ``c = ⌊λ/n⌋`` arrivals
(n-softsync), on every arrival (async), or at a barrier (hardsync).
Timestamps and vector clocks follow paper §3.1 exactly, with the
reference's random draws and heap tie-breaks, so the clocks and the
simulated time equal the reference's bit for bit.

Two modes:

* **measure** — gradients are tokens; only clocks are tracked.  This is
  the schedule pass of the replay engine (``core/trace.py``).
* **sgd** — each learner holds the weight copy it pulled and computes a
  real gradient on its own minibatch against *those* weights; the host PS
  (``core/protocols.ParameterServerState``) applies Eqs. 3–5 with the
  configured LR policy, by default through ONE ``ps_apply`` kernel launch
  per update (``kernels/ps_update.py``).

The sgd mode is the **legacy per-arrival loop**: one ``grad_fn`` call per
gradient and one optimizer dispatch per update, driven from the host.  It
is the oracle the replay engine (``core/engine.py``) is held against.  It
models the flat, static Rudra-base server only: sharded/grouped topologies,
elastic membership and the serving lane are rejected here.

Device: ``simulate`` takes ``device=`` and defaults to ``"cuda"``; without
a card it raises unless asked for ``"cpu"``.  The initial parameters and
every minibatch (numpy from ``batch_fn``) go to that device; ``grad_fn``
and ``eval_fn`` receive tensors there.  The loop reads nothing back from
the device per arrival: only ``eval_fn`` syncs.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.core import trace as trace_mod
from repro_torch.core.clock import VectorClockLog
from repro_torch.core.lr_policies import make_lr_policy
from repro_torch.core.protocols import ParameterServerState
from repro_torch.optim.flatten import tree_map


@dataclasses.dataclass
class LearnerState:
    index: int
    pulled_timestamp: int = 0
    params: Optional[object] = None      # the weight copy it pulled (sgd)
    minibatches_done: int = 0


@dataclasses.dataclass
class SimResult:
    clock_log: VectorClockLog
    updates: int
    simulated_time: float
    minibatches: int
    params: Optional[object] = None
    history: Optional[List[Dict]] = None   # eval trace (sgd mode)
    # train-while-serve result (the replay's serving lane)
    serving: Optional[object] = None


def _default_duration_sampler(rng: np.random.Generator, mu: int):
    """Legacy (rng, mu) alias of the homogeneous sampler in ``core/trace``."""
    return trace_mod.base_duration(rng, mu)


def on_device(tree, device: torch.device):
    """Numpy arrays / tensors in a dict, tuple or list (or a bare one) as
    tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x, device=device), tree)


def simulate(run: RunConfig,
             *,
             steps: int,
             grad_fn: Optional[Callable] = None,
             init_params: Optional[object] = None,
             batch_fn: Optional[Callable] = None,
             eval_fn: Optional[Callable] = None,
             eval_every: int = 0,
             duration_sampler: Optional[Callable] = None,
             ps_backend: str = "pallas",
             device="cuda",
             ) -> SimResult:
    """Run the PS simulation for ``steps`` weight updates on ``device``.

    measure mode: leave ``grad_fn`` None.
    sgd mode: provide ``grad_fn(params, batch) -> grads`` (one minibatch,
    no slot axis), ``init_params`` (a dict of tensors or arrays, or a bare
    one) and ``batch_fn(learner_idx, minibatch_idx) -> batch``.
    ``duration_sampler`` defaults to the model selected by
    ``run.duration_model``; 2-arg ``(rng, mu)`` callables are accepted.
    ``ps_backend`` picks the ``repro_torch.optim`` backend of the host PS
    ("pallas": the ``ps_apply`` kernel).
    """
    from repro_torch.core.engine import resolve_device   # lazy: no cycle
    dev = resolve_device(device)
    if run.serving is not None and grad_fn is not None:
        raise ValueError(
            "the legacy per-arrival oracle has no serving lane; replay a "
            "serving trace on the compiled engine (engine='compiled' / "
            "core.engine.replay)")
    if grad_fn is None:                       # measure mode == the schedule
        tr = trace_mod.schedule(run, steps, duration_sampler=duration_sampler)
        return SimResult(tr.clock_log(), tr.steps, tr.simulated_time,
                         tr.minibatches)

    lam = run.n_learners
    rng = np.random.default_rng(run.seed)
    sampler = trace_mod.as_learner_sampler(
        duration_sampler or trace_mod.make_duration_sampler(run))
    lr_policy = make_lr_policy(run)
    log = VectorClockLog()
    # everything below is sgd mode: real gradients through the unified PS
    ps = ParameterServerState.from_run(on_device(init_params, dev), run,
                                       backend=ps_backend)

    def gradient(params, learner: int, minibatch: int):
        return grad_fn(params, on_device(batch_fn(learner, minibatch), dev))

    # ---------------- hardsync: barrier rounds -----------------------------
    if run.protocol == "hardsync":
        # a barrier round is "the PS fires after all λ arrivals": the same
        # unified applyUpdate as softsync, with c = λ
        t = 0.0
        history = []
        mb = 0
        for step in range(steps):
            durations = [sampler(rng, run.minibatch, l) for l in range(lam)]
            t += max(durations)                       # barrier
            params0 = ps.params
            for l in range(lam):
                ps.push_gradient(gradient(params0, l, step), step, lr_policy)
            mb += lam
            log.record(step + 1, [step] * lam)        # σ = 0 by construction
            if eval_fn and eval_every and (step + 1) % eval_every == 0:
                history.append({"update": step + 1, "time": t,
                                **eval_fn(ps.params)})
        return SimResult(log, steps, t, mb, ps.params, history)

    # ---------------- softsync / async: event queue -------------------------
    learners = [LearnerState(i) for i in range(lam)]
    for l in learners:
        l.params = ps.params
    # event heap: (push_completion_time, tiebreak, learner_idx)
    heap = []
    for l in learners:
        heapq.heappush(heap, (sampler(rng, run.minibatch, l.index),
                              l.index, l.index))
    updates = 0
    mb = 0
    t = 0.0
    history = []

    while updates < steps:
        t, _, li = heapq.heappop(heap)
        learner = learners[li]
        mb += 1
        grad = gradient(learner.params, li, learner.minibatches_done)
        clocks = ps.push_gradient(grad, learner.pulled_timestamp, lr_policy)
        learner.minibatches_done += 1
        if clocks is not None:
            updates += 1
            log.record(ps.timestamp, clocks)
            if eval_fn and eval_every and updates % eval_every == 0:
                history.append({"update": updates, "time": t,
                                **eval_fn(ps.params)})
        # pullWeights: the learner picks up the current weights + timestamp
        # (every update makes new tensors, so the copy it held before stays
        # the stale snapshot it computed on)
        learner.params = ps.params
        learner.pulled_timestamp = ps.timestamp
        heapq.heappush(
            heap, (t + sampler(rng, run.minibatch, li), mb + lam, li))

    return SimResult(log, updates, t, mb, ps.params, history)
