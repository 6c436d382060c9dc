"""Replay pass of the port (counterpart of ``repro/core/engine.py``).

Given the :class:`ArrivalTrace` the schedule pass produced (``core/trace.py``),
execute every update event against a device-resident (K, D) weight ring in
the ``optim.flatten`` layout, ``K = trace.max_staleness + 1``: the snapshot
of timestamp ``ts`` lives in row ``ts % K``.  Event j

* gathers its c pulled rows (``ring[ts % K]``, fp32 — with a bf16 ring the
  gradients see the quantized snapshots), computes the c gradients at once
  (the problem's ``grad_fn`` takes an explicit leading slot dimension), and
* applies ONE ring event through ``kernels.replay_ring.ring_apply``: read
  row ``j % K`` (+ the fp32 error-feedback residue of a bf16 ring), combine
  or sequential optimizer event, write row ``(j + 1) % K`` in place.

The what-if body (``flat_grad=("quadratic", a, w*)``) computes the
gradients gⱼ = a ⊙ (ring[tsⱼ] − w*) inside ``ring_apply_whatif`` instead, so
no data is staged and the (c, D) matrices never exist.

``lax.scan`` becomes a Python loop.  The whole trace's ring indices, LRs and
staged minibatches go to the device ONCE before the loop (``_trace_xs``);
the loop indexes them as device tensors and never synchronizes with the
host, so a later version can capture a segment as one CUDA graph.  Host
syncs happen only at ``eval_every`` segment ends.

Ported scope: single placement, trivial topology (S = 1, gs = 1), fp32 and
bf16 rings, combine and sequential modes, sgd / momentum / adagrad, eval
segments and the what-if body.  The rest raises ``NotImplementedError``
naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.config import RunConfig
from repro_torch.core.lr_policies import resolve_trace_lrs
from repro_torch.core.protocols import init_ps_state
from repro_torch.core.simulator import SimResult, on_device
from repro_torch.core.topology import Topology
from repro_torch.core.trace import ArrivalTrace
from repro_torch.kernels import replay_ring
from repro_torch.optim import backends, flatten


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA request on a host without a
    card raises — the port never quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False: "
            f"the port runs on a CUDA card; pass device='cpu' to run the "
            f"plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: expected "
                         f"'cuda' or 'cpu'")
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1 "
        f"item {item}); run it on the reference package repro")


def _index(tree, j):
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, j) for v in tree)
    return tree[j]


def _materialize_batches(trace: ArrivalTrace, batch_fn: Callable):
    """``batch_fn(learner, minibatch_idx)`` for every trace slot, stacked
    host-side into numpy arrays with leading (steps, c) axes."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(stack([it[i] for it in items])
                               for i in range(len(first)))
        return np.stack([np.asarray(it) for it in items])

    rows = [stack([batch_fn(int(trace.learner[j, i]),
                            int(trace.mb_index[j, i]))
                   for i in range(trace.c)])
            for j in range(trace.steps)]
    return stack(rows)


def _check_trace(trace: ArrivalTrace, run: RunConfig) -> None:
    """A trace is only valid for the RunConfig that scheduled it."""
    if (trace.protocol != run.protocol
            or trace.n_learners != run.n_learners
            or trace.c != run.gradients_per_update):
        raise ValueError(
            f"trace ({trace.protocol}, λ={trace.n_learners}, c={trace.c}) "
            f"was not scheduled from this RunConfig ({run.protocol}, "
            f"λ={run.n_learners}, c={run.gradients_per_update})")
    topo = Topology.from_run(run)
    if trace.topology != topo:
        raise ValueError(
            f"trace topology ({trace.topology}) disagrees with this "
            f"RunConfig's ({topo}) — reschedule the trace for this config")
    want_lrs, want_mode = resolve_trace_lrs(run, trace.pulled_ts)
    if trace.mode != want_mode or not np.allclose(trace.lrs, want_lrs):
        raise ValueError(
            f"trace LRs/mode ({trace.mode}) disagree with this RunConfig's "
            f"lr_policy={run.lr_policy!r}/base_lr={run.base_lr} — reschedule "
            f"the trace for this config")
    if (trace.serving is None) != (run.serving is None):
        raise ValueError("trace and RunConfig disagree on the serving lane "
                         "— reschedule the trace for this config")


def _check_ported(trace: ArrivalTrace, run: RunConfig, impl: str) -> None:
    """Raise NotImplementedError for every part of the reference's replay
    that the port does not run yet."""
    if run.placement == "spmd":
        raise _not_ported("placement='spmd'", "8")
    if trace.serving is not None:
        raise _not_ported("the serving lane (run.serving)", "4.5")
    if trace.topology.shards > 1:
        raise _not_ported(f"a sharded PS (shards={trace.topology.shards})",
                          "4.5")
    if trace.group_size > 1:
        raise _not_ported(f"learner groups (group size "
                          f"{trace.group_size})", "4.5")
    if trace.elastic:
        raise _not_ported("elastic membership / backup masks", "4.4")
    if impl == "stock":
        raise _not_ported(f"the stock pytree body (ring_impl="
                          f"{run.ring_impl!r}, optimizer={run.optimizer!r}; "
                          f"adamw replays only there)", "4.2")


def _trace_xs(trace: ArrivalTrace, K: int, device: torch.device,
              batch_fn: Optional[Callable], batches) -> dict:
    """The loop inputs of one trace, moved to the device in one transfer
    each: ``idx`` (steps, 2 + c) int32 rows [prev, slot, ts_0 … ts_{c−1}]
    pre-wrapped mod K (the kernels' index operand; ``ts`` is its view),
    ``lrs`` (steps, c) fp32, and the staged minibatches (leading
    (steps, c) axes) when the body needs data."""
    steps = np.arange(trace.steps)
    idx = np.concatenate([(steps % K)[:, None], ((steps + 1) % K)[:, None],
                          trace.pulled_ts % K], axis=1).astype(np.int32)
    xs = {"idx": torch.as_tensor(idx, device=device),
          "lrs": torch.as_tensor(np.asarray(trace.lrs, np.float32),
                                 device=device)}
    xs["ts"] = xs["idx"][:, 2:]
    if batches is None and batch_fn is not None:
        batches = _materialize_batches(trace, batch_fn)
    if batches is not None:
        xs["batch"] = on_device(batches, device)
    return xs


def replay(trace: ArrivalTrace, run: RunConfig, *,
           grad_fn: Optional[Callable] = None,
           init_params,
           batch_fn: Optional[Callable] = None,
           batches=None,
           eval_fn: Optional[Callable] = None,
           eval_every: int = 0,
           flat_grad=None,
           device="cuda") -> SimResult:
    """Execute a scheduled trace against real gradients on ``device``.

    ``grad_fn(params, batch) -> grads`` takes parameters and a batch with a
    leading (c,) slot dimension and returns the c gradients (a dict with
    the same leading axis).  Minibatches come from exactly one of
    ``batch_fn`` (``(learner, minibatch_idx) -> batch``, numpy, per slot)
    or ``batches`` (pre-staged, leading (steps, c) axes).  ``init_params``
    is a dict of tensors (any device).

    ``run.ring_impl`` ``auto``/``pallas`` runs the ``kernels/replay_ring``
    wrappers (the CUDA kernels on a card, their plain versions on the CPU);
    ``fused`` runs the plain versions directly.  ``flat_grad = ("quadratic",
    a, w*)`` ((D,) fp32 tensors on ``device``) selects the what-if body in
    combine mode, as in the reference, at any K (hardsync's K = 1 too).

    With ``eval_every`` set, ``eval_fn(params) -> dict`` runs after every
    full segment of that many events (the only host syncs of the loop).
    """
    dev = resolve_device(device)
    _check_trace(trace, run)
    steps, c = trace.steps, trace.c
    K = trace.max_staleness + 1
    spec = optim.spec_from_run(run)
    impl = backends.resolve_ring_impl(run.ring_impl, spec)
    _check_ported(trace, run, impl)
    mode = trace.mode
    whatif = flat_grad is not None and mode == "combine"
    if whatif:
        if flat_grad[0] != "quadratic":
            raise ValueError(f"unknown flat_grad kind {flat_grad[0]!r}; "
                             f"expected ('quadratic', a, wstar)")
    elif grad_fn is None:
        raise ValueError("grad_fn is required outside the what-if replay")
    elif (batch_fn is None) == (batches is None):
        raise ValueError("pass exactly one of batch_fn / batches")

    params0 = {k: v.to(dev) for k, v in init_params.items()}
    spec, opt_state = init_ps_state(run, params0)
    layout = flatten.layout_of(params0)
    flat0 = flatten.tree_to_flat(params0)
    D = flat0.shape[0]
    ef = run.ring_dtype == "bf16"
    q0 = flat0.to(torch.bfloat16 if ef else torch.float32)
    ring = q0[None].expand(K, D).contiguous()
    res = (flat0 - q0.to(torch.float32)) if ef else None
    s = (flatten.tree_to_flat(opt_state[spec.state_keys[0]]).clone()
         if spec.state_keys else None)
    del params0, opt_state, flat0, q0

    xs = _trace_xs(trace, K, dev, None if whatif else batch_fn,
                   None if whatif else batches)
    coef = torch.full((c,), 1.0 / c, dtype=torch.float32, device=dev)
    use_kernel = impl == "kernel"
    if whatif:
        a, wstar = flat_grad[1].to(dev), flat_grad[2].to(dev)

    def event(j: int) -> None:
        idx, lrs = xs["idx"][j], xs["lrs"][j]
        if whatif:
            if use_kernel:
                replay_ring.ring_apply_whatif(ring, s, res, a, wstar, coef,
                                              lrs, idx, spec=spec)
            else:
                backends.apply_event_ring_whatif(
                    spec, ring, s, res, a, wstar, idx[2:], coef, lrs,
                    idx[0], idx[1])
            return
        pulled = ring.index_select(0, xs["ts"][j]).to(torch.float32)
        g = flatten.batched_tree_to_flat(
            grad_fn(flatten.batched_flat_to_tree(pulled, layout),
                    _index(xs["batch"], j)))
        del pulled
        if use_kernel:
            replay_ring.ring_apply(ring, s, res, g, coef, lrs, idx[:2],
                                   spec=spec, mode=mode)
        else:
            backends.apply_event_ring(spec, ring, s, res, g, coef, lrs,
                                      idx[0], idx[1], mode)

    def params_of(done: int):
        # a copy: returned parameters must not alias (and pin) the ring
        row = ring[done % K].to(torch.float32, copy=True)
        if ef:
            row = row + res
        return flatten.flat_to_tree(row, layout)

    history = []
    seg = eval_every if (eval_fn and eval_every) else steps
    for lo in range(0, steps, max(seg, 1)):
        hi = min(lo + seg, steps)
        for j in range(lo, hi):
            event(j)
        if eval_fn and eval_every and hi % eval_every == 0:
            history.append({"update": hi,
                            "time": float(trace.event_time[hi - 1]),
                            **eval_fn(params_of(hi))})
    return SimResult(trace.clock_log(), steps, trace.simulated_time,
                     trace.minibatches, params_of(steps), history)
