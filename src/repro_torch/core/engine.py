"""Replay pass of the port (counterpart of ``repro/core/engine.py``).

Given the :class:`ArrivalTrace` the schedule pass produced (``core/trace.py``),
execute every update event against a device-resident weight ring in the
``optim.flatten`` layout, ``K = trace.max_staleness + 1``: the snapshot of
timestamp ``ts`` lives in row ``ts % K``.  Event j

* gathers its c pulled weight vectors (``ring[ts % K]``, fp32 — with a
  bf16 ring the gradients see the quantized snapshots), computes every
  gradient of the event in ONE ``grad_fn`` call (the problem's ``grad_fn``
  takes an explicit leading slot dimension), and
* applies ONE ring event through ``kernels.replay_ring.ring_apply``: read
  row ``j % K`` (+ the fp32 error-feedback residue of a bf16 ring), combine
  or sequential optimizer event, write row ``(j + 1) % K`` in place.

What the reference's single-placement replay does, the port does:

* **Elastic membership** (``trace.valid`` / ``member_valid``): each event
  reads its combine coefficients (``trace.event_coef()``, 0 on cancelled
  slots) in place of the static 1/c, and a group's member gradients are
  weighted by ``trace.member_coef()``.  Cancelled work is computed and
  folded with coefficient 0 — data, not control flow.  Elastic traces
  replay in combine mode only.
* **Learner groups** (gs > 1): minibatches carry (c, gs, …) leading axes;
  the c·gs member gradients of an event come from one ``grad_fn`` call
  against the slot's pulled weights repeated gs times, then the group
  mean (or the survivor-weighted sum).
* **Sharded PS rings** (S > 1): one flat (K, S·Dp) ring, Dp = ⌈D/S⌉, each
  row the shard rows side by side.  A slot's weights are gathered from
  per-shard rows at per-shard timestamps (``trace.shard_pulled_ts``), and
  the event is ONE ``ring_apply`` launch over the whole padded width (the
  padding zeros are inert).
* **The serving lane** (``trace.serving``): a (P + 1, D) fp32 buffer of
  the published weight versions.  After each event ``index_copy_`` writes
  the new ring row to its version's position (or to the inert dummy row P)
  without a host sync; after the loop each request batch is evaluated on
  its version's row, in chunks of 512 requests, one batched call a chunk.
* **The stock body** (``ring_impl="stock"``): gather →
  ``optim.apply_event_flat`` (``apply_event_sharded`` over an (S, K, Dp)
  ring when sharded) → row write; adamw replays only here, through the
  pytree ``optim.apply_update_tree``.  Plain PyTorch by the reference's
  own design (its stock body reaches no Pallas kernel); used only where the
  caller asks for it, never in place of the kernel.

The what-if body (``flat_grad=("quadratic", a, w*)``; combine mode, the
trivial topology, no serving lane, not stock) computes the gradients
gⱼ = a ⊙ (ring[tsⱼ] − w*) inside ``ring_apply_whatif`` instead, so no data
is staged and the (c, D) matrices never exist.

``lax.scan`` becomes a Python loop.  The whole trace's ring indices, LRs,
coefficients and staged minibatches go to the device ONCE before the loop
(``_trace_xs``); the loop indexes them as device tensors and never
synchronizes with the host.  Host syncs happen only at ``eval_every``
segment ends and in the serving evaluation after the loop.

:func:`replay_batch` replays B shape-compatible traces as one (B, K, D)
ring: one ``grad_fn`` call over B·c slots per event, then one
``ring_apply`` launch per lane on its contiguous ring view.

Not ported: ``placement="spmd"`` (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

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
from repro_torch.optim.flatten import tree_map

# requests evaluated per batched call of the serving lane
SERVE_CHUNK = 512


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
    return tree_map(lambda t: t[j], tree)


def _materialize_batches(trace: ArrivalTrace, batch_fn: Callable):
    """``batch_fn(learner, minibatch_idx)`` for every trace slot, stacked
    host-side into numpy arrays with leading (steps, c) axes — (steps, c,
    gs) with learner groups: slot (j, i) stacks its gs member minibatches
    ``batch_fn(member, push_counter)``."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(stack([it[i] for it in items])
                               for i in range(len(first)))
        return np.stack([np.asarray(it) for it in items])

    members = trace.member_learners()          # None when ungrouped

    def slot(j, i):
        mb = int(trace.mb_index[j, i])
        if members is None:
            return batch_fn(int(trace.learner[j, i]), mb)
        return stack([batch_fn(int(m), mb) for m in members[j, i]])

    return stack([stack([slot(j, i) for i in range(trace.c)])
                  for j in range(trace.steps)])


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
        raise ValueError(
            f"trace {'carries' if trace.serving is not None else 'has no'} "
            f"serving lane but run.serving is "
            f"{'unset' if run.serving is None else 'set'} — reschedule the "
            f"trace for this config")


def _check_ported(run: RunConfig) -> None:
    """Raise NotImplementedError for the part of the reference's replay
    that the port does not run yet."""
    if run.placement == "spmd":
        raise _not_ported("placement='spmd'", "8")


def _trace_xs(trace: ArrivalTrace, K: int, device: torch.device,
              batch_fn: Optional[Callable], batches) -> dict:
    """The loop inputs of one trace, moved to the device in one transfer
    each: ``idx`` (steps, 2 + c) int32 rows [prev, slot, ts_0 … ts_{c−1}]
    pre-wrapped mod K (the kernels' index operand; ``ts`` is its view),
    ``lrs`` (steps, c) fp32; with S > 1 shards ``sts`` (steps, c, S), the
    per-shard pulled rows; on an elastic trace ``coef`` (steps, c) and,
    with masked group members, ``mcoef`` (steps, c, gs) fp32; and the
    staged minibatches (leading (steps, c) axes, (steps, c, gs) with
    groups) when the body needs data."""
    steps = np.arange(trace.steps)
    idx = np.concatenate([(steps % K)[:, None], ((steps + 1) % K)[:, None],
                          trace.pulled_ts % K], axis=1).astype(np.int32)
    xs = {"idx": torch.as_tensor(idx, device=device),
          "lrs": torch.as_tensor(np.asarray(trace.lrs, np.float32),
                                 device=device)}
    xs["ts"] = xs["idx"][:, 2:]
    if trace.topology.shards > 1:
        xs["sts"] = torch.as_tensor(
            (trace.shard_pulled_ts % K).astype(np.int64), device=device)
    if trace.valid is not None:
        xs["coef"] = torch.as_tensor(trace.event_coef(), device=device)
    if trace.member_valid is not None:
        xs["mcoef"] = torch.as_tensor(trace.member_coef(), device=device)
    if batches is None and batch_fn is not None:
        batches = _materialize_batches(trace, batch_fn)
    if batches is not None:
        xs["batch"] = on_device(batches, device)
    return xs


def _pub_index(serving, steps: int) -> np.ndarray:
    """(steps,) snapshot-buffer index per event: version j + 1 is born when
    event j fires, so event j writes its new ring row to the version's
    position in ``pub_versions`` when some replica publishes it, else to
    the inert dummy row (index P — branch-free capture)."""
    pv = np.asarray(serving.pub_versions, np.int64)
    P = pv.shape[0]
    born = np.arange(1, steps + 1)
    idx = np.searchsorted(pv, born)
    hit = (idx < P) & (pv[np.minimum(idx, P - 1)] == born)
    return np.where(hit, idx, P)


def _serve_eval(snaps: torch.Tensor, layout, serving, serve_batches,
                serve_eval_fn: Callable, chunk: int = SERVE_CHUNK):
    """The serving lane's evaluation: each request batch on the captured
    row of the version that served it, ``chunk`` requests per call of
    ``serve_eval_fn`` (which takes parameters and request batches with a
    leading request axis).  Dropped requests (no live replica) score 0."""
    from repro_torch.serve.fleet import ServingResult   # lazy: layering
    dev = snaps.device
    req_pub = torch.as_tensor(np.asarray(serving.req_pub, np.int64),
                              device=dev)
    batches = on_device(serve_batches, dev)
    R = serving.n_requests
    parts = []
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        rows = snaps.index_select(0, req_pub[lo:hi])
        parts.append(serve_eval_fn(flatten.batched_flat_to_tree(rows, layout),
                                   tree_map(lambda a: a[lo:hi], batches)))
    metric = (torch.cat(parts).to(torch.float32).cpu().numpy() if parts
              else np.zeros(0, np.float32))
    metric = np.where(serving.served, metric, 0.0).astype(np.float32)
    return ServingResult(trace=serving, request_metric=metric)


def _check_serving_args(serving, serve_batches, serve_eval_fn) -> None:
    if serving is not None and (serve_batches is None
                                or serve_eval_fn is None):
        raise ValueError(
            "this trace carries a serving lane: pass serve_batches (a "
            "batch with a leading (R,) request axis, e.g. "
            "problem.stage_requests(trace.serving, run.serving)) and "
            "serve_eval_fn(params, request_batch) -> (n,) metric")
    if serving is None and (serve_batches is not None
                            or serve_eval_fn is not None):
        raise ValueError(
            "serve_batches/serve_eval_fn passed but the trace has no "
            "serving lane — schedule it from a RunConfig with "
            "serving=FleetConfig(...)")


def _ring_event(impl: str, spec, ring: torch.Tensor, s, res,
                g: torch.Tensor, coef: torch.Tensor, lrs: torch.Tensor,
                idx: torch.Tensor, pos: torch.Tensor, mode: str):
    """One optimizer event on a flat (K, width) ring view: the (c, width)
    fp32 gradients ``g`` fold into row ``idx[1]`` from row ``idx[0]``
    (``pos``: the same two indices as int64).  ``kernel`` launches
    ``ring_apply``, ``fused`` runs its plain version, both writing ring,
    ``s`` and ``res`` in place; ``stock`` is the gather → flat event →
    row-write chain.  Returns the optimizer state after the event."""
    if impl == "kernel":
        replay_ring.ring_apply(ring, s, res, g, coef, lrs, idx[:2],
                               spec=spec, mode=mode)
    elif impl == "fused":
        backends.apply_event_ring(spec, ring, s, res, g, coef, lrs, idx[0],
                                  idx[1], mode)
    else:
        w, s = backends.apply_event_flat(
            spec, ring.index_select(0, pos[:1])[0], s, g, coef, lrs, mode)
        ring.index_copy_(0, pos[1:2], w[None])
    return s


def _row_params(row: torch.Tensor, res, layout, D: int):
    """A ring row (width ≥ D, fp32 or bf16) as parameters that do not alias
    (and pin) the ring: fp32, plus the residue ``res`` with a bf16 ring."""
    row = row[:D].to(torch.float32, copy=True)
    if res is not None:
        row = row + res[:D]
    return flatten.flat_to_tree(row, layout)


def replay(trace: ArrivalTrace, run: RunConfig, *,
           grad_fn: Optional[Callable] = None,
           init_params,
           batch_fn: Optional[Callable] = None,
           batches=None,
           eval_fn: Optional[Callable] = None,
           eval_every: int = 0,
           flat_grad=None,
           serve_batches=None,
           serve_eval_fn: Optional[Callable] = None,
           device="cuda") -> SimResult:
    """Execute a scheduled trace against real gradients on ``device``.

    ``grad_fn(params, batch) -> grads`` takes parameters and a batch with a
    leading slot dimension and returns one gradient per slot (a dict with
    the same leading axis).  Minibatches come from exactly one of
    ``batch_fn`` (``(learner, minibatch_idx) -> batch``, numpy, per slot)
    or ``batches`` (pre-staged, leading (steps, c) axes — (steps, c, gs)
    with learner groups).  ``init_params`` is a dict of tensors (any
    device).

    ``run.ring_impl`` ``auto``/``pallas`` runs the ``kernels/replay_ring``
    wrappers (the CUDA kernels on a card, their plain versions on the CPU);
    ``fused`` runs the plain versions directly; ``stock`` the gather →
    flat event → row-write chain (adamw always).  ``flat_grad =
    ("quadratic", a, w*)`` ((D,) fp32 tensors) selects the what-if body
    where the reference takes it (combine mode, trivial topology, no
    serving lane, not stock), at any K.

    A trace scheduled with ``run.serving`` needs ``serve_batches`` (a batch
    with a leading (R,) request axis, e.g. ``problem.stage_requests``) and
    ``serve_eval_fn(params, request_batch) -> (n,) metric`` (both with a
    leading request axis); the result then carries a ``ServingResult``.

    With ``eval_every`` set, ``eval_fn(params) -> dict`` runs after every
    full segment of that many events (the only host syncs of the loop).
    """
    dev = resolve_device(device)
    _check_trace(trace, run)
    serving = trace.serving
    _check_serving_args(serving, serve_batches, serve_eval_fn)
    steps, c = trace.steps, trace.c
    K = trace.max_staleness + 1
    S, gs = trace.topology.shards, trace.group_size
    spec = optim.spec_from_run(run)
    if S > 1 and not spec.kernel_supported:
        raise ValueError(
            f"{spec.optimizer!r} has no flat event path, so no sharded "
            f"replay (shards={S}); use a kernel-supported optimizer")
    if trace.valid is not None and trace.mode != "combine":
        raise ValueError(
            f"elastic traces replay in 'combine' mode only (cancelled "
            f"slots fold with coefficient 0; sequential optimizer events "
            f"cannot be masked), got mode={trace.mode!r}")
    _check_ported(run)
    impl = backends.resolve_ring_impl(run.ring_impl, spec)
    mode = trace.mode
    whatif = (flat_grad is not None and impl != "stock" and mode == "combine"
              and S == 1 and gs == 1 and serving is None)
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
    Dp = trace.topology.padded_width(D)
    ef = run.ring_dtype == "bf16"
    s = (flatten.tree_to_flat(opt_state[spec.state_keys[0]]).clone()
         if spec.state_keys and spec.kernel_supported else None)
    res = tree = None
    if impl != "stock":
        # one flat (K, width) ring in the ring dtype: the shard rows side
        # by side when sharded (width S·Dp ≥ D; the padding zeros are inert)
        width = D if S == 1 else S * Dp
        flat_pad = flatten.pad_flat(flat0, width)
        q0 = flat_pad.to(torch.bfloat16 if ef else torch.float32)
        ring = q0[None].expand(K, width).contiguous()
        res = (flat_pad - q0.to(torch.float32)) if ef else None
        if s is not None:
            s = flatten.pad_flat(s, width)
        del flat_pad, q0
    elif S > 1:
        # the stock sharded body: per-shard (K, Dp) rings stacked (S, K, Dp)
        ring = flatten.shard_pack(flat0, S, Dp)[:, None, :].expand(
            S, K, Dp).contiguous()
        if s is not None:
            s = flatten.shard_pack(s, S, Dp)
    else:
        ring = flat0[None].expand(K, D).contiguous()
        if not spec.kernel_supported:
            tree = [params0, opt_state]     # adamw: the pytree carry
    if tree is None:
        del params0, opt_state
    del flat0

    xs = _trace_xs(trace, K, dev, None if whatif else batch_fn,
                   None if whatif else batches)
    static_coef = torch.full((c,), 1.0 / c, dtype=torch.float32, device=dev)
    if whatif:
        a, wstar = flat_grad[1].to(dev), flat_grad[2].to(dev)
    shard_ids = torch.arange(S, device=dev)
    # [prev, slot] as (1,) int64 index tensors for index_select/index_copy_
    pos = xs["idx"][:, :2].to(torch.int64)

    def pulled_weights(j: int) -> torch.Tensor:
        """The (c, D) fp32 weights event j's slots computed against."""
        if S == 1:
            return ring.index_select(0, xs["ts"][j])[:, :D].to(torch.float32)
        sts = xs["sts"][j]                                  # (c, S)
        if impl == "stock":
            parts = ring[shard_ids, sts]                    # (c, S, Dp)
        else:
            parts = ring.view(K, S, Dp)[sts, shard_ids]
        return parts.reshape(c, S * Dp)[:, :D].to(torch.float32)

    def gradients(j: int) -> torch.Tensor:
        """(c, D) fp32 slot gradients of event j: one ``grad_fn`` call over
        c slots, or over c·gs members then the group mean."""
        pulled = pulled_weights(j)
        batch = _index(xs["batch"], j)
        if gs == 1:
            return flatten.batched_tree_to_flat(
                grad_fn(flatten.batched_flat_to_tree(pulled, layout), batch))
        rep = pulled.repeat_interleave(gs, dim=0)
        del pulled
        g = flatten.batched_tree_to_flat(grad_fn(
            flatten.batched_flat_to_tree(rep, layout),
            tree_map(lambda t: t.reshape((c * gs,) + t.shape[2:]), batch)))
        g = g.view(c, gs, D)
        if "mcoef" in xs:
            return (g * xs["mcoef"][j][:, :, None]).sum(dim=1)
        return g.mean(dim=1)

    def event(j: int) -> None:
        nonlocal s
        idx, lrs = xs["idx"][j], xs["lrs"][j]
        coef = xs["coef"][j] if "coef" in xs else static_coef
        if whatif:
            if impl == "kernel":
                replay_ring.ring_apply_whatif(ring, s, res, a, wstar, coef,
                                              lrs, idx, spec=spec)
            else:
                backends.apply_event_ring_whatif(
                    spec, ring, s, res, a, wstar, idx[2:], coef, lrs,
                    idx[0], idx[1])
            return
        g = gradients(j)
        if tree is not None:
            grads = [flatten.flat_to_tree(g[i], layout) for i in range(c)]
            tree[:] = optim.apply_update_tree(spec, tree[0], tree[1], grads,
                                              coef, lrs, mode)
            ring.index_copy_(0, pos[j, 1:2],
                             flatten.tree_to_flat(tree[0])[None])
        elif impl == "stock" and S > 1:
            w, s = backends.apply_event_sharded(
                spec, ring.index_select(1, pos[j, :1])[:, 0], s,
                flatten.shard_pack_grads(g, S, Dp), coef, lrs, mode)
            ring.index_copy_(1, pos[j, 1:2], w[:, None])
        else:
            s = _ring_event(impl, spec, ring, s, res,
                            flatten.pad_flat(g, ring.shape[1]), coef, lrs,
                            idx, pos[j], mode)

    def row_of(i: torch.Tensor) -> torch.Tensor:
        """Ring row ``i`` (a (1,) int64 tensor) as the (D,) fp32 weights
        stored there (quantized with a bf16 ring: no residue)."""
        if impl == "stock" and S > 1:
            return flatten.shard_unpack(ring.index_select(1, i)[:, 0], D)
        return ring.index_select(0, i)[0, :D].to(torch.float32)

    def params_of(done: int):
        if tree is not None:
            return {k: v.clone() for k, v in tree[0].items()}
        i = torch.tensor([done % K], device=dev)
        if impl == "stock" and S > 1:
            return _row_params(row_of(i), None, layout, D)
        return _row_params(ring.index_select(0, i)[0], res, layout, D)

    snaps = None
    if serving is not None:
        # row 0: version 0, the initial ring row every replica boots with;
        # row P: the inert dummy row unpublished versions write
        P = int(serving.pub_versions.shape[0])
        snaps = torch.zeros((P + 1, D), dtype=torch.float32, device=dev)
        snaps[0] = row_of(torch.zeros(1, dtype=torch.int64, device=dev))
        pub = torch.as_tensor(_pub_index(serving, steps), device=dev)

    history = []
    seg = eval_every if (eval_fn and eval_every) else steps
    for lo in range(0, steps, max(seg, 1)):
        hi = min(lo + seg, steps)
        for j in range(lo, hi):
            event(j)
            if snaps is not None:
                snaps.index_copy_(0, pub[j:j + 1], row_of(pos[j, 1:2])[None])
        if eval_fn and eval_every and hi % eval_every == 0:
            history.append({"update": hi,
                            "time": float(trace.event_time[hi - 1]),
                            **eval_fn(params_of(hi))})
    serve_result = None
    if snaps is not None:
        serve_result = _serve_eval(snaps, layout, serving, serve_batches,
                                   serve_eval_fn)
    return SimResult(trace.clock_log(), steps, trace.simulated_time,
                     trace.minibatches, params_of(steps), history,
                     serving=serve_result)


def replay_batch(traces: Sequence[ArrivalTrace],
                 runs: Sequence[RunConfig], *,
                 grad_fn: Callable,
                 init_params,
                 batch_fns: Optional[Sequence[Callable]] = None,
                 batches: Optional[Sequence] = None,
                 eval_fn: Optional[Callable] = None,
                 eval_every: int = 0,
                 device="cuda") -> List[SimResult]:
    """Replay B shape-compatible traces as one (B, K, D) ring.

    The sweep fast path: grid points that share trace shape (``steps``,
    ``c``, mode), optimizer spec, ring storage, ``grad_fn`` and parameter
    layout differ only in data — ring indices, LRs, coefficients and
    minibatches.  Each event computes the B·c gradients of all lanes in
    ONE ``grad_fn`` call, then applies one ``ring_apply`` launch per lane
    on ``ring[b]`` (a contiguous view, written in place).  The ring is
    sized to the group's largest staleness (ring size never changes the
    math, only which row a snapshot lands in).

    Restrictions, with the reference's messages: no serving traces, one
    trace shape, lanes agreeing on elasticity (masked lanes batch
    together), one optimizer spec and ring storage, single placement,
    kernel-supported optimizers and the trivial topology.  Per lane the
    result is the sequential :func:`replay` of the same trace within the
    fp32 tolerance ``tests/test_torch_sweep.py`` states.
    """
    traces, runs = list(traces), list(runs)
    B = len(traces)
    if (batch_fns is None) == (batches is None):
        raise ValueError("pass exactly one of batch_fns / batches")
    lanes = list(batch_fns) if batches is None else list(batches)
    if not (B and len(runs) == B and len(lanes) == B):
        raise ValueError("traces / runs / batch data must align, non-empty")
    for trace, run in zip(traces, runs):
        _check_trace(trace, run)
        if trace.serving is not None:
            raise ValueError(
                "batched replay does not support serving traces: the "
                "serving lane adds a per-lane snapshot carry plus a "
                "post-scan request evaluation; replay serving specs "
                "individually (the experiment driver excludes them from "
                "batch cells automatically)")
    steps, c, mode = traces[0].steps, traces[0].c, traces[0].mode
    masked = traces[0].valid is not None
    for trace in traces[1:]:
        if (trace.steps, trace.c, trace.mode) != (steps, c, mode):
            raise ValueError(
                f"batch members must share trace shape: "
                f"(steps={steps}, c={c}, mode={mode!r}) vs "
                f"(steps={trace.steps}, c={trace.c}, mode={trace.mode!r})")
        if (trace.valid is not None) != masked:
            raise ValueError(
                "batch members must agree on elasticity: masked (elastic) "
                "and dense traces compile different scan bodies — group "
                "them separately")
    if masked and mode != "combine":
        raise ValueError("elastic traces replay in 'combine' mode only")
    spec = optim.spec_from_run(runs[0])
    for run in runs[1:]:
        other = optim.spec_from_run(run)
        if other != spec:
            raise ValueError(f"batch members must share the optimizer "
                             f"spec: {spec} vs {other}")
    ring_cfg = (runs[0].ring_impl, runs[0].ring_dtype)
    for run in runs[1:]:
        if (run.ring_impl, run.ring_dtype) != ring_cfg:
            raise ValueError(
                f"batch members must share (ring_impl, ring_dtype): "
                f"{ring_cfg} vs {(run.ring_impl, run.ring_dtype)} — a bf16 "
                f"lane's carry has a different dtype/residue layout")
    for run in runs:
        if run.placement != "single":
            raise ValueError(
                f"batched replay is single-placement only (a lane axis and "
                f"a device mesh cannot share the carry); replay "
                f"placement={run.placement!r} specs individually")
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no flat lane layout; "
                         f"replay each trace sequentially")
    for trace, run in zip(traces, runs):
        if not trace.topology.is_trivial(run.n_learners):
            raise ValueError(
                f"batched replay supports the trivial (Rudra-base) "
                f"topology only; got {trace.topology} — replay "
                f"sharded/grouped traces sequentially")
    dev = resolve_device(device)
    K = max(trace.max_staleness for trace in traces) + 1
    impl = backends.resolve_ring_impl(runs[0].ring_impl, spec)
    ef = runs[0].ring_dtype == "bf16"

    params0 = {k: v.to(dev) for k, v in init_params.items()}
    spec, opt_state = init_ps_state(runs[0], params0)
    layout = flatten.layout_of(params0)
    flat0 = flatten.tree_to_flat(params0)
    D = flat0.shape[0]
    q0 = flat0.to(torch.bfloat16 if ef else torch.float32)
    ring = q0[None, None].expand(B, K, D).contiguous()
    res = ((flat0 - q0.to(torch.float32))[None].expand(B, D).contiguous()
           if ef else None)
    s = None
    if spec.state_keys:
        s = flatten.tree_to_flat(opt_state[spec.state_keys[0]])[None] \
            .expand(B, D).contiguous()
    del params0, opt_state, flat0, q0

    if batches is None:
        xs_lanes = [_trace_xs(t, K, dev, fn, None)
                    for t, fn in zip(traces, lanes)]
    else:
        xs_lanes = [_trace_xs(t, K, dev, None, b)
                    for t, b in zip(traces, lanes)]
    # (B, steps, …) lane inputs; prev/slot are step-indexed mod the shared
    # K, identical in every lane
    ts = torch.stack([x["ts"] for x in xs_lanes])
    lrs = torch.stack([x["lrs"] for x in xs_lanes])
    coefs = (torch.stack([x["coef"] for x in xs_lanes]) if masked else None)
    batch = tree_map(lambda *a: torch.stack(a),
                     *[x["batch"] for x in xs_lanes])
    idx = xs_lanes[0]["idx"][:, :2].contiguous()
    pos = idx.to(torch.int64)
    del xs_lanes
    static_coef = torch.full((c,), 1.0 / c, dtype=torch.float32, device=dev)
    lane_base = (torch.arange(B, device=dev) * K)[:, None]

    def event(j: int) -> None:
        rows = (lane_base + ts[:, j]).reshape(-1)           # (B·c,)
        pulled = ring.view(B * K, D).index_select(0, rows).to(torch.float32)
        g = flatten.batched_tree_to_flat(grad_fn(
            flatten.batched_flat_to_tree(pulled, layout),
            tree_map(lambda t: t[:, j].reshape((B * c,) + t.shape[3:]),
                     batch))).view(B, c, D)
        del pulled
        for b in range(B):
            sb = None if s is None else s[b]
            s2 = _ring_event(impl, spec, ring[b], sb,
                             None if res is None else res[b], g[b],
                             coefs[b, j] if masked else static_coef,
                             lrs[b, j], idx[j], pos[j], mode)
            if s2 is not sb:            # stock: a new state, not in place
                sb.copy_(s2)

    def params_of(b: int, done: int):
        return _row_params(ring[b, done % K], None if res is None
                           else res[b], layout, D)

    histories = [[] for _ in range(B)]
    seg = eval_every if (eval_fn and eval_every) else steps
    for lo in range(0, steps, max(seg, 1)):
        hi = min(lo + seg, steps)
        for j in range(lo, hi):
            event(j)
        if eval_fn and eval_every and hi % eval_every == 0:
            for b in range(B):
                histories[b].append(
                    {"update": hi,
                     "time": float(traces[b].event_time[hi - 1]),
                     **eval_fn(params_of(b, hi))})
    return [SimResult(t.clock_log(), steps, t.simulated_time, t.minibatches,
                      params_of(b, steps), histories[b])
            for b, t in enumerate(traces)]
