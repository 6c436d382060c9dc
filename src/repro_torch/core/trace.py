"""Schedule pass of the compiled PS simulator (DESIGN.md §4).

The event-driven simulation splits into two phases.  This module is phase 1:
a host-side numpy **schedule** pass that runs the gradient-free event queue
(the same priority-queue arrival semantics as the legacy per-arrival loop in
``core/simulator.py``) and emits an :class:`ArrivalTrace` — for every update
event, which learner filled each of its c gradient slots, the PS timestamp
of the weights that learner had pulled, the learner's minibatch counter, the
simulated clock, and the LRs resolved from the run's policy.  Phase 2
(``core/engine.py``) replays the trace as one compiled ``lax.scan``.

The schedule draws from ``np.random.default_rng(run.seed)`` in exactly the
order the legacy loop does, so a trace scheduled with the same seed
reproduces the legacy arrival order bit-for-bit (the oracle-equivalence
contract, ``tests/test_trace_engine.py``).  Elastic membership
(``run.membership`` joins/leaves/crash-restarts, ``run.backup`` hardsync
backup learners — DESIGN.md §7) also resolves here, into validity masks on
the trace; a static timeline keeps the rng draw order untouched
(``tests/test_elastic.py``).

Duration samplers are pluggable ``(rng, mu, learner) -> seconds`` callables;
:func:`make_duration_sampler` builds the one selected by
``RunConfig.duration_model``:

* ``homogeneous`` — fixed overhead + per-sample cost with the GEMM-
  efficiency penalty for small μ (§5.2) and lognormal jitter.
* ``two_speed``   — a two-tier heterogeneous cluster: the first
  ``slow_fraction·λ`` learners run ``slow_factor×`` slower.
* ``pareto``      — heavy straggler tail (Dutta et al., *Slow and Stale
  Gradients Can Win the Race*): duration × (1 + scale·Pareto(α)).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import inspect
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.config import (CALIBRATED_PREFIX, DURATION_MODELS, RunConfig,
                          parse_calibrated)
from repro_torch.core.clock import VectorClockLog, staleness_matrix
from repro_torch.core.lr_policies import resolve_trace_lrs
from repro_torch.core.topology import Topology
from repro_torch.membership import MembershipTimeline


# ---------------------------------------------------------------------------
# duration samplers
# ---------------------------------------------------------------------------
def base_duration(rng: np.random.Generator, mu: int) -> float:
    """Per-minibatch compute time: fixed overhead + per-sample cost, with the
    GEMM-efficiency penalty for small μ the paper describes (§5.2), plus
    lognormal jitter (homogeneous-cluster noise)."""
    gemm_eff = mu / (mu + 8.0)             # small μ ⇒ poor GEMM throughput
    base = 0.5 + mu * 0.01 / gemm_eff
    return base * rng.lognormal(mean=0.0, sigma=0.05)


def make_duration_sampler(run: RunConfig) -> Callable:
    """The ``(rng, mu, learner) -> seconds`` sampler selected by
    ``run.duration_model`` — one of the stochastic models below, or a
    ``calibrated:<arch>[:<int>mb]`` string resolving to the calibrated
    per-minibatch cost model of ``core/tradeoff.py`` (the same grammar
    ``ExperimentSpec.duration`` accepts; ``repro_torch.config.parse_calibrated``
    is the shared parser)."""
    if run.duration_model.startswith(CALIBRATED_PREFIX):
        from repro_torch.core import tradeoff as to     # lazy: keep layering flat
        arch, model_bytes = parse_calibrated(run.duration_model)
        wl = to.WorkloadModel()
        if model_bytes is not None:
            wl = dataclasses.replace(wl, model_bytes=model_bytes)
        return to.minibatch_duration_sampler(
            arch, run.n_learners, to.calibrate_to_baseline(), wl)
    if run.duration_model == "homogeneous":
        def sampler(rng, mu, learner):
            return base_duration(rng, mu)
        return sampler
    if run.duration_model == "two_speed":
        # slow_fraction small enough to round to zero learners is a valid
        # homogeneous control — don't force a slow learner into it
        n_slow = int(round(run.slow_fraction * run.n_learners))
        factor = float(run.slow_factor)

        def sampler(rng, mu, learner):
            d = base_duration(rng, mu)
            return d * factor if learner < n_slow else d
        return sampler
    if run.duration_model == "pareto":
        alpha, scale = float(run.pareto_alpha), float(run.pareto_scale)

        def sampler(rng, mu, learner):
            return base_duration(rng, mu) * (1.0 + scale * rng.pareto(alpha))
        return sampler
    raise ValueError(f"duration_model must be one of {DURATION_MODELS}, "
                     f"got {run.duration_model!r}")


def as_learner_sampler(sampler: Callable) -> Callable:
    """Adapt a legacy ``(rng, mu)`` sampler to the ``(rng, mu, learner)``
    signature (learner-independent)."""
    try:
        n_args = len(inspect.signature(sampler).parameters)
    except (TypeError, ValueError):
        n_args = 3
    if n_args >= 3:
        return sampler
    return lambda rng, mu, learner: sampler(rng, mu)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """Everything the replay engine needs, as dense host arrays.

    Row j describes update event j (PS timestamp j → j+1): slot i of the row
    is the i-th gradient folded into that update, in arrival order.

    With a non-trivial :class:`~repro_torch.core.topology.Topology` the slot
    granularity is the *pusher* (a learner group): ``learner`` holds pusher
    ids, ``mb_index`` the pusher's push counter, and each slot stands for
    ``group_size`` member gradients aggregated locally (member learner ids
    come from ``member_learners``).  With S > 1 PS shards,
    ``shard_pulled_ts`` records the per-shard timestamps of the slices the
    pusher assembled its weights from (inconsistent reads; see topology.py).

    **Elastic membership** (DESIGN.md §7) resolves into two optional masks —
    the replay engine never branches per event, it only reweights:

    * ``valid`` (steps, c) bool: which slots of each row actually committed.
      Rows fired while λ(t) < λ (leaves/crashes shrank the n-softsync
      threshold, or backup-hardsync cancelled the slowest arrivals) have
      trailing unfilled slots: their ``learner``/``mb_index`` point at
      benign real data (learner 0, counter 0), ``pulled_ts`` is the row
      index (σ = 0), and the replay folds them with coefficient 0
      (:meth:`event_coef`).  None ⇔ every row is full (the static world).
    * ``member_valid`` (steps, c, gs) bool: per-slot member survival for
      grouped topologies — a group with crashed/left members aggregates
      over the survivors (:meth:`member_coef`).  None ⇔ ungrouped or no
      member ever missed a push.
    """

    protocol: str
    n_learners: int
    learner: np.ndarray       # (steps, c) int32 — pusher that filled slot i
    pulled_ts: np.ndarray     # (steps, c) int32 — timestamp of pulled weights
    mb_index: np.ndarray      # (steps, c) int32 — pusher's push counter
    event_time: np.ndarray    # (steps,) float64 — simulated clock at fire
    lrs: np.ndarray           # (steps, c) — policy-resolved LRs
    mode: str                 # "combine" | "sequential" (repro_torch.optim modes)
    topology: Topology = Topology()
    # (steps, c, S) int32 per-shard pulled timestamps, None when S == 1.
    # Invariant: pulled_ts[j, i] <= shard_pulled_ts[j, i, s] <= j (a shard
    # slice is never staler than the logical pull, never from the future).
    shard_pulled_ts: Optional[np.ndarray] = None
    # elastic-membership masks (None = dense / full membership; see class
    # docstring)
    valid: Optional[np.ndarray] = None          # (steps, c) bool
    member_valid: Optional[np.ndarray] = None   # (steps, c, gs) bool
    # train-while-serve lane (DESIGN.md §14): the resolved ServingTrace when
    # run.serving attached a fleet — publication refreshes, request →
    # published-version assignments, staleness and latency, all resolved
    # host-side against this trace's event clock.  None = no serving lane;
    # the replay engine then compiles the exact pre-serving program.
    serving: Optional["ServingTrace"] = None

    @property
    def steps(self) -> int:
        return int(self.pulled_ts.shape[0])

    @property
    def c(self) -> int:
        """Gradients per update (Eq. 5's c; P for hardsync)."""
        return int(self.pulled_ts.shape[1])

    @property
    def group_size(self) -> int:
        """Learner gradients aggregated into one slot (1 = ungrouped)."""
        return self.topology.group_size(self.n_learners)

    @property
    def elastic(self) -> bool:
        """True when a membership timeline (or backup cancellation) masked
        any slot or group member of this trace."""
        return self.valid is not None or self.member_valid is not None

    @property
    def minibatches(self) -> int:
        """Minibatch gradients the trace actually commits: cancelled slots
        and crashed-out group members don't count (dense traces: steps·c·gs
        exactly as before)."""
        if self.member_valid is not None:
            slot_on = (self.valid if self.valid is not None
                       else np.ones(self.pulled_ts.shape, bool))
            return int((self.member_valid & slot_on[:, :, None]).sum())
        if self.valid is not None:
            return int(self.valid.sum()) * self.group_size
        return self.steps * self.c * self.group_size

    def event_coef(self) -> np.ndarray:
        """(steps, c) float32 combine coefficients: uniform over each row's
        committed slots, 0 on cancelled/unfilled ones (dense: 1/c)."""
        if self.valid is None:
            return np.full((self.steps, self.c), 1.0 / self.c, np.float32)
        count = np.maximum(1, self.valid.sum(axis=1, keepdims=True))
        return (self.valid / count).astype(np.float32)

    def member_coef(self) -> Optional[np.ndarray]:
        """(steps, c, gs) float32 member-averaging weights — uniform over a
        slot's surviving members — or None when every push was full (the
        replay then keeps its plain mean)."""
        if self.member_valid is None:
            return None
        count = np.maximum(1, self.member_valid.sum(axis=2, keepdims=True))
        return (self.member_valid / count).astype(np.float32)

    def member_learners(self) -> Optional[np.ndarray]:
        """(steps, c, gs) int32 member learner ids behind each slot, or
        None when ungrouped (the slot's ``learner`` IS the member)."""
        if self.group_size == 1:
            return None
        return self.topology.members(self.n_learners)[self.learner]

    @property
    def shard_staleness(self) -> np.ndarray:
        """(steps, c, S) per-shard σ matrix (σ_s ≤ σ: later-completing
        shard pulls see fresher slices).  S = 1 ⇒ the slot σ matrix with a
        trailing singleton axis."""
        if self.shard_pulled_ts is None:
            return self.staleness[:, :, None]
        steps = self.shard_pulled_ts.shape[0]
        return (np.arange(steps, dtype=np.int64)[:, None, None]
                - self.shard_pulled_ts.astype(np.int64))

    @property
    def staleness(self) -> np.ndarray:
        """(steps, c) σ matrix: gradient in slot (j, i) has σ = j − ts
        (Eq.-2 accounting, one home: ``clock.staleness_matrix``)."""
        return staleness_matrix(self.pulled_ts)

    @property
    def max_staleness(self) -> int:
        """Ring-buffer bound: the replay engine keeps max σ + 1 snapshots
        (n-softsync bounds this at ~2n w.h.p., Fig. 4)."""
        return int(self.staleness.max()) if self.steps else 0

    @property
    def simulated_time(self) -> float:
        """The paper's runtime axis: simulated clock of the last update."""
        return float(self.event_time[-1]) if self.steps else 0.0

    def clock_log(self) -> VectorClockLog:
        """Fig.-4 statistics, trace-native (vectorized over the σ matrix;
        cancelled slots are excluded from every statistic)."""
        return VectorClockLog.from_matrix(self.pulled_ts, valid=self.valid)

    def version_at(self, t) -> np.ndarray:
        """Weight version live at time t: the count of update events fired
        at or before t (version v ≥ 1 is born when event v − 1 fires; the
        same-instant tie rule — events apply before reads — is
        ``side="right"``).  Vectorizes over array t."""
        return np.searchsorted(self.event_time, t, side="right")


# ---------------------------------------------------------------------------
# the schedule pass
# ---------------------------------------------------------------------------
# rng stream tag for shard-pull skew draws: shard jitter must never perturb
# the main arrival stream (S = 1 and S > 1 schedule identical arrivals)
_SHARD_RNG_TAG = 0x7073


def _shard_pulled_ts(topo: Topology, run: RunConfig, pull_time: np.ndarray,
                     pulled: np.ndarray, times: np.ndarray) -> np.ndarray:
    """Resolve the (steps, c, S) per-shard pulled timestamps.

    A pull initiated at ``pull_time[j, i]`` completes at shard ``s`` a skew
    δ ~ Exp(pull_jitter) seconds later (independent rng stream — the main
    arrival schedule is untouched); every update fired by then is visible
    in that shard's slice.  Clipped to [pulled_ts, j]: reads are monotone
    w.r.t. the logical pull and never see the future relative to the update
    the gradient folds into.  pull_jitter = 0 ⇒ exactly the broadcast slot
    timestamps (consistent snapshot reads) — returned directly, without the
    clock comparison: with deterministic duration samplers an update can
    fire at the *same instant* as a pull, and counting updates with
    time ≤ pull would spuriously show it to the shard.
    """
    steps, c = pulled.shape
    if topo.pull_jitter <= 0:
        return np.broadcast_to(pulled[:, :, None],
                               (steps, c, topo.shards)).astype(np.int32)
    jrng = np.random.default_rng([run.seed, _SHARD_RNG_TAG])
    view = (pull_time[:, :, None].astype(np.float64)
            + topo.pull_jitter * jrng.exponential(
                size=(steps, c, topo.shards)))
    seen = np.searchsorted(times, view.reshape(-1),
                           side="right").reshape(view.shape)
    lo = pulled[:, :, None].astype(np.int64)
    hi = np.arange(steps, dtype=np.int64)[:, None, None]
    return np.clip(seen, lo, hi).astype(np.int32)


class _MembershipCursor:
    """Orders a timeline's events against the schedule clock: ``peek_t``
    is the next unprocessed event's time (inf when exhausted), ``pop``
    consumes it and folds it into the per-learner activity vector."""

    def __init__(self, timeline: MembershipTimeline, n_learners: int):
        self.events = timeline.events
        self.i = 0
        self.active = timeline.initial_active(n_learners)

    def peek_t(self) -> float:
        return (self.events[self.i].t if self.i < len(self.events)
                else math.inf)

    def pop(self):
        ev = self.events[self.i]
        self.i += 1
        self.active[ev.learner] = ev.kind == "join"
        return ev


def _finish_masks(slot_on: np.ndarray, mmask: np.ndarray, gs: int):
    """(valid, member_valid) in their canonical None-when-dense forms."""
    valid = None if slot_on.all() else slot_on
    member_valid = None
    if gs > 1 and (~mmask & slot_on[:, :, None]).any():
        member_valid = mmask
    return valid, member_valid


def schedule(run: RunConfig, steps: int,
             duration_sampler: Optional[Callable] = None) -> ArrivalTrace:
    """Run the gradient-free event queue for ``steps`` updates.

    Identical arrival semantics (and rng draw order) to the legacy
    per-arrival loop; the only output is the trace.  With learner groups
    the pushing entities are the P groups — a group push draws its gs
    member durations in member order and completes at their max (the local
    aggregation barrier) — which for group_size = 1 reduces draw-for-draw
    to the ungrouped loop.  PS shards never change the arrival schedule;
    they only add the per-shard pulled-timestamp resolution
    (:func:`_shard_pulled_ts`).

    **Elastic membership** (``run.membership``) resolves here, entirely at
    schedule time: membership events interleave with arrivals in time
    order (an event at the same instant as an arrival applies first), a
    crashed pusher's in-flight push is dropped, a restarted learner
    re-pulls with fresh timestamps, and the n-softsync firing threshold
    follows the live pusher count c(t) = max(1, ⌊P(t)/n⌋).  A static
    timeline draws from the rng in exactly the pre-elastic order and
    returns a mask-free trace (pinned bitwise by ``tests/test_elastic.py``).
    ``run.backup`` = b (hardsync) commits the first P − b arrivals per
    round and cancels the rest (Chen et al. backup learners).
    """
    lam = run.n_learners
    topo = Topology.from_run(run)
    members = topo.members(lam)            # (P, gs) learner ids
    pushers, gs = members.shape
    rng = np.random.default_rng(run.seed)
    sampler = as_learner_sampler(duration_sampler or
                                 make_duration_sampler(run))
    mu = run.minibatch
    cur = _MembershipCursor(run.membership, lam)

    def draw_duration(p: int, mask: np.ndarray) -> float:
        # group-local barrier over the members present at dispatch: gs
        # member draws in member order, max of their durations (full
        # membership + gs = 1 ⇒ one draw, the legacy per-learner schedule)
        return max(sampler(rng, mu, int(m))
                   for m, on in zip(members[p], mask) if on)

    if run.protocol == "hardsync":
        trace = _schedule_hardsync(run, steps, topo, members, cur,
                                   draw_duration)
    else:
        trace = _schedule_queue(run, steps, topo, members, cur,
                                draw_duration)
    if run.serving is not None:
        # serving lane (DESIGN.md §14): resolved AFTER the arrival schedule
        # from its own rng stream, so attaching a fleet never perturbs the
        # trace — arrivals with/without serving are bitwise identical
        from repro_torch.serve.publication import schedule_serving
        trace = dataclasses.replace(
            trace, serving=schedule_serving(trace, run.serving, run.seed))
    return trace


# RunConfig fields the schedule pass NEVER reads — replay/runtime knobs
# only.  The lru key canonicalizes them to their defaults so e.g. a
# ring_impl × ring_dtype sweep over one protocol shape shares ONE cached
# trace instead of fragmenting the cache.  Every field NOT listed here is
# part of the cache key (the frozen-dataclass hash covers it), which is the
# audited guarantee that schedule-relevant fields — protocol, topology,
# membership, backup, durations, seed, the LR policy inputs — always key
# distinct traces.  ``tests/test_spmd.py::test_schedule_cached_field_audit``
# flips every RunConfig field and asserts its classification, so adding a
# field without triaging it here fails loudly.
_REPLAY_ONLY_FIELDS = (
    "momentum", "optimizer", "weight_decay",
    "ring_dtype", "ring_impl", "placement", "spmd_learners",
    "num_microbatches", "remat", "fsdp", "use_pallas",
    "attn_impl", "attn_q_chunk", "attn_kv_chunk", "unroll", "residual_spec",
)


def _schedule_key(run: RunConfig) -> RunConfig:
    """``run`` with replay-only fields reset to their defaults — the
    canonical cache key for :func:`schedule_cached`."""
    fields = {f.name: f for f in dataclasses.fields(RunConfig)}
    defaults = {name: fields[name].default for name in _REPLAY_ONLY_FIELDS}
    if all(getattr(run, k) == v for k, v in defaults.items()):
        return run
    return run.replace(**defaults)


@functools.lru_cache(maxsize=64)
def _schedule_cached(key: RunConfig, steps: int) -> ArrivalTrace:
    return schedule(key, steps)


def schedule_cached(run: RunConfig, steps: int) -> ArrivalTrace:
    """Memoized :func:`schedule` for the built-in duration models.

    ``schedule`` is a pure function of ``(run, steps)`` when no custom
    ``duration_sampler`` is supplied (the rng is seeded from ``run.seed``),
    yet the driver re-runs the full Python event queue every time the same
    grid point is replayed — in benchmark/sweep loops that schedule pass
    was a measurable slice of wall clock (~0.15 s per 96-step trace, paid
    per repeat).  The key is the full RunConfig with replay-only fields
    canonicalized away (``_REPLAY_ONLY_FIELDS``): membership/backup/
    topology/duration fields all hash into the key, while replay knobs
    (ring impl/dtype, placement, …) share a single entry.  Callers share
    ONE trace object per (canonical run, steps), so treat it as immutable —
    which every consumer already does; the arrays are replay *inputs*.
    Custom samplers (closures; unhashable, possibly stateful) must keep
    calling :func:`schedule` directly, as must benchmarks that time the
    schedule pass itself.
    """
    return _schedule_cached(_schedule_key(run), steps)


schedule_cached.cache_info = _schedule_cached.cache_info
schedule_cached.cache_clear = _schedule_cached.cache_clear


# placement_plan (SPMD placement, DESIGN.md §13) is not ported yet: see
# ROADMAP.md queue 1 item 8.


def _schedule_hardsync(run: RunConfig, steps: int, topo: Topology,
                       members: np.ndarray, cur: _MembershipCursor,
                       draw_duration: Callable) -> ArrivalTrace:
    """Barrier rounds: every live pusher computes its round aggregate on
    the round-start weights (timestamp = step); the round commits the
    first ``P_active − backup`` arrivals (in pusher order on the trace
    row) and cancels the rest.  Membership at the barrier: the active set
    is read at round start; a crash mid-round drops that member's
    contribution (the whole push if nobody survives); joins/leaves take
    effect at the next barrier."""
    lam = run.n_learners
    pushers, gs = members.shape
    b = run.backup
    W = run.gradients_per_update           # row-width bound: P − b
    learner = np.zeros((steps, W), np.int32)
    slot_on = np.zeros((steps, W), bool)
    mmask = np.ones((steps, W, gs), bool)
    times = np.zeros((steps,))
    t = 0.0
    for step in range(steps):
        # active set at the barrier; an all-dead cluster stalls until the
        # next join (the barrier cannot proceed with zero learners)
        while True:
            while cur.peek_t() <= t:
                cur.pop()
            act = cur.active[members]      # (P, gs)
            if act.any():
                break
            if cur.peek_t() == math.inf:
                raise ValueError(
                    f"cluster died: no active learners and no future joins "
                    f"at t={t:.3f} after {step}/{steps} hardsync rounds — "
                    f"extend the membership timeline")
            t = cur.peek_t()
        arrivals = []                      # [completion, pusher, mask]
        for p in range(pushers):
            if act[p].any():
                mask = act[p].copy()
                arrivals.append([t + draw_duration(p, mask), p, mask])
        commit_n = max(1, len(arrivals) - b)
        committed = []
        for comp, p, mask in sorted(arrivals, key=lambda a: (a[0], a[1])):
            # crashes up to this completion kill mid-round contributions
            # of every not-yet-finished push (same-instant events first)
            while cur.peek_t() <= comp:
                ev = cur.pop()
                if ev.kind == "crash":
                    cp, pos = divmod(ev.learner, gs)
                    for a in arrivals:
                        if a[1] == cp and a[0] >= ev.t:
                            a[2][pos] = False
            if mask.any():
                committed.append((comp, p, mask))
                if len(committed) == commit_n:
                    break
        if not committed:
            raise ValueError(
                f"hardsync round {step}: every in-flight push crashed "
                f"before completing (t={t:.3f}) — nothing to commit")
        t = committed[-1][0]               # the round barrier
        times[step] = t
        committed.sort(key=lambda a: a[1])  # trace rows in pusher order
        for i, (_, p, mask) in enumerate(committed):
            learner[step, i] = p
            slot_on[step, i] = True
            mmask[step, i] = mask
    rows = np.arange(steps, dtype=np.int32)[:, None]
    pulled = np.broadcast_to(rows, (steps, W)).copy()
    mb_idx = pulled.copy()
    lrs, mode = resolve_trace_lrs(run, pulled)
    shard_ts = None
    if topo.shards > 1:
        # the barrier implies consistent pulls: every shard slice is
        # the round-start snapshot
        shard_ts = np.broadcast_to(
            pulled[:, :, None], pulled.shape + (topo.shards,)).copy()
    valid, member_valid = _finish_masks(slot_on, mmask, gs)
    return ArrivalTrace(run.protocol, lam, learner, pulled, mb_idx,
                        times, lrs, mode, topo, shard_ts,
                        valid=valid, member_valid=member_valid)


def _schedule_queue(run: RunConfig, steps: int, topo: Topology,
                    members: np.ndarray, cur: _MembershipCursor,
                    draw_duration: Callable) -> ArrivalTrace:
    """softsync / async: the priority queue, with membership events
    interleaved in time order."""
    lam = run.n_learners
    pushers, gs = members.shape
    n = run.n_softsync
    W = run.gradients_per_update           # row-width bound (full cluster)
    heap = []                              # (completion, tiebreak, p, eid)
    recs = {}                              # eid -> member mask (mutable)
    in_flight = [None] * pushers           # live eid per pusher
    eid_next = 0

    learner = np.zeros((steps, W), np.int32)
    pulled = np.zeros((steps, W), np.int32)
    mb_idx = np.zeros((steps, W), np.int32)
    pull_time = np.zeros((steps, W))
    slot_on = np.zeros((steps, W), bool)
    mmask = np.ones((steps, W, gs), bool)
    times = np.zeros((steps,))
    pulled_ts = [0] * pushers
    pull_t = [0.0] * pushers               # when the pusher last pulled
    mb_done = [0] * pushers
    timestamp = 0
    slot = 0
    mb = 0

    def dispatch(p: int, t0: float, tiebreak) -> None:
        nonlocal eid_next
        mask = cur.active[members[p]].copy()
        eid = eid_next
        eid_next += 1
        recs[eid] = mask
        in_flight[p] = eid
        heapq.heappush(heap, (t0 + draw_duration(p, mask), tiebreak, p, eid))

    c_now = W

    def refresh_c() -> None:
        # n-softsync's splitting threshold follows the LIVE pusher count:
        # c(t) = max(1, ⌊P(t)/n⌋) (async: always 1)
        nonlocal c_now
        if run.protocol == "async":
            return
        p_act = int(topo.active_pushers(cur.active).sum())
        c_now = max(1, p_act // n)

    def apply_event(ev) -> None:
        p = ev.learner // gs
        if ev.kind == "join":
            if in_flight[p] is None:
                # the (re)joined learner pulls NOW: fresh timestamps, then
                # starts computing (an idle pusher comes back to life; a
                # pusher with survivors still computing picks the member
                # up at its next dispatch)
                pulled_ts[p] = timestamp
                pull_t[p] = ev.t
                dispatch(p, ev.t, mb + pushers)
        elif ev.kind == "crash":
            eid = in_flight[p]
            if eid is not None:
                mask = recs[eid]
                mask[ev.learner - p * gs] = False
                if not mask.any():         # the whole in-flight push is lost
                    in_flight[p] = None    # (its heap entry pops as a no-op)
        # graceful leave: the in-flight push still arrives; the learner
        # simply stops re-pulling (the redispatch check below)
        refresh_c()

    refresh_c()
    for p in range(pushers):
        if cur.active[members[p]].any():
            dispatch(p, 0.0, p)
    while timestamp < steps:
        # membership events interleave with arrivals in time order; an
        # event at the same instant as an arrival applies first (a join
        # may dispatch a push that lands before the current heap top)
        while cur.peek_t() <= (heap[0][0] if heap else math.inf):
            if cur.peek_t() == math.inf:
                break
            apply_event(cur.pop())
        if not heap:
            raise ValueError(
                f"cluster died: no active learners and no future joins "
                f"after {timestamp}/{steps} updates — extend the "
                f"membership timeline")
        t, _, p, eid = heapq.heappop(heap)
        mask = recs.pop(eid)
        if in_flight[p] == eid:
            in_flight[p] = None
        if not mask.any():
            continue                       # crashed-out push: dropped
        mb += 1
        learner[timestamp, slot] = p
        pulled[timestamp, slot] = pulled_ts[p]
        pull_time[timestamp, slot] = pull_t[p]
        mb_idx[timestamp, slot] = mb_done[p]
        slot_on[timestamp, slot] = True
        mmask[timestamp, slot] = mask
        mb_done[p] += 1
        slot += 1
        if slot >= c_now:                  # the PS fires
            times[timestamp] = t
            timestamp += 1
            slot = 0
        # pullWeights: pick up the current timestamp
        pulled_ts[p] = timestamp
        pull_t[p] = t
        if cur.active[members[p]].any():
            dispatch(p, t, mb + pushers)
        else:
            in_flight[p] = None            # left/crashed: stops pushing

    # unfilled slots carry benign placeholders: σ = 0 weights (the row's
    # own timestamp), learner 0's minibatch 0, and — through event_coef —
    # coefficient 0 in the replay, so their gradient never contributes
    rows = np.broadcast_to(np.arange(steps, dtype=np.int32)[:, None],
                           (steps, W))
    pulled = np.where(slot_on, pulled, rows)
    pull_time = np.where(slot_on, pull_time, times[:, None])
    lrs, mode = resolve_trace_lrs(run, pulled)
    shard_ts = None
    if topo.shards > 1:
        shard_ts = _shard_pulled_ts(topo, run, pull_time, pulled, times)
    valid, member_valid = _finish_masks(slot_on, mmask, gs)
    return ArrivalTrace(run.protocol, lam, learner, pulled, mb_idx,
                        times, lrs, mode, topo, shard_ts,
                        valid=valid, member_valid=member_valid)
