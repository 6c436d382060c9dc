"""Staleness-bounded weight publication: PS ring → serving fleet (DESIGN.md §14).

The paper measures the accuracy cost of stale weights during *training*;
the north-star scenario — serving live traffic while learners keep pushing
— poses the same staleness/runtime tradeoff on the *inference* side.  This
module is the schedule half of that serving lane: given a scheduled
:class:`~repro_torch.core.trace.ArrivalTrace` and a declarative
:class:`~repro_torch.serve.fleet.FleetConfig`, resolve — entirely host-side, in
numpy — when each serving replica *publishes* (reads the newest row of the
(K, D) weight ring; never a copy of live training state), which published
version serves each inference request, and what each request's staleness
and latency are.  The result is a :class:`ServingTrace` riding on the
arrival trace; the replay engine (``core/engine.py``) captures exactly the
published ring rows in its compiled scan and evaluates request batches
against them.

Publication semantics (the exactly-testable contract):

* A publication at time t reads the **newest** ring row — the snapshot of
  version v(t) = |{update events with fire time ≤ t}|.  Version swap is
  atomic at the read instant; ``publish_cost_s`` models the transfer pause
  (it blocks the replica's request queue, surfacing in latency — never in
  which version a request sees).
* Refreshes and membership events apply before same-instant requests (the
  same tie rule the schedule pass uses), so a ``staleness`` policy's
  budget holds at *every* request: version lag ≤ B, always.
* Serving resolution draws from an rng stream tagged independently of the
  arrival schedule (cf. ``_SHARD_RNG_TAG`` in ``core/trace.py``), so a
  run with serving schedules bit-identical arrivals to one without.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

PUBLICATION_KINDS = ("every_n", "staleness", "time", "on_demand")

# rng stream tag for serving traffic: request arrivals must never perturb
# the main arrival stream (with/without serving schedule identical traces)
_SERVE_RNG_TAG = 0x5345


@dataclasses.dataclass(frozen=True)
class PublicationPolicy:
    """When a replica refreshes its published weights from the PS ring.

    * ``every_n``   — publish each N-th version as it is born (N =
      ``every``): the replica's held version is always the latest multiple
      of N, so version lag ≤ N − 1.
    * ``staleness`` — staleness budget in versions: refresh the instant the
      lag *would* exceed ``max_version_lag`` = B, reading the newest
      version (catch-up).  Lag ≤ B at every request, exactly.
    * ``time``      — staleness budget in seconds: refresh the instant the
      newest version's birth time exceeds the held version's by more than
      ``max_time_lag`` = T.  Seconds-lag ≤ T at every request.
    * ``on_demand`` — each request reads the newest version at its arrival
      (lag 0 always; the publish cost is paid per version change, per
      request, on the serving path).
    """

    kind: str = "staleness"
    every: int = 1                 # every_n: publish each N-th version
    max_version_lag: int = 4       # staleness: budget B in versions
    max_time_lag: float = 10.0     # time: budget T in simulated seconds

    def __post_init__(self):
        if self.kind not in PUBLICATION_KINDS:
            raise ValueError(f"unknown publication kind {self.kind!r}: "
                             f"expected one of {PUBLICATION_KINDS}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.max_version_lag < 0:
            raise ValueError(f"max_version_lag must be >= 0, "
                             f"got {self.max_version_lag}")
        if self.max_time_lag <= 0:
            raise ValueError(f"max_time_lag must be > 0, "
                             f"got {self.max_time_lag}")

    def __str__(self):
        if self.kind == "every_n":
            return f"every{self.every}"
        if self.kind == "staleness":
            return f"lag<={self.max_version_lag}"
        if self.kind == "time":
            return f"lag<={self.max_time_lag:g}s"
        return "on_demand"


@dataclasses.dataclass(frozen=True)
class ServingTrace:
    """The resolved serving lane of one arrival trace, as dense host arrays
    (frozen like :class:`~repro_torch.core.trace.ArrivalTrace` — treat the arrays
    as immutable replay inputs).

    Per-request arrays have length R (``request_time`` order); a dropped
    request (no replica alive at arrival) has ``replica`` −1 and zeros in
    the result columns.  ``pub_versions`` is the sorted set of versions the
    fleet ever published (version 0 = the init weights every replica boots
    with); ``req_pub[i]`` indexes the version serving request i, which is
    how the replay engine's snapshot buffer maps captured ring rows to
    requests.
    """

    horizon: float
    n_replicas: int
    request_time: np.ndarray     # (R,) float64 — arrival times, sorted
    replica: np.ndarray          # (R,) int32 — serving replica, −1 dropped
    version: np.ndarray          # (R,) int32 — published version served
    staleness: np.ndarray        # (R,) int32 — version lag at arrival
    staleness_s: np.ndarray      # (R,) float64 — seconds lag at arrival
    latency: np.ndarray          # (R,) float64 — completion − arrival
    refresh_time: np.ndarray     # (F,) float64 — publication instants
    refresh_replica: np.ndarray  # (F,) int32
    refresh_version: np.ndarray  # (F,) int32 — version read at the refresh
    pub_versions: np.ndarray     # (P,) int32 — sorted unique published
    req_pub: np.ndarray          # (R,) int32 — index into pub_versions
    truncated: bool = False      # traffic hit FleetConfig.max_requests

    @property
    def n_requests(self) -> int:
        return int(self.request_time.shape[0])

    @property
    def served(self) -> np.ndarray:
        """(R,) bool — requests a live replica answered."""
        return self.replica >= 0

    @property
    def n_refreshes(self) -> int:
        return int(self.refresh_time.shape[0])


def _poisson_arrivals(rng: np.random.Generator, fleet,
                      horizon: float) -> Tuple[np.ndarray, bool]:
    """Traffic generator: homogeneous Poisson at ``request_rate``, or — with
    ``diurnal_amplitude`` A > 0 — the inhomogeneous diurnal rate
    ``rate·(1 + A·sin(2πt/period))`` via thinning (period 0 = one cycle
    over the horizon).  Returns (arrival times, truncated-at-cap flag)."""
    rate = fleet.request_rate
    A = fleet.diurnal_amplitude
    period = fleet.diurnal_period or max(horizon, 1e-9)
    rmax = rate * (1.0 + A)
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rmax)
        if t >= horizon:
            return np.asarray(out, np.float64), False
        if A > 0:
            lam_t = rate * (1.0 + A * math.sin(2.0 * math.pi * t / period))
            if rng.uniform() * rmax > lam_t:
                continue
        out.append(t)
        if len(out) >= fleet.max_requests:
            return np.asarray(out, np.float64), True


def _live_intervals(timeline, n: int) -> List[List[Tuple[float, float]]]:
    """Per-replica [start, end) liveness windows from a membership timeline
    (kinds collapse to alive/dead: ``leave`` and ``crash`` both take the
    replica out until its next ``join``; ``validate_for`` already ran)."""
    active0 = timeline.initial_active(n)
    out: List[List[Tuple[float, float]]] = [[] for _ in range(n)]
    cur = [0.0 if active0[r] else None for r in range(n)]
    for ev in timeline.events:
        r = ev.learner
        if ev.kind == "join":
            cur[r] = ev.t
        elif cur[r] is not None:
            out[r].append((cur[r], ev.t))
            cur[r] = None
    for r in range(n):
        if cur[r] is not None:
            out[r].append((cur[r], math.inf))
    return out


def _replica_refreshes(policy: PublicationPolicy, segments, times, birth,
                       steps: int):
    """One replica's publication instants and the versions each read.

    Every live segment boots with a publication at its start (version 0 on
    a t = 0 boot: the init weights); scheduled refreshes then follow the
    policy, each reading the newest version at the refresh instant
    (catch-up — a ring read is always of the latest row).  ``on_demand``
    schedules no refreshes beyond boot (requests read at arrival)."""
    r_t: List[float] = []
    r_v: List[int] = []
    for (s, e) in segments:
        h = int(np.searchsorted(times, s, side="right"))
        r_t.append(s)
        r_v.append(h)
        if policy.kind == "on_demand":
            continue
        while True:
            if policy.kind == "every_n":
                v = (h // policy.every + 1) * policy.every
            elif policy.kind == "staleness":
                v = h + policy.max_version_lag + 1
            else:                                  # "time"
                v = int(np.searchsorted(
                    birth, birth[h] + policy.max_time_lag, side="right"))
            if v > steps:
                break
            tv = float(times[v - 1])               # version v's birth instant
            if tv >= e:
                break                              # replica dies first
            h = int(np.searchsorted(times, tv, side="right"))   # catch up
            r_t.append(tv)
            r_v.append(h)
    return np.asarray(r_t, np.float64), np.asarray(r_v, np.int64)


def schedule_serving(trace, fleet, seed: int = 0) -> ServingTrace:
    """Resolve the serving lane of a scheduled trace (host-side, numpy).

    Interleaves — in time order, with refresh/membership-before-request at
    ties — the fleet's publication refreshes, the traffic generator's
    request arrivals, and replica churn, against the trace's update-event
    clock.  Pure in (trace, fleet, seed); the rng stream is independent of
    the arrival schedule's.
    """
    times = np.asarray(trace.event_time, np.float64)        # (steps,)
    steps = int(times.shape[0])
    horizon = float(times[-1]) if steps else 0.0
    birth = np.concatenate([[0.0], times])  # birth[v] = when version v arose
    n = fleet.replicas

    rng = np.random.default_rng([seed, _SERVE_RNG_TAG])
    req_t, truncated = _poisson_arrivals(rng, fleet, horizon)
    R = int(req_t.shape[0])
    v_now = np.searchsorted(times, req_t, side="right").astype(np.int64)

    segments = _live_intervals(fleet.membership, n)
    per_t, per_v = [], []
    for r in range(n):
        rt, rv = _replica_refreshes(fleet.policy, segments[r], times, birth,
                                    steps)
        per_t.append(rt)
        per_v.append(rv)

    # --- request → replica: round-robin over the replicas alive at arrival
    alive = np.zeros((R, n), bool)
    for r in range(n):
        for (s, e) in segments[r]:
            alive[:, r] |= (req_t >= s) & (req_t < e)
    replica = np.full(R, -1, np.int32)
    rr = 0
    for i in range(R):
        live = np.flatnonzero(alive[i])
        if live.size:
            replica[i] = live[rr % live.size]
            rr += 1

    # --- request → published version (the replica's last refresh ≤ t;
    # refreshes apply before same-instant requests via side="right")
    version = np.zeros(R, np.int64)
    for r in range(n):
        m = replica == r
        if not m.any():
            continue
        if fleet.policy.kind == "on_demand":
            version[m] = v_now[m]                 # read at arrival: lag 0
        else:
            k = np.searchsorted(per_t[r], req_t[m], side="right") - 1
            version[m] = per_v[r][np.maximum(k, 0)]
    served = replica >= 0
    version[~served] = 0
    staleness = np.where(served, v_now - version, 0).astype(np.int64)
    staleness_s = np.where(served, birth[v_now] - birth[version], 0.0)

    # --- latency: per-replica FIFO queue; a scheduled publication blocks
    # the replica for publish_cost_s, a request for the service time (on
    # demand additionally pays the publish cost whenever its read actually
    # advances the replica's version)
    service = (fleet.service_base_s
               + fleet.service_per_sample_s * fleet.request_samples)
    latency = np.zeros(R, np.float64)
    for r in range(n):
        req_idx = np.flatnonzero(replica == r)
        # merge refreshes (prio 0: before same-instant requests) + requests
        ev = ([(float(t), 0, int(v)) for t, v in zip(per_t[r], per_v[r])]
              + [(float(req_t[i]), 1, int(i)) for i in req_idx])
        ev.sort(key=lambda e: (e[0], e[1]))
        free = 0.0
        held = -1
        for (t, prio, payload) in ev:
            if prio == 0:
                dur = fleet.publish_cost_s
                held = payload
            else:
                dur = service
                if (fleet.policy.kind == "on_demand"
                        and int(v_now[payload]) != held):
                    dur += fleet.publish_cost_s
                    held = int(v_now[payload])
            start = max(t, free)
            free = start + dur
            if prio == 1:
                latency[payload] = free - t

    refresh_time = np.concatenate(per_t) if per_t else np.zeros(0)
    refresh_replica = np.concatenate(
        [np.full(per_t[r].shape[0], r, np.int32) for r in range(n)]
    ) if per_t else np.zeros(0, np.int32)
    refresh_version = (np.concatenate(per_v).astype(np.int64)
                       if per_v else np.zeros(0, np.int64))
    order = np.lexsort((refresh_replica, refresh_time))
    pub_versions = np.unique(np.concatenate(
        [np.zeros(1, np.int64), refresh_version, version[served]]))
    req_pub = np.searchsorted(pub_versions, version).astype(np.int32)
    req_pub[~served] = 0

    return ServingTrace(
        horizon=horizon, n_replicas=n,
        request_time=req_t,
        replica=replica,
        version=version.astype(np.int32),
        staleness=staleness.astype(np.int32),
        staleness_s=staleness_s.astype(np.float64),
        latency=latency,
        refresh_time=refresh_time[order],
        refresh_replica=refresh_replica[order],
        refresh_version=refresh_version[order].astype(np.int32),
        pub_versions=pub_versions.astype(np.int32),
        req_pub=req_pub,
        truncated=truncated)
