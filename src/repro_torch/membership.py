"""Elastic cluster membership: join / leave / crash-restart timelines
(DESIGN.md §7).

The paper's tradeoff study holds the learner population λ fixed, but its
runtime model is most interesting on a *changing* cluster (Chen et al.,
"Revisiting Distributed Synchronous SGD"; Dutta et al., "Slow and Stale
Gradients Can Win the Race").  A :class:`MembershipTimeline` declares that
change as a sorted sequence of per-learner transitions:

* ``join``  — the learner (re-)enters the cluster: it pulls the current
  weights (fresh timestamps) and starts computing.  A learner whose FIRST
  event is a join starts the run inactive.
* ``leave`` — graceful departure: the learner's in-flight push still
  arrives (the work was already under way), then it stops pulling.
* ``crash`` — failure: the learner's in-flight push is DROPPED; it only
  returns via a later ``join`` (crash + join = crash-restart).

The timeline is *declarative data* on :class:`~repro_torch.config.RunConfig`
(hence an ``ExperimentSpec``/``Sweep`` axis): membership resolves entirely
in the schedule pass of the simulator (``core/trace.py``) — joins/leaves
move the effective λ(t) that n-softsync's splitting threshold c(t) =
max(1, ⌊P(t)/n⌋) is computed from, and cancelled pushes become a per-event
validity mask on the :class:`~repro_torch.core.trace.ArrivalTrace`, so the
compiled replay engine needs no per-event branching.  An empty timeline is
**static** and reproduces the pre-elastic schedule bit-for-bit
(``tests/test_elastic.py``).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Iterable, Optional, Tuple

import numpy as np

EVENT_KINDS = ("join", "leave", "crash")


@dataclasses.dataclass(frozen=True, order=True)
class MembershipEvent:
    """One membership transition at simulated time ``t`` (seconds on the
    schedule clock).  Ordering is (t, learner, kind): events at the same
    instant apply in learner order, and a same-time crash precedes a join
    ("crash" < "join" alphabetically), so crash-at-t + join-at-t is a
    valid zero-delay restart."""

    t: float
    learner: int
    kind: str

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"membership event kind must be one of "
                             f"{EVENT_KINDS}, got {self.kind!r}")
        if self.t < 0:
            raise ValueError(f"membership event time must be >= 0, "
                             f"got {self.t}")
        if self.learner < 0:
            raise ValueError(f"membership event learner must be >= 0, "
                             f"got {self.learner}")


def _as_event(e) -> MembershipEvent:
    if isinstance(e, MembershipEvent):
        return e
    if isinstance(e, dict):
        return MembershipEvent(**e)
    return MembershipEvent(*e)


@dataclasses.dataclass(frozen=True)
class MembershipTimeline:
    """A sorted tuple of :class:`MembershipEvent`.  Hashable and frozen —
    usable as a RunConfig field and a Sweep axis value.  Events may be
    given as ``MembershipEvent``, ``(t, learner, kind)`` tuples, or dicts;
    they are normalized and sorted on construction."""

    events: Tuple[MembershipEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events", tuple(sorted(_as_event(e) for e in self.events)))

    # -- constructors --------------------------------------------------------
    @classmethod
    def crash_restart(cls, learners: Iterable[int], crash_at: float,
                      restart_after: Optional[float] = None
                      ) -> "MembershipTimeline":
        """Crash ``learners`` at ``crash_at``; restart each ``restart_after``
        seconds later (None = no restart: the learners stay gone)."""
        evs = []
        for l in learners:
            evs.append(MembershipEvent(crash_at, int(l), "crash"))
            if restart_after is not None:
                evs.append(MembershipEvent(crash_at + restart_after,
                                           int(l), "join"))
        return cls(tuple(evs))

    @classmethod
    def leaves(cls, learners: Iterable[int], at: float
               ) -> "MembershipTimeline":
        """Graceful departure of ``learners`` at time ``at``."""
        return cls(tuple(MembershipEvent(at, int(l), "leave")
                         for l in learners))

    def merged(self, other: "MembershipTimeline") -> "MembershipTimeline":
        """The union of two timelines (events re-sorted)."""
        return MembershipTimeline(self.events + other.events)

    # -- queries -------------------------------------------------------------
    @property
    def static(self) -> bool:
        """True iff the cluster never changes (the pre-elastic world)."""
        return not self.events

    def validate_for(self, n_learners: int) -> "MembershipTimeline":
        """Check learner ids against λ and per-learner transition sanity:
        join only while inactive, leave/crash only while active (a learner
        whose first event is a join starts inactive)."""
        per = {}
        for ev in self.events:
            per.setdefault(ev.learner, []).append(ev)
        for l, evs in per.items():
            if l >= n_learners:
                raise ValueError(
                    f"membership event names learner {l} but the run has "
                    f"n_learners={n_learners} (ids are 0-based)")
            active = evs[0].kind != "join"
            for ev in evs:
                if ev.kind == "join":
                    if active:
                        raise ValueError(
                            f"learner {l} joins at t={ev.t} while already "
                            f"active (missing leave/crash before it)")
                    active = True
                else:
                    if not active:
                        raise ValueError(
                            f"learner {l} {ev.kind}s at t={ev.t} while "
                            f"inactive (missing join before it)")
                    active = False
        return self

    def initial_active(self, n_learners: int) -> np.ndarray:
        """(λ,) bool — who is in the cluster at t = 0.  A learner is
        initially active unless its first event is a ``join``."""
        active = np.ones(n_learners, bool)
        seen = set()
        for ev in self.events:
            if ev.learner not in seen:
                seen.add(ev.learner)
                if ev.kind == "join":
                    active[ev.learner] = False
        return active

    def __str__(self):
        if not self.events:
            return "static"
        kinds = Counter(ev.kind for ev in self.events)
        return "+".join(f"{kinds[k]}{k}" for k in EVENT_KINDS if kinds[k])
