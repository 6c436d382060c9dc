"""PS topology: sharded parameter servers + hierarchical learner groups
(DESIGN.md §6).

The paper's runtime results come from Rudra's *scaled* architectures
(§3.2/3.3), which differ from the flat Rudra-base server in two structural
ways that this module describes declaratively:

* **Parameter-server sharding** (Rudra-adv): the flat weight buffer is
  partitioned into ``S`` contiguous equal-width shards, each an independent
  server with its own clock.  Learners pull the S slices as S separate
  messages, so the assembled weight vector a learner computes its gradient
  from may mix slices of *different* timestamps — the paper's "weights that
  may never have existed as one consistent version" (§3.1).  The schedule
  pass models this with a per-(pull, shard) completion skew
  (``RunConfig.shard_pull_jitter``, simulated seconds): updates landing
  between the logical pull and a shard's completion are visible in that
  shard's slice, giving shard-local staleness σ_s ≤ σ.

* **Hierarchical learner groups** (Rudra-adv*): the λ learners are
  partitioned into ``G`` contiguous groups of ``λ/G`` members.  A group
  aggregates member gradients locally (the learner broadcast tree) and
  pushes ONE averaged gradient; the PS sees G pushers instead of λ, and a
  group push takes the max of its members' compute durations (the local
  mini-barrier).

``Topology(shards=1, groups=0)`` is Rudra-base and degenerates *exactly* to
the pre-topology path: the trace layout, rng draw order, and replay scan
body are unchanged (pinned by ``tests/test_topology.py``).

Shard packing is equal-width: shard ``s`` owns ``flat[s·Dp : (s+1)·Dp]``
with ``Dp = ⌈D/S⌉`` and the last shard zero-padded — padding stays
identically zero through sgd/momentum/adagrad events, so packing is purely
a layout choice (the partition-invariance property in
``tests/test_topology.py`` holds for *any* boundary).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# Rudra architecture presets (the paper's names).  `for_arch` resolves one
# against a learner count; benchmarks/topology_scaling.py sweeps them.
RUDRA_ARCHS = ("base", "adv", "adv*")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Declarative PS topology.  Hashable → usable as a jit static.

    ``shards``  — S parameter-server shards over the flat weight buffer
                  (1 = the flat Rudra-base server).
    ``groups``  — G learner groups with group-level gradient aggregation
                  (0 = ungrouped: every learner pushes directly; G = λ is
                  equivalent — every group has one member).
    ``pull_jitter`` — per-(pull, shard) completion skew in simulated
                  seconds (0 = consistent snapshot reads; only meaningful
                  for S > 1).
    """

    shards: int = 1
    groups: int = 0
    pull_jitter: float = 0.0

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.groups < 0:
            raise ValueError(f"groups must be >= 0, got {self.groups}")
        if self.pull_jitter < 0:
            raise ValueError(f"pull_jitter must be >= 0, got {self.pull_jitter}")

    @classmethod
    def from_run(cls, run) -> "Topology":
        """The topology a RunConfig describes (validated against its λ)."""
        jitter = run.shard_pull_jitter
        topo = cls(shards=run.shards, groups=run.groups, pull_jitter=jitter)
        return topo.validate_for(run.n_learners)

    @classmethod
    def for_arch(cls, arch: str, lam: int, jitter: float = 0.0) -> "Topology":
        """Rudra preset → topology at λ learners.

        * ``base`` — flat PS, no groups.
        * ``adv``  — sharded PS (S = min(8, λ), the paper's PS-tree fanout).
        * ``adv*`` — sharded PS + learner groups of ~4 (the learner
          broadcast tree); pass ``jitter`` to enable inconsistent reads.
        """
        if arch == "base":
            return cls()
        shards = max(1, min(8, lam))
        if arch == "adv":
            return cls(shards=shards, pull_jitter=jitter)
        if arch == "adv*":
            for size in (4, 3, 2):
                if lam % size == 0:
                    groups = lam // size
                    return cls(shards=shards, groups=groups, pull_jitter=jitter)
            if lam == 1:
                return cls(shards=shards, pull_jitter=jitter)
            raise ValueError(
                f"adv* needs learner groups but λ={lam} has no group size "
                f"in (4, 3, 2); pick a divisible λ or build the Topology "
                f"explicitly"
            )
        raise ValueError(f"arch must be one of {RUDRA_ARCHS}, got {arch!r}")

    def validate_for(self, n_learners: int) -> "Topology":
        if self.groups and n_learners % self.groups != 0:
            raise ValueError(f"groups={self.groups} must divide λ={n_learners}")
        return self

    @property
    def grouped(self) -> bool:
        return self.groups > 0

    def n_pushers(self, n_learners: int) -> int:
        """Entities pushing gradients at the PS: groups, or raw learners."""
        return self.groups if self.grouped else n_learners

    def group_size(self, n_learners: int) -> int:
        """Members per pushing entity (1 ⇔ no effective grouping)."""
        if not self.grouped:
            return 1
        self.validate_for(n_learners)
        return n_learners // self.groups

    def members(self, n_learners: int) -> np.ndarray:
        """(P, gs) int32 learner ids of each pusher (contiguous blocks)."""
        gs = self.group_size(n_learners)
        return np.arange(n_learners, dtype=np.int32).reshape(-1, gs)

    def active_pushers(self, learner_active: np.ndarray) -> np.ndarray:
        """(P,) bool — which pushers are alive given a per-learner activity
        vector: a group keeps pushing as long as ONE member lives, and its
        pushes aggregate over the surviving members (the membership ×
        groups rule, DESIGN.md §7).  Ungrouped: the learners themselves."""
        active = np.asarray(learner_active, bool)
        return active[self.members(active.shape[0])].any(axis=1)

    def is_trivial(self, n_learners: int) -> bool:
        """Rudra-base: one shard, one learner per pusher — today's path."""
        return self.shards == 1 and self.group_size(n_learners) == 1

    def padded_width(self, dim: int) -> int:
        """Per-shard width Dp = ⌈D/S⌉ (last shard zero-padded)."""
        return -(-dim // self.shards)

    def shard_bounds(self, dim: int) -> List[Tuple[int, int]]:
        """[lo, hi) slice of the flat buffer owned by each shard."""
        dp = self.padded_width(dim)
        spans = [(s * dp, (s + 1) * dp) for s in range(self.shards)]
        return [(min(lo, dim), min(hi, dim)) for lo, hi in spans]

    def describe(self, n_learners: int) -> str:
        shape = f"shards={self.shards} groups={self.groups}"
        pushers = self.n_pushers(n_learners)
        size = self.group_size(n_learners)
        detail = f"pushers={pushers}, group_size={size}"
        return f"{shape} ({detail}, pull_jitter={self.pull_jitter})"
