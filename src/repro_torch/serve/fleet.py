"""Serving-fleet declaration and results for train-while-serve (DESIGN.md §14).

:class:`FleetConfig` is the declarative half: how many serving replicas, the
:class:`~repro_torch.serve.publication.PublicationPolicy` they refresh under, the
traffic they face, and their cost model.  It is frozen and hashable so it
rides on ``RunConfig`` (and therefore through ``schedule_cached`` and the
sweep axes) like every other knob.  Replica churn reuses
:class:`~repro_torch.membership.MembershipTimeline` from the elastic subsystem —
the timeline indexes serving replicas here, not learners.

:class:`ServingResult` is the measured half: the resolved
:class:`~repro_torch.serve.publication.ServingTrace` plus the per-request quality
metric the replay engine evaluated against each request's *published*
weight version, with the summary statistics the benchmarks and the
experiment driver report.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.membership import MembershipTimeline
from repro_torch.serve.publication import PublicationPolicy, ServingTrace


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """N serving replicas refreshing published weights from the PS ring.

    The cost model is deliberately minimal (a per-replica FIFO: a
    publication blocks for ``publish_cost_s``, a request for
    ``service_base_s + service_per_sample_s * request_samples``), because
    its only job is to surface the policy tradeoff: tighter staleness
    budgets → more publication pauses → higher tail latency; looser
    budgets → staler served versions → lower serving accuracy.
    """

    replicas: int = 2
    policy: PublicationPolicy = PublicationPolicy()
    request_rate: float = 4.0            # mean requests/s across the fleet
    request_samples: int = 32            # samples per request batch
    diurnal_amplitude: float = 0.0       # 0 = homogeneous Poisson traffic
    diurnal_period: float = 0.0          # seconds; 0 = one cycle per horizon
    service_base_s: float = 0.02
    service_per_sample_s: float = 5e-4
    publish_cost_s: float = 0.05
    max_requests: int = 200_000          # traffic cap (ServingTrace.truncated)
    membership: MembershipTimeline = MembershipTimeline()

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if not isinstance(self.policy, PublicationPolicy):
            raise ValueError("policy must be a PublicationPolicy, "
                             f"got {type(self.policy).__name__}")
        if self.request_rate <= 0:
            raise ValueError(f"request_rate must be > 0, "
                             f"got {self.request_rate}")
        if self.request_samples < 1:
            raise ValueError(f"request_samples must be >= 1, "
                             f"got {self.request_samples}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1), "
                             f"got {self.diurnal_amplitude}")
        if self.diurnal_period < 0:
            raise ValueError(f"diurnal_period must be >= 0, "
                             f"got {self.diurnal_period}")
        for name in ("service_base_s", "service_per_sample_s",
                     "publish_cost_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if self.max_requests < 1:
            raise ValueError(f"max_requests must be >= 1, "
                             f"got {self.max_requests}")
        membership = self.membership
        if not isinstance(membership, MembershipTimeline):
            membership = MembershipTimeline(membership)
            object.__setattr__(self, "membership", membership)
        membership.validate_for(self.replicas)

    def __str__(self):
        tag = f"{self.replicas}x[{self.policy}]@{self.request_rate:g}rps"
        if self.membership.events:
            tag += f"+{self.membership}"
        return tag


@dataclasses.dataclass(frozen=True)
class ServingResult:
    """Serving-lane output of one replay: the resolved trace plus the
    per-request quality metric (e.g. accuracy of the request batch under
    the published weights that served it; 0 for dropped requests)."""

    trace: ServingTrace
    request_metric: np.ndarray           # (R,) float32
    metric_name: str = "accuracy"

    def summary(self) -> dict:
        """Aggregate statistics for benchmarks / the experiment driver."""
        t = self.trace
        served = t.served
        n_served = int(served.sum())
        lat = t.latency[served]
        stale = t.staleness[served]

        def _q(a, q):
            return float(np.quantile(a, q)) if a.size else 0.0

        return {
            "metric_name": self.metric_name,
            "n_requests": t.n_requests,
            "n_served": n_served,
            "n_dropped": t.n_requests - n_served,
            "n_refreshes": t.n_refreshes,
            "accuracy": (float(self.request_metric[served].mean())
                         if n_served else 0.0),
            "staleness_mean": float(stale.mean()) if n_served else 0.0,
            "staleness_max": int(stale.max()) if n_served else 0,
            "staleness_s_mean": (float(t.staleness_s[served].mean())
                                 if n_served else 0.0),
            "latency_p50_s": _q(lat, 0.50),
            "latency_p99_s": _q(lat, 0.99),
            "requests_per_s": (n_served / t.horizon if t.horizon > 0
                               else 0.0),
            "truncated": bool(t.truncated),
        }
