"""Core of the port: the host-side schedule pass (``trace``) and the replay
engine (``engine``) that drives the CUDA ring kernels."""

from repro_torch.core.clock import StalenessRecord, VectorClockLog
from repro_torch.core.engine import replay, resolve_device
from repro_torch.core.protocols import init_ps_state
from repro_torch.core.simulator import SimResult
from repro_torch.core.topology import RUDRA_ARCHS, Topology
from repro_torch.core.trace import (ArrivalTrace, make_duration_sampler,
                                    schedule, schedule_cached)
from repro_torch.membership import MembershipEvent, MembershipTimeline

__all__ = [
    "StalenessRecord", "VectorClockLog", "replay", "resolve_device",
    "init_ps_state", "SimResult", "RUDRA_ARCHS", "Topology", "ArrivalTrace",
    "make_duration_sampler", "schedule", "schedule_cached",
    "MembershipEvent", "MembershipTimeline",
]
