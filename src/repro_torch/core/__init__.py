"""Core of the port: the host-side schedule pass (``trace``), the replay
engine (``engine``) that drives the CUDA ring kernels, the legacy
per-arrival oracle (``simulator``) whose host PS (``protocols``) drives the
CUDA ``ps_apply`` kernel, and the round-based training engines
(``distributed``: hardsync, sequential and fused softsync)."""

from repro_torch.core.clock import StalenessRecord, VectorClockLog
from repro_torch.core.engine import replay, resolve_device
from repro_torch.core.protocols import (ParameterServerState, init_ps_state,
                                        tree_mean)
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.topology import RUDRA_ARCHS, Topology
from repro_torch.core.trace import (ArrivalTrace, make_duration_sampler,
                                    schedule, schedule_cached)
from repro_torch.membership import MembershipEvent, MembershipTimeline
from repro_torch.core.distributed import (fused_coefficients, init_opt_state,
                                          make_hardsync_step,
                                          make_softsync_step,
                                          make_train_step, round_event_lrs)

__all__ = [
    "StalenessRecord", "VectorClockLog", "replay", "resolve_device",
    "ParameterServerState", "init_ps_state", "tree_mean", "SimResult",
    "simulate", "RUDRA_ARCHS", "Topology", "ArrivalTrace",
    "make_duration_sampler", "schedule", "schedule_cached",
    "MembershipEvent", "MembershipTimeline",
    "make_train_step", "make_hardsync_step", "make_softsync_step",
    "init_opt_state", "round_event_lrs", "fused_coefficients",
]
