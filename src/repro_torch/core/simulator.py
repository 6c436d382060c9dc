"""Simulation result record (counterpart of ``repro/core/simulator.py``; only
``SimResult`` is ported — the legacy per-arrival oracle ``simulate`` waits,
ROADMAP.md queue 1 item 7)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.clock import VectorClockLog


@dataclasses.dataclass
class SimResult:
    clock_log: VectorClockLog
    updates: int
    simulated_time: float
    minibatches: int
    params: Optional[object] = None
    history: Optional[List[Dict]] = None   # eval trace
    # train-while-serve result; the port's engine has no serving lane yet
    serving: Optional[object] = None
