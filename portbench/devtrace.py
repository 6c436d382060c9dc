"""Reading a ``torch.profiler`` trace of the measured window: device
operations by name and time, the device's busy union, idle gaps labelled
with what the host was doing, and the window's own span.

The trace goes through the profiler's Chrome-trace export to a file under
``TMPDIR``, which is read back and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")

Span = Tuple[str, float, float]          # name, start µs, end µs


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[Span] = []
        self.host: List[Span] = []
        self.window: Optional[Tuple[float, float]] = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            span = (e.get("name", ""), ts, ts + dur)
            if cat in DEVICE_CATS:
                self.device.append(span)
            elif cat in HOST_CATS:
                if cat == "user_annotation" and span[0] == WINDOW_SPAN:
                    self.window = (span[1], span[2])
                else:
                    self.host.append(span)
        self.device.sort(key=lambda s: s[1])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return cls(events)

    # -- the window --------------------------------------------------------
    def window_s(self) -> Optional[float]:
        if self.window is None:
            return None
        return (self.window[1] - self.window[0]) * 1e-6

    def _in_window(self) -> List[Span]:
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device
                if b > lo and a < hi]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals in the window."""
        merged: List[List[float]] = []
        for _, a, b in self._in_window():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_time(self, match) -> Tuple[float, int]:
        """(seconds, count) of the window's device operations whose name
        ``match(name)`` accepts."""
        spans = [s for s in self._in_window() if match(s[0])]
        return sum(b - a for _, a, b in spans) * 1e-6, len(spans)

    def first_start(self, match) -> Optional[float]:
        """Seconds from the window's start to the first matching device
        operation's start."""
        for name, a, _ in self.device:
            if a >= self.window[0] and match(name):
                return (a - self.window[0]) * 1e-6
        return None

    # -- the breakdown ------------------------------------------------------
    def top_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, a, b in self._in_window():
            total[name] += (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time in the window by the innermost host operation that
        was running at each gap's middle ("host: between operations" where
        none was), largest first."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        host = sorted(self.host, key=lambda s: s[1])
        total: Dict[str, float] = defaultdict(float)
        active: List[Span] = []
        i = 0
        for a, b in gaps:                  # gaps come in time order
            mid = (a + b) / 2
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            best = min(active, key=lambda h: h[2] - h[1], default=None)
            label = best[0] if best else "host: between operations"
            total[label] += (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda x: -x[1])[:k]]
