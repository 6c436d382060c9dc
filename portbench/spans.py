"""The port's own spans in a traced run (``repro_torch.obs``): their
intervals on the profiler's timeline, the one the device's kernels lie on,
and the counts the program took at their boundaries.

Spans are read only from a trace of the card: a CPU run gives nothing.  A
program that records no spans (one older than them) gives nothing either,
and the metrics that read them then report nothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "repro_torch."


def intervals(run, name: str) -> List[Tuple[float, float]]:
    """(start µs, end µs) of each ``repro_torch.<name>`` span inside the
    traced window, in time order."""
    tr = run.trace
    if tr is None or tr.window is None or not tr.device:
        return []
    lo, hi = tr.window
    return sorted((a, b) for n, a, b in tr.host
                  if n == PREFIX + name and lo <= a and b <= hi)


def seconds(run, name: str) -> Optional[float]:
    """Seconds the window's ``name`` spans cover, or None without one."""
    spans = intervals(run, name)
    if not spans:
        return None
    return sum(b - a for a, b in spans) * 1e-6


def count(name: str, counter: str) -> Optional[int]:
    """``counter``'s change over the ``name`` spans of the program's last
    ``run`` span (``repro_torch.obs.last_run()``: the window's call), or
    None where no such span took that count."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    taken = [r["counts"][counter] for r in obs.last_run()
             if r["name"] == PREFIX + name and counter in r["counts"]]
    return sum(taken) if taken else None
