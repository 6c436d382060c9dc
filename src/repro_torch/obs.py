"""Spans and counters of the port, on the profiler's clock.

A span marks one layer's work at its boundary::

    with obs.span("schedule"):
        ...
        obs.count("arrivals", n)

Recording is on exactly while a ``torch.profiler`` profile is active (one
read of the flag the profiler keeps for fast checks); there is no other
switch.  While it is on, a span enters
``torch.profiler.record_function("repro_torch.<name>")``, so its interval
lands in the profiler's trace as a ``user_annotation`` on the same timeline
as the device's kernels, and keeps a record in memory: its name, its id,
its parent's id, the id of the outermost ``run`` span it lies in, its start
and end on ``time.perf_counter_ns``, and the counters' changes over it.
While it is off a span does nothing else and keeps nothing.  While it
records, a span also records a CUDA event on the current stream at each
end (where CUDA is in use): :func:`device_seconds` gives the device's time
between them, so a metric can read the device time of work the host
enqueued far ahead of it.

Counters are always on: :func:`count` adds to a named counter, and
:func:`counter_group` hands a module a dict of counters that this registry
reads (the kernel modules' ``launches`` dicts), so every count the port
takes is one of :func:`counters`.

:func:`records` gives the records kept since the last outermost ``run``
span started; :func:`last_run` those of the last outermost ``run`` span
that ended.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
RUN = PREFIX + "run"

# counters by name, and the groups modules own: (prefix, {name: count})
_counts: Dict[str, int] = {}
_groups: List[Tuple[str, Dict[str, int]]] = [("", _counts)]

_ids = itertools.count(1)
_open: List[dict] = []
_records: List[dict] = []
_last_run: List[dict] = []


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counter_group(prefix: str, names: Iterable[str]) -> Dict[str, int]:
    """A dict of counters, each 0, that :func:`counters` reads as
    ``<prefix>.<name>``; its owner adds to it and zeroes it in place."""
    group = dict.fromkeys(names, 0)
    taken = counters()
    for name in group:
        if f"{prefix}.{name}" in taken:
            raise ValueError(f"counter {prefix}.{name} is already registered")
    _groups.append((prefix, group))
    return group


def counters() -> Dict[str, int]:
    """Every counter by its full name."""
    return {f"{prefix}.{name}" if prefix else name: n
            for prefix, group in _groups for name, n in group.items()}


class span:
    """``with span(name):`` records ``repro_torch.<name>`` while a profile
    is active (see the module docstring)."""

    __slots__ = ("name", "_rec", "_fn", "_before")

    def __init__(self, name: str):
        self.name = PREFIX + name
        self._rec = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._begin()
        return self

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            self._end()

    def _begin(self) -> None:
        parent = _open[-1] if _open else None
        rec = {"name": self.name, "id": next(_ids),
               "parent": parent["id"] if parent else None}
        if parent is None and self.name == RUN:
            _records.clear()
            rec["run"] = rec["id"]
        else:
            rec["run"] = parent["run"] if parent else None
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        _open.append(rec)
        self._rec = rec
        self._before = counters()
        if torch.cuda.is_initialized():
            rec["ev0"] = torch.cuda.Event(enable_timing=True)
            rec["ev0"].record()
        rec["t0_ns"] = time.perf_counter_ns()

    def _end(self) -> None:
        rec, self._rec = self._rec, None
        rec["t1_ns"] = time.perf_counter_ns()
        if "ev0" in rec:
            rec["ev1"] = torch.cuda.Event(enable_timing=True)
            rec["ev1"].record()
        before = self._before
        rec["counts"] = {k: n - before.get(k, 0)
                         for k, n in counters().items()
                         if n != before.get(k, 0)}
        self._fn.__exit__(None, None, None)
        _open.remove(rec)
        _records.append(rec)
        if rec["parent"] is None and rec["name"] == RUN:
            _last_run[:] = _records


def records() -> List[dict]:
    """The records kept since the last outermost ``run`` span started, in
    the order their spans ended."""
    return list(_records)


def device_seconds(rec: dict):
    """Seconds on the device between a span's two events (waits for the
    second), or None for a record without them (no CUDA in use)."""
    if "ev1" not in rec:
        return None
    rec["ev1"].synchronize()
    return rec["ev0"].elapsed_time(rec["ev1"]) * 1e-3


def last_run() -> List[dict]:
    """The records of the last outermost ``run`` span that ended, itself
    last."""
    return list(_last_run)
