"""Scalar/vector clocks and staleness accounting (paper §3.1).

The parameter server's weights carry a scalar timestamp ``ts_i`` that
increments on every weight update.  A gradient inherits the timestamp of the
weights it was computed from; its *staleness* when folded into update ``j``
is ``σ = j − i``.  The set of gradient timestamps contributing to one update
forms a vector clock; the paper's average staleness (Eq. 2) is

    ⟨σ⟩_i = (i − 1) − mean(i_1, …, i_n).

Two ingestion paths feed the log: the legacy per-arrival loop records one
:class:`StalenessRecord` per update (:meth:`VectorClockLog.record`), and the
trace/replay engine hands over the whole (steps, c) vector-clock matrix at
once (:meth:`VectorClockLog.from_matrix`) — the Fig.-4 statistics are then
computed vectorized on the matrix, with per-update ``records`` materialized
lazily only if a consumer asks for them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def staleness_matrix(pulled_ts: np.ndarray,
                     update_ts: Optional[np.ndarray] = None) -> np.ndarray:
    """(steps, c) σ matrix for a vector-clock matrix: slot (j, i) has
    σ = update_ts[j] − pulled_ts[j, i] (Eq. 2 per-slot form; update_ts
    defaults to the row index, i.e. the weights were at timestamp j when
    update j fired).  The ONE home of this accounting — shared by the log
    below and by ``ArrivalTrace.staleness``."""
    ts = np.asarray(pulled_ts, dtype=np.int64)
    if update_ts is None:
        update_ts = np.arange(ts.shape[0], dtype=np.int64)
    return np.asarray(update_ts, dtype=np.int64)[:, None] - ts


@dataclasses.dataclass
class StalenessRecord:
    """Bookkeeping for one weight update event at the parameter server."""
    update_index: int                 # i: timestamp after this update
    gradient_timestamps: List[int]    # vector clock ⟨ts_{i_1} … ts_{i_n}⟩

    @property
    def staleness_values(self) -> List[int]:
        """Per-gradient staleness σ = (i−1) − ts_g  (weights were at i−1
        when this update was applied)."""
        return [(self.update_index - 1) - t for t in self.gradient_timestamps]

    @property
    def average_staleness(self) -> float:
        """Eq. 2."""
        return float((self.update_index - 1)
                     - np.mean(self.gradient_timestamps))


class VectorClockLog:
    """Accumulates StalenessRecords over a run; provides Fig.-4 statistics."""

    def __init__(self):
        self._records: Optional[List[StalenessRecord]] = []
        self._matrix: Optional[np.ndarray] = None   # (steps, c) pulled ts
        self._valid: Optional[np.ndarray] = None    # (steps, c) slot mask

    @classmethod
    def from_matrix(cls, pulled_ts: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> "VectorClockLog":
        """Build from a trace's (steps, c) vector-clock matrix: row j is the
        clock of update j+1 (statistics stay vectorized on the matrix).
        ``valid`` (same shape, bool) excludes cancelled slots — an elastic
        trace's unfilled/backup-cancelled pushes carry placeholder clocks
        that must not enter the Fig.-4 statistics."""
        log = cls()
        log._matrix = np.asarray(pulled_ts, dtype=np.int64)
        log._valid = None if valid is None else np.asarray(valid, bool)
        log._records = None
        return log

    @property
    def records(self) -> List[StalenessRecord]:
        if self._records is None:
            if self._valid is None:
                self._records = [StalenessRecord(j + 1, row.tolist())
                                 for j, row in enumerate(self._matrix)]
            else:
                self._records = [
                    StalenessRecord(j + 1, row[keep].tolist())
                    for j, (row, keep) in enumerate(zip(self._matrix,
                                                        self._valid))]
        return self._records

    def record(self, update_index: int,
               gradient_timestamps: Sequence[int]) -> StalenessRecord:
        rec = StalenessRecord(update_index, list(gradient_timestamps))
        self.records.append(rec)
        self._matrix = None          # matrix no longer authoritative
        return rec

    # ---- statistics --------------------------------------------------------
    def _staleness_matrix(self) -> Optional[np.ndarray]:
        """(steps, c) σ matrix when the log is matrix-backed, else None."""
        if self._matrix is None:
            return None
        return staleness_matrix(self._matrix)

    def average_staleness_series(self) -> np.ndarray:
        """⟨σ⟩ per update step (Fig. 4 main panels)."""
        sig = self._staleness_matrix()
        if sig is not None:
            if self._valid is not None:
                count = np.maximum(1, self._valid.sum(axis=1))
                return (np.where(self._valid, sig, 0).sum(axis=1)
                        / count).astype(np.float64)
            return sig.mean(axis=1).astype(np.float64)
        return np.array([r.average_staleness for r in self.records])

    def all_staleness_values(self) -> np.ndarray:
        """Per-gradient σ across the whole run (Fig. 4(b) inset)."""
        sig = self._staleness_matrix()
        if sig is not None:
            return (sig[self._valid] if self._valid is not None
                    else sig.reshape(-1))
        if not self.records:
            return np.zeros((0,))
        return np.concatenate([np.asarray(r.staleness_values)
                               for r in self.records])

    def staleness_histogram(self, max_sigma: Optional[int] = None
                            ) -> np.ndarray:
        """P(σ = k) for k = 0 … max_sigma, normalized by the total gradient
        count.  ``max_sigma=None`` uses the largest observed σ; an explicit
        ``max_sigma`` (including 0) truncates — mass above it is excluded,
        so the histogram sums to P(σ ≤ max_sigma).  An empty log yields a
        single zero bin (or max_sigma + 1 zero bins when given)."""
        vals = self.all_staleness_values()
        if max_sigma is None:
            max_sigma = int(vals.max()) if len(vals) else 0
        edges = np.arange(-0.5, max_sigma + 1.5)
        hist, _ = np.histogram(vals, bins=edges)
        return hist / max(1, len(vals))

    def fraction_exceeding(self, bound: float) -> float:
        vals = self.all_staleness_values()
        if len(vals) == 0:
            return 0.0
        return float(np.mean(vals > bound))

    def mean_staleness(self) -> float:
        vals = self.all_staleness_values()
        return float(vals.mean()) if len(vals) else 0.0
