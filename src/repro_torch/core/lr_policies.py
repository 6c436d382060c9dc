"""Learning-rate policies (paper §3.2 / §5.1 and footnote 3).

* ``const``             — α = α₀ (the paper's divergent control at n = 30).
* ``sqrt_scale``        — hardsync: α = α₀·√(λμ/B)  (§3.2).
* ``staleness_inverse`` — n-softsync: α = α₀/⟨σ⟩ = α₀/n  (Eq. 6).
* ``per_gradient``      — footnote 3: each gradient g with staleness σ_g gets
                          α_g = α₀ / max(1, σ_g).  The paper suggests but does
                          not evaluate this; we implement it as a beyond-paper
                          feature and benchmark it against Eq. 6.

Policies are callables ``(update_timestamp, gradient_timestamps) -> α`` (or a
list of per-gradient α for ``per_gradient``), matching what
``ParameterServerState.push_gradient`` expects.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.config import RunConfig

LR = Union[float, List[float]]


def resolve_trace_lrs(run: RunConfig, pulled_ts: np.ndarray,
                      update_ts: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, str]:
    """Vectorized trace-time policy resolution (schedule pass, DESIGN.md §4).

    ``pulled_ts`` is the trace's (steps, c) vector-clock matrix: row j holds
    the timestamps of the gradients folded into update j (fired at PS
    timestamp ``update_ts[j]``, default ``j``).  Returns the (steps, c)
    float64 LR matrix plus the ``repro_torch.optim`` update mode the policy
    implies — scalar policies broadcast one α per event (``combine``,
    Eqs. 3/5); ``per_gradient`` resolves footnote 3's α₀/max(1, σ_g) per
    slot (``sequential``).  This is the ONE implementation of the policy
    formulas: :func:`make_lr_policy` evaluates it per event.
    """
    pulled_ts = np.asarray(pulled_ts)
    steps, c = pulled_ts.shape
    if run.lr_policy == "const":
        return np.full((steps, c), run.base_lr), "combine"
    if run.lr_policy == "sqrt_scale":
        scale = math.sqrt(run.n_learners * run.minibatch / run.ref_batch)
        return np.full((steps, c), run.base_lr * scale), "combine"
    if run.lr_policy == "staleness_inverse":
        sigma = max(1.0, run.expected_staleness)
        return np.full((steps, c), run.base_lr / sigma), "combine"
    if run.lr_policy == "per_gradient":
        if update_ts is None:
            update_ts = np.arange(steps)
        sigma = (np.asarray(update_ts, dtype=np.float64)[:, None]
                 - pulled_ts.astype(np.float64))
        return run.base_lr / np.maximum(1.0, sigma), "sequential"
    raise ValueError(run.lr_policy)


def make_lr_policy(run: RunConfig):
    """Per-event ``(update_timestamp, gradient_timestamps) -> α`` view of
    :func:`resolve_trace_lrs` (single source of the formulas) — what the
    legacy per-arrival PS loop calls at each fire."""
    scalar_mode = run.lr_policy != "per_gradient"

    def policy(ts: int, clocks: Sequence[int]) -> LR:
        row, _ = resolve_trace_lrs(run, np.asarray([list(clocks)]),
                                   update_ts=np.asarray([ts]))
        return float(row[0, 0]) if scalar_mode else row[0].tolist()
    return policy


def hardsync_lr(run: RunConfig) -> float:
    """α₀·√(λμ/B) — the paper's hardsync scaling (§3.2)."""
    return run.base_lr * math.sqrt(
        run.n_learners * run.minibatch / run.ref_batch)


def softsync_lr(run: RunConfig,
                measured_staleness: Optional[float] = None) -> float:
    """α₀/⟨σ⟩ (Eq. 6).  Pass the measured ⟨σ⟩ when available (the distributed
    round-based engine has ⟨σ⟩ = (n−1)/2 rather than the pipelined n)."""
    sigma = (measured_staleness if measured_staleness is not None
             else run.expected_staleness)
    return run.base_lr / max(1.0, sigma)
