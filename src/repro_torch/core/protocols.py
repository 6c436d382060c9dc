"""PS-side optimizer init (counterpart of ``repro/core/protocols.py``; only
``init_ps_state`` is ported — the host PS waits for the legacy oracle,
ROADMAP.md queue 1 item 7)."""

from __future__ import annotations

from repro_torch import optim


def init_ps_state(run, params):
    """The run's UpdateSpec plus fresh fp32 optimizer state for ``params``."""
    spec = optim.spec_from_run(run)
    return spec, optim.init_state(spec, params)
