"""Staleness-aware optimizer subsystem of the port (DESIGN.md §3): the one
update rule (``spec.update_event``) and the flat ring events that the
replay kernels are held against (``backends``)."""

from repro_torch.optim.spec import (KERNEL_OPTIMIZERS, OPTIMIZERS,
                                    UpdateSpec, init_state, spec_from_run,
                                    update_event)
from repro_torch.optim.backends import (RING_IMPLS, apply_event_flat,
                                        apply_event_ring,
                                        apply_event_ring_whatif,
                                        resolve_ring_impl)
from repro_torch.optim import flatten  # noqa: F401

__all__ = [
    "OPTIMIZERS", "KERNEL_OPTIMIZERS", "RING_IMPLS",
    "UpdateSpec", "init_state", "spec_from_run", "update_event",
    "apply_event_flat", "apply_event_ring", "apply_event_ring_whatif",
    "resolve_ring_impl",
]
