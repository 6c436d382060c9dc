"""Staleness-aware optimizer subsystem of the port (DESIGN.md §3): the one
update rule (``spec.update_event``), the three ``apply_update`` backends
(``reference`` / ``jit`` / ``pallas``, the last one ONE ``ps_apply`` kernel
launch over the flattened model), the flat ring events that the replay
kernels are held against (``backends``) and the round fold of the fused
softsync engine (``spec.sequential_fold``, ``backends.apply_round_folded``)."""

from repro_torch.optim.spec import (KERNEL_OPTIMIZERS, OPTIMIZERS,
                                    RoundFold, UpdateSpec, init_state,
                                    sequential_fold, spec_from_run,
                                    update_event)
from repro_torch.optim.backends import (BACKENDS, RING_IMPLS,
                                        apply_event_flat, apply_event_ring,
                                        apply_event_ring_whatif,
                                        apply_event_sharded,
                                        apply_round_folded, apply_single,
                                        apply_update, apply_update_flat,
                                        apply_update_tree,
                                        resolve_ring_impl, sgd_step)
from repro_torch.optim import flatten  # noqa: F401

__all__ = [
    "OPTIMIZERS", "KERNEL_OPTIMIZERS", "BACKENDS", "RING_IMPLS",
    "UpdateSpec", "init_state", "spec_from_run", "update_event",
    "RoundFold", "sequential_fold", "apply_round_folded",
    "apply_update", "apply_update_tree", "apply_update_flat",
    "apply_event_flat", "apply_event_ring", "apply_event_ring_whatif",
    "apply_event_sharded", "apply_single", "resolve_ring_impl", "sgd_step",
]
