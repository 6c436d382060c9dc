"""Placement specs of the SPMD replay (the SPMD part of
``repro/launch/sharding.py``, DESIGN.md §13).

The replay's carry is (ring, state, residue) with a leading shard axis —
(S, K, W) / (S, W) — one slice per "ps" rank.  The trace inputs replicate
the small per-event tensors (ring indices, LRs, coefficients: O(steps·c)
scalars) on every rank and shard only the minibatch leaves — (steps, c, …)
— over the "learner" axis on the slot dim, so each learner rank stages and
differentiates just its slot block.  The per-shard pulled-row matrix
``sts`` (steps, c, S) shards its trailing axis over "ps": each PS rank
reads only its own ring's rows.  The what-if coefficients (a, w*), packed
(S, W), shard over "ps" like the carry.

A spec is a :class:`P`: per leading dim, the mesh axis it is split over or
None (replicated), as jax's ``PartitionSpec``; :func:`local_block` cuts a
rank's block out of a full array.  The parameter shardings of the model
stack (the rest of the reference's module) wait for ROADMAP.md item 10.5.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.optim.flatten import tree_map


class P(tuple):
    """Partition spec: one mesh axis name (or None) per leading dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def spmd_carry_specs() -> Tuple[P, P, P]:
    """(ring, state, residue): every carry leaf shards dim 0 over "ps"
    (state and residue may be None)."""
    return (P("ps"), P("ps"), P("ps"))


def spmd_xs_specs(keys) -> Dict[str, Any]:
    """Spec per trace-input key (``engine._trace_xs``).  "batch" is a
    prefix: one spec for every leaf of the minibatch tree."""
    specs: Dict[str, Any] = {}
    for key in keys:
        if key == "sts":
            specs[key] = P(None, None, "ps")
        elif key == "batch":
            specs[key] = P(None, "learner")
        else:
            specs[key] = P()
    return specs


def spmd_aux_specs() -> Tuple[P, P]:
    """(a, wstar) what-if coefficients, shard-packed to (S, W): per "ps"."""
    return (P("ps"), P("ps"))


def local_block(x, spec: P, mesh):
    """This rank's block of ``x`` (a tensor, an array or a tree of them)
    under ``spec``: each dim named in the spec is cut into equal contiguous
    blocks, one per index along that mesh axis."""
    def cut(a):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.axis_size(axis)
            if a.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {a.shape[dim]} does not "
                                 f"split into {n} blocks over {axis!r}")
            size = a.shape[dim] // n
            lo = mesh.axis_index(axis) * size
            a = a[(slice(None),) * dim + (slice(lo, lo + size),)]
        return a
    return tree_map(cut, x)
