"""Parameter dict ⇄ one flat fp32 buffer (counterpart of ``repro/optim/flatten.py``).

The replay ring stores every snapshot as ONE contiguous (D,) row, so an
update event is one elementwise pass over D.  The layout must be the
reference's: ``jax.tree_util`` flattens a dict in **sorted key order**
(``mlp_teacher`` → b1, b2, w1, w2), so the port sorts keys too — insertion
order would silently permute the ring against the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Static description of a flattened parameter dict (sorted keys)."""

    keys: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]

    @property
    def total(self) -> int:
        return int(sum(self.sizes))


def layout_of(tree: Dict[str, torch.Tensor]) -> TreeLayout:
    keys = tuple(sorted(tree))
    shapes = tuple(tuple(tree[k].shape) for k in keys)
    return TreeLayout(keys=keys, shapes=shapes,
                      dtypes=tuple(tree[k].dtype for k in keys),
                      sizes=tuple(math.prod(s) for s in shapes))


def tree_to_flat(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate all leaves (sorted keys) into one fp32 (D,) vector.  A
    single fp32 1-D leaf is returned as is — no copy of a what-if-sized
    buffer."""
    leaves = [tree[k].reshape(-1).to(torch.float32) for k in sorted(tree)]
    return leaves[0] if len(leaves) == 1 else torch.cat(leaves)


def batched_tree_to_flat(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dict whose leaves share a leading batch axis → (B, D) fp32."""
    keys = sorted(tree)
    b = tree[keys[0]].shape[0]
    return torch.cat([tree[k].reshape(b, -1).to(torch.float32)
                      for k in keys], dim=1)


def batched_flat_to_tree(flat: torch.Tensor,
                         layout: TreeLayout) -> Dict[str, torch.Tensor]:
    """(B, D) matrix → dict with a leading (B,) axis on every leaf (views
    where the dtype already matches)."""
    b = flat.shape[0]
    out = {}
    off = 0
    for key, shape, dtype, size in zip(layout.keys, layout.shapes,
                                       layout.dtypes, layout.sizes):
        out[key] = flat[:, off:off + size].reshape((b,) + shape).to(dtype)
        off += size
    return out


def flat_to_tree(flat: torch.Tensor,
                 layout: TreeLayout) -> Dict[str, torch.Tensor]:
    """Split a (D,) vector back into the dict (leaf dtypes restored)."""
    out = {}
    off = 0
    for key, shape, dtype, size in zip(layout.keys, layout.shapes,
                                       layout.dtypes, layout.sizes):
        out[key] = flat[off:off + size].reshape(shape).to(dtype)
        off += size
    return out
