"""Parameter tree ⇄ one flat fp32 buffer (counterpart of ``repro/optim/flatten.py``).

A parameter tree of the port is a dict of tensors, or a bare tensor (a
one-leaf tree: the host PS takes any tree, and the reference's tests hand
it a bare array).  The replay ring stores every snapshot as ONE contiguous
(D,) row, and the host PS updates the whole model in ONE ``ps_apply``
launch, so an update is one elementwise pass over D.  The layout must be
the reference's: ``jax.tree_util`` flattens a dict in **sorted key order**
(``mlp_teacher`` → b1, b2, w1, w2), so the port sorts keys too — insertion
order would silently permute the ring against the reference.

:func:`tree_map` is the port's ``jax.tree.map`` over such trees (and over
the tuples and lists a batch is made of).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Static description of a flattened tree (sorted keys; ``keys`` is
    None for a bare tensor)."""

    keys: Optional[Tuple[str, ...]]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]

    @property
    def total(self) -> int:
        return int(sum(self.sizes))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of dicts, tuples and lists of tensors
    (a bare tensor is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves(tree: Tree):
    """Leaves in the reference's order: sorted keys, or the bare tensor."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tree_device(tree: Tree) -> torch.device:
    """The device of the tree's first leaf."""
    return _leaves(tree)[0].device


def layout_of(tree: Tree) -> TreeLayout:
    leaves = _leaves(tree)
    shapes = tuple(tuple(v.shape) for v in leaves)
    return TreeLayout(keys=tuple(sorted(tree)) if isinstance(tree, dict)
                      else None,
                      shapes=shapes, dtypes=tuple(v.dtype for v in leaves),
                      sizes=tuple(math.prod(s) for s in shapes))


def tree_to_flat(tree: Tree) -> torch.Tensor:
    """Concatenate all leaves (sorted keys) into one fp32 (D,) vector.  A
    single fp32 leaf comes back as a view of itself — no copy of a
    what-if-sized buffer — so a consumer must not write the result in
    place."""
    leaves = [v.reshape(-1).to(torch.float32) for v in _leaves(tree)]
    return leaves[0] if len(leaves) == 1 else torch.cat(leaves)


def stack_grads_flat(grads: Sequence[Tree]) -> torch.Tensor:
    """c gradient trees → one (c, D) fp32 matrix, written row by row into
    one allocation (no list of c flat copies beside it)."""
    layout = layout_of(grads[0])
    out = torch.empty(len(grads), layout.total, dtype=torch.float32,
                      device=tree_device(grads[0]))
    for row, g in zip(out, grads):
        off = 0
        for leaf, size in zip(_leaves(g), layout.sizes):
            row[off:off + size] = leaf.reshape(-1)
            off += size
    return out


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


def pad_flat(flat: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last axis out to ``width`` (the S·Dp width of a sharded
    ring).  Trailing zeros are inert through sgd / momentum / adagrad
    events, and ``[..., :D]`` is the exact inverse.  Returns ``flat``
    itself when it already has that width."""
    d = flat.shape[-1]
    if width == d:
        return flat
    return torch.nn.functional.pad(flat, (0, width - d))


def shard_pack(flat: torch.Tensor, shards: int, width: int) -> torch.Tensor:
    """(…, D) → (…, S, Dp) per-shard rows, the last shard zero-padded to
    the common width Dp = ⌈D/S⌉ (``core/topology.py``'s layout)."""
    return pad_flat(flat, shards * width).reshape(
        flat.shape[:-1] + (shards, width))


def shard_pack_grads(g: torch.Tensor, shards: int,
                     width: int) -> torch.Tensor:
    """(c, D) stacked gradients → (S, c, Dp) per-shard slices."""
    return shard_pack(g, shards, width).movedim(-2, 0)


def shard_unpack(mat: torch.Tensor, dim: int) -> torch.Tensor:
    """(…, S, Dp) per-shard rows → (…, D), the padding dropped."""
    return mat.reshape(mat.shape[:-2] + (-1,))[..., :dim]


def flat_to_tree(flat: torch.Tensor, layout: TreeLayout) -> Tree:
    """Split a (D,) vector back into the tree (leaf dtypes restored; views
    of ``flat`` where the dtype already matches)."""
    leaves = []
    off = 0
    for shape, dtype, size in zip(layout.shapes, layout.dtypes,
                                  layout.sizes):
        leaves.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    if layout.keys is None:
        return leaves[0]
    return dict(zip(layout.keys, leaves))
