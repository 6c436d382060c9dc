"""Carry the reference's parameters into the port.

``repro``'s problems draw their initial weights with ``jax.random``, which
the port cannot reproduce.  To replay the *same* run in both packages, take
the reference's parameters as numpy arrays (``np.asarray`` of each leaf —
the only form in which they cross the package boundary) and turn them into
the port's parameter dict; ``driver.run(spec, init=...)`` then starts from
them.  ``model_params_from_jax`` does the same for a model of the
``models/`` stack.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """``{name: array}`` (the reference's parameter dict, as numpy) → the
    port's ``{name: tensor}`` on ``device``, bit for bit (dtype kept)."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in np_params.items()}


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A copy of ``arr`` as a CPU tensor, bit for bit; numpy's bfloat16
    (the reference's bf16 leaves) goes through its 16-bit pattern."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def model_params_from_jax(np_tree: dict, cfg, device) -> dict:
    """The reference's model parameter pytree (nested dicts of numpy arrays,
    ``units`` leaves stacked on a leading ``n_units`` axis) → the port's
    parameter tree (``models/transformer.py``) on ``device``, bit for bit.

    The two trees share their leaf paths, so the map is one to one: every
    leaf the port's ``cfg`` has must come from the same path with the same
    shape and dtype, and every leaf of ``np_tree`` must be used; anything
    else raises ``ValueError``."""
    from repro_torch.models.transformer import init_params
    want = dict(_leaf_paths(init_params(cfg, None, "meta")))
    given = dict(_leaf_paths(np_tree))
    missing = sorted("/".join(p) for p in want.keys() - given.keys())
    extra = sorted("/".join(p) for p in given.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unused {extra}")
    out: dict = {}
    for path, meta in want.items():
        t = _tensor_from_numpy(np.asarray(given[path]))
        name = "/".join(path)
        if tuple(t.shape) != tuple(meta.shape) or t.dtype != meta.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(meta.shape)} {meta.dtype}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.to(device)
    return out
