"""Tree checkpointing without external dependencies (npz-based; counterpart
of ``repro/checkpoint/io.py``, in its format).

Flattens a tree of tensors (nested dicts, tuples and lists) to
``key/path/like/this -> array`` entries in a ``.npz``, plus a
tiny JSON manifest (``<path>.meta.json``: the step and the sorted keys).
The keys are the reference's ``jax.tree_util`` paths joined by ``/``
(``units/block_0/attn/w_q``, ``velocity/embed``), bf16 and fp16 leaves are
stored as fp32, and the manifest is looked up where the reference looks for
it, so a checkpoint written by either package loads into the other.
Restore rebuilds against a template tree, so keys and dtypes are validated
on load; each leaf lands on its template leaf's device.
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[tuple]:
    """(path, leaf) in the reference's order: dict keys sorted, sequences
    by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)            # fp32 master copy on disk
    return t.cpu().numpy()                 # (converted where the leaf is)


def save_checkpoint(path: str, state, step: int = 0) -> None:
    """Write ``state`` to ``path`` (``.npz`` appended when missing, as
    ``np.savez`` does) and the manifest to ``path + ".meta.json"``.

    The entries are stored, not deflated: deflate runs orders of magnitude
    slower than the disk on fp32 weights and saves little on them, which
    at a model of billions of parameters is the difference between
    seconds and hours.  ``np.load`` reads either, so the reference loads
    these files as they are.  Leaves are written one at a time, so the host
    holds one leaf's fp32 copy, not the whole tree's."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    npz = path if path.endswith(".npz") else path + ".npz"
    keys = []
    with zipfile.ZipFile(npz, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _paths(state):
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(leaf),
                                          allow_pickle=False)
            keys.append(key)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, "keys": sorted(keys)}, f)


def _rebuild(template, leaves: Iterator):
    if isinstance(template, dict):
        # sorted, as _paths visits them; the template's own key order kept
        new = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _mapped(path: str, info: zipfile.ZipInfo):
    """The array of a stored (not deflated) ``.npy`` entry, memory-mapped
    copy-on-write from the file, or None when it cannot be (an empty
    array, an unknown header version)."""
    headers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)                     # the entry's local header
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        read_header = headers.get(np.lib.format.read_magic(f))
        if read_header is None:
            return None
        shape, fortran, dtype = read_header(f)
        offset = f.tell()
    if dtype.hasobject or 0 in shape:
        return None
    return np.memmap(path, dtype=dtype, mode="c", offset=offset,
                     shape=shape, order="F" if fortran else "C")


def load_checkpoint(path: str, template) -> Tuple[Any, int]:
    """Restore into the structure of ``template``; returns (state, step).

    Entries this module wrote (stored) are memory-mapped from the file and
    copied once, to the template leaf's device; deflated entries (the
    reference's ``savez_compressed``) are read through ``np.load``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta_path = path.replace(".npz", "") + ".npz.meta.json"
    if not os.path.exists(meta_path):
        meta_path = path + ".meta.json"
    step = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step", 0)

    restored = []
    with np.load(path) as data, zipfile.ZipFile(path) as zf:
        for key, leaf in _paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            info = zf.getinfo(key + ".npy")
            arr = (_mapped(path, info)
                   if info.compress_type == zipfile.ZIP_STORED else None)
            if arr is None:
                arr = data[key]
            leaf = torch.as_tensor(leaf)
            # one copy to the device, then the dtype (a card converts there)
            restored.append(torch.from_numpy(arr).to(leaf.device, copy=True)
                            .to(leaf.dtype))
            del arr
    return _rebuild(template, iter(restored)), step
