"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and compiles on
its own into ``build/kernels/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists).  The hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads in milliseconds.
Nothing is built at import time: the first wrapper call on a CUDA tensor
builds (or :func:`build_all` does, all sources at once, one ``nvcc`` each).

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so no multiply-add
is contracted into an FMA — the update kernels must round exactly like the
plain PyTorch versions they are held against.  No fast-math.
``flash_attention.cu``, ``flash_attention_sm90.cu``, ``ssm_scan.cu`` and
``wkv6.cu`` are held against their plain versions within stated
tolerances, not bitwise, and build without ``-fmad=false``
(``SOURCE_FLAGS``); the hash covers each source's own flags.
``flash_attention.cu`` (fp32 operands, 3×TF32 on the tensor cores) and
``flash_attention_sm90.cu`` (bf16) find libcuda's ``cuTensorMapEncodeTiled``
through the runtime, so no source links against anything but cudart.

The wrappers (``replay_ring.py``, ``ps_update.py``, ``flash_attention.py``,
``ssm_scan.py``, ``wkv6.py``) share the binding helpers below: operand
checks, the 16-byte vector-path tests and the launch error check.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("replay_ring", "ps_update", "flash_attention",
           "flash_attention_sm90", "ssm_scan", "wkv6")
# the kernels' optimizer codes (update_event.cuh: OPT_SGD, OPT_MOMENTUM, ...)
OPT_CODES = {"sgd": 0, "momentum": 1, "adagrad": 2}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# sources that need no bitwise match with their plain version: FMAs allowed
_FMA_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
SOURCE_FLAGS = {"flash_attention": _FMA_FLAGS,
                "flash_attention_sm90": _FMA_FLAGS, "ssm_scan": _FMA_FLAGS,
                "wkv6": _FMA_FLAGS}


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return SOURCE_FLAGS.get(name, NVCC_FLAGS)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build on a CUDA host")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str):
    """Start one nvcc (or None when the library is already built).  The
    library goes to a temporary name that :func:`_finish` moves into place,
    so concurrent builders never load a half-written file; nvcc's output
    (``-Xptxas -v``: registers, spills) goes to ``<library>.log``."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"{so.name}.{os.getpid()}.tmp"
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(so.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu (exit "
                           f"{proc.returncode}):\n"
                           f"{so.with_suffix('.log').read_text()}")
    os.replace(tmp, so)


def build_all() -> Tuple[Dict[str, float], Dict[str, Path]]:
    """Build every source in parallel (one nvcc each, all started
    together); returns ({name: seconds until its nvcc ended, 0 when it was
    already built}, {name: .so path})."""
    t0 = time.perf_counter()
    running = {name: _start(name) for name in SOURCES}
    secs = {name: 0.0 for name, st in running.items() if st is None}
    running = {name: st for name, st in running.items() if st is not None}
    while running:
        for name, st in list(running.items()):
            if st[0].poll() is not None:
                secs[name] = time.perf_counter() - t0
                _finish(name, running.pop(name))
        time.sleep(0.05)
    return secs, {n: library_path(n) for n in SOURCES}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use), with
    its ``<name>_error_string`` signature declared."""
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(library_path(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# binding helpers shared by the wrappers
# ---------------------------------------------------------------------------
def check_operand(name: str, t: Optional[torch.Tensor], shape, dtype,
                  device) -> None:
    """Raise unless ``t`` (None allowed) lies on ``device`` with this
    shape and dtype, contiguous."""
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def vec4(D: int, *tensors) -> int:
    """1 when every row start is 16-byte aligned for fp32 and 8-byte for
    bf16 (D % 4 == 0 and aligned bases): the kernels' vector-load path."""
    ok = D % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                            for t in tensors if t is not None)
    return int(ok)


def vec8(D: int, *tensors) -> int:
    """1 when D % 8 == 0 and every base is 16-byte aligned, so 8 elements
    of any row start on a 16-byte boundary: the what-if kernel's path."""
    return int(D % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in tensors if t is not None))


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` when every row of its last dim starts on a 16-byte boundary
    (the scan kernels read rows 16 bytes at a time), else a fresh
    contiguous copy."""
    ok = t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:-1])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def raise_on(lib: ctypes.CDLL, source: str, err: int, kernel: str) -> None:
    """Raise when a launch returned a nonzero ``cudaError_t``."""
    if err:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
