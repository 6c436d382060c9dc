"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and compiles on
its own into ``build/kernels/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists).  The hash covers the source and the flags,
so an edited source rebuilds and an unchanged one loads in milliseconds.
Nothing is built at import time: the first wrapper call on a CUDA tensor
builds (or :func:`build_all` does, all sources at once, one ``nvcc`` each).

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so no multiply-add
is contracted into an FMA — the kernels must round exactly like the plain
PyTorch versions they are held against.  No fast-math.
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
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("replay_ring",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str):
    """Start one nvcc (or None when the library is already built); the
    output goes to a temporary name that :func:`_finish` moves into place,
    so concurrent builders never load a half-written file."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"{so.name}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def build_all() -> Tuple[float, Dict[str, Path]]:
    """Build every source in parallel (one nvcc each, all started
    together); returns (wall seconds, {name: .so path})."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    for name, st in started.items():
        _finish(name, st)
    return time.perf_counter() - t0, {n: library_path(n) for n in SOURCES}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(library_path(name)))
