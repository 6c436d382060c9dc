"""Replay-ring update kernels: one launch per update event (CUDA, Hopper).

Counterpart of ``repro/kernels/replay_ring.py``, whose two Pallas TPU
megakernels (``ring_apply`` and ``ring_apply_whatif``) become hand-written
CUDA C++ in ``csrc/replay_ring.cu``, built by ``kernels/build.py`` and
bound with ``ctypes``.  One event:

    ring-read(prev row) → [+ error-feedback residue] → combine / sequential
    optimizer event → quantize → ring-write(slot row) [+ residue write]

On this card ``ring_apply`` is memory-bound (a few fp32 operations per
byte moved) and ``ring_apply_whatif`` bound by its slot-order sum (a
multiply and an add per slot and element).  The what-if kernel reads each
distinct pulled row once and forms its gⱼ once (up to
:data:`WHATIF_ROWS` distinct rows, held in registers; an event with more
takes a per-slot variant in the same launch); the source's header says
why.  The
reference's ``(rows, 128)`` tiling and ``padded_width`` served the TPU's
layout only: here the ring has width D and the kernels mask the ragged edge.

Each wrapper checks device, dtype, shape and contiguity, then launches the
kernel on a CUDA tensor — or, for a CPU tensor, runs the plain PyTorch
version (``optim/backends.py``) that the kernel is held against.  Nothing
falls back: a CUDA call launches or raises.  ``launches`` counts kernel
launches per wrapper (plain-version calls do not count), so a run can show
that its events really went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.optim import backends
from repro_torch.optim.spec import UpdateSpec

# kernel launches per wrapper since the last reset_launches()
launches = {"ring_apply": 0, "ring_apply_whatif": 0}

_RING_DTYPES = (torch.float32, torch.bfloat16)
# distinct pulled rows the what-if kernel holds in registers
# (csrc/replay_ring.cu: WHATIF_ROWS)
WHATIF_ROWS = 4

Ring3 = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (ctypes would
    otherwise pass pointers as 32-bit ints)."""
    lib = build.load("replay_ring")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ring_apply.argtypes = [p, i, p, p, p, p, p, p, ctypes.c_longlong,
                               i, i, i, f, f, i, p]
    lib.ring_apply.restype = i
    lib.ring_apply_whatif.argtypes = [p, i, p, p, p, p, p, p, p,
                                      ctypes.c_longlong, i, i, f, f, i, p]
    lib.ring_apply_whatif.restype = i
    lib.ring_apply_whatif_rows.restype = i
    if lib.ring_apply_whatif_rows() != WHATIF_ROWS:
        raise RuntimeError(f"ring_apply_whatif_rows() = "
                           f"{lib.ring_apply_whatif_rows()}, expected "
                           f"{WHATIF_ROWS}")
    return lib


def _check_event(spec: UpdateSpec, ring, s, res, c: int, coef, lrs, idx,
                 n_idx: int) -> None:
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no kernel path")
    if ring.dim() != 2 or ring.dtype not in _RING_DTYPES:
        raise ValueError(f"ring must be (K, D) fp32 or bf16, got "
                         f"{tuple(ring.shape)} {ring.dtype}")
    if not ring.is_contiguous():
        raise ValueError("ring must be contiguous")
    if (s is None) != (spec.optimizer == "sgd"):
        raise ValueError(f"{spec.optimizer} needs "
                         f"{'no' if s is None else 'a'} state vector")
    D, dev = ring.shape[1], ring.device
    build.check_operand("s", s, (D,), torch.float32, dev)
    build.check_operand("res", res, (D,), torch.float32, dev)
    build.check_operand("coef", coef, (c,), torch.float32, dev)
    build.check_operand("lrs", lrs, (c,), torch.float32, dev)
    build.check_operand("idx", idx, (n_idx,), torch.int32, dev)


def ring_apply(ring: torch.Tensor, s: Optional[torch.Tensor],
               res: Optional[torch.Tensor], g: torch.Tensor,
               coef: torch.Tensor, lrs: torch.Tensor, idx: torch.Tensor, *,
               spec: UpdateSpec, mode: str = "combine") -> Ring3:
    """ONE ring event with staged gradients, in place: read row ``idx[0]``,
    apply the c-gradient update, write row ``idx[1]``.

    ``ring`` (K, D) fp32 or bf16; ``s`` (D,) fp32 state or None (sgd);
    ``res`` (D,) fp32 residue or None; ``g`` (c, D) fp32; ``coef``/``lrs``
    (c,) fp32; ``idx`` (2,) int32 [prev, slot] on the ring's device.
    Returns ``(ring, s, res)``, updated in place."""
    if mode not in ("combine", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    c = g.shape[0]
    _check_event(spec, ring, s, res, c, coef, lrs, idx, 2)
    build.check_operand("g", g, (c, ring.shape[1]), torch.float32,
                        ring.device)
    if ring.device.type == "cpu":
        return backends.apply_event_ring(spec, ring, s, res, g, coef, lrs,
                                         idx[0], idx[1], mode)
    if ring.device.type != "cuda":
        raise ValueError(f"ring_apply runs on cuda (kernel) or cpu (plain "
                         f"version), not {ring.device.type}")
    lib = _library()
    D = ring.shape[1]
    err = lib.ring_apply(
        ring.data_ptr(), int(ring.dtype == torch.bfloat16), build.ptr(s),
        build.ptr(res), g.data_ptr(), coef.data_ptr(), lrs.data_ptr(),
        idx.data_ptr(), D, c, build.OPT_CODES[spec.optimizer],
        int(mode == "sequential"), spec.momentum, spec.eps,
        build.vec4(D, ring, s, res, g),
        torch.cuda.current_stream().cuda_stream)
    build.raise_on(lib, "replay_ring", err, "ring_apply")
    launches["ring_apply"] += 1
    return ring, s, res


def ring_apply_whatif(ring: torch.Tensor, s: Optional[torch.Tensor],
                      res: Optional[torch.Tensor], a: torch.Tensor,
                      wstar: torch.Tensor, coef: torch.Tensor,
                      lrs: torch.Tensor, idx: torch.Tensor, *,
                      spec: UpdateSpec) -> Ring3:
    """ONE ring event with in-kernel gradients gⱼ = a ⊙ (ring[tsⱼ] − w*),
    combine mode, in place.

    ``a``/``wstar`` (D,) fp32; ``idx`` (2 + c,) int32 [prev, slot, ts_0 …
    ts_{c−1}].  Any K ≥ 1: the kernel reads every operand of an element
    before it writes that element, so ``prev == slot`` and ``slot ∈ ts``
    (K = 1, hardsync) are safe."""
    c = idx.shape[0] - 2
    if c < 1:
        raise ValueError(f"idx must hold [prev, slot, ts_0 …], got "
                         f"{idx.shape[0]} entries")
    _check_event(spec, ring, s, res, c, coef, lrs, idx, c + 2)
    D = ring.shape[1]
    build.check_operand("a", a, (D,), torch.float32, ring.device)
    build.check_operand("wstar", wstar, (D,), torch.float32, ring.device)
    if ring.device.type == "cpu":
        return backends.apply_event_ring_whatif(
            spec, ring, s, res, a, wstar, idx[2:], coef, lrs, idx[0], idx[1])
    if ring.device.type != "cuda":
        raise ValueError(f"ring_apply_whatif runs on cuda (kernel) or cpu "
                         f"(plain version), not {ring.device.type}")
    lib = _library()
    err = lib.ring_apply_whatif(
        ring.data_ptr(), int(ring.dtype == torch.bfloat16), build.ptr(s),
        build.ptr(res), a.data_ptr(), wstar.data_ptr(), coef.data_ptr(),
        lrs.data_ptr(), idx.data_ptr(), D, c,
        build.OPT_CODES[spec.optimizer], spec.momentum, spec.eps,
        build.vec8(D, ring, s, res, a, wstar),
        torch.cuda.current_stream().cuda_stream)
    build.raise_on(lib, "replay_ring", err, "ring_apply_whatif")
    launches["ring_apply_whatif"] += 1
    return ring, s, res
