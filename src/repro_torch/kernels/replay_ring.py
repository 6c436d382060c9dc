"""Replay-ring update kernels: one launch per update event (CUDA, Hopper).

Counterpart of ``repro/kernels/replay_ring.py``, whose two Pallas TPU
megakernels (``ring_apply`` and ``ring_apply_whatif``) become hand-written
CUDA C++ in ``csrc/replay_ring.cu``, built by ``kernels/build.py`` and
bound with ``ctypes``.  One event:

    ring-read(prev row) → [+ error-feedback residue] → combine / sequential
    optimizer event → quantize → ring-write(slot row) [+ residue write]

On this card both are memory-bound (a few fp32 operations per byte moved);
the source's header says what the first design does about it.  The
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

_OPT_CODES = {"sgd": 0, "momentum": 1, "adagrad": 2}
_RING_DTYPES = (torch.float32, torch.bfloat16)

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
    lib.replay_ring_error_string.argtypes = [i]
    lib.replay_ring_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: Optional[torch.Tensor], shape, dtype, device):
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the ring on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check("s", s, (D,), torch.float32, dev)
    _check("res", res, (D,), torch.float32, dev)
    _check("coef", coef, (c,), torch.float32, dev)
    _check("lrs", lrs, (c,), torch.float32, dev)
    _check("idx", idx, (n_idx,), torch.int32, dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec4(D: int, *tensors) -> int:
    """1 when every row start is 16-byte aligned for fp32 and 8-byte for
    bf16 (D % 4 == 0 and aligned bases): the kernel's vector-load path."""
    ok = D % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                            for t in tensors if t is not None)
    return int(ok)


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.replay_ring_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


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
    _check("g", g, (c, ring.shape[1]), torch.float32, ring.device)
    if ring.device.type == "cpu":
        return backends.apply_event_ring(spec, ring, s, res, g, coef, lrs,
                                         idx[0], idx[1], mode)
    if ring.device.type != "cuda":
        raise ValueError(f"ring_apply runs on cuda (kernel) or cpu (plain "
                         f"version), not {ring.device.type}")
    lib = _library()
    D = ring.shape[1]
    err = lib.ring_apply(
        ring.data_ptr(), int(ring.dtype == torch.bfloat16), _ptr(s),
        _ptr(res), g.data_ptr(), coef.data_ptr(), lrs.data_ptr(),
        idx.data_ptr(), D, c, _OPT_CODES[spec.optimizer],
        int(mode == "sequential"), spec.momentum, spec.eps,
        _vec4(D, ring, s, res, g), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "ring_apply")
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
    _check("a", a, (D,), torch.float32, ring.device)
    _check("wstar", wstar, (D,), torch.float32, ring.device)
    if ring.device.type == "cpu":
        return backends.apply_event_ring_whatif(
            spec, ring, s, res, a, wstar, idx[2:], coef, lrs, idx[0], idx[1])
    if ring.device.type != "cuda":
        raise ValueError(f"ring_apply_whatif runs on cuda (kernel) or cpu "
                         f"(plain version), not {ring.device.type}")
    lib = _library()
    err = lib.ring_apply_whatif(
        ring.data_ptr(), int(ring.dtype == torch.bfloat16), _ptr(s),
        _ptr(res), a.data_ptr(), wstar.data_ptr(), coef.data_ptr(),
        lrs.data_ptr(), idx.data_ptr(), D, c, _OPT_CODES[spec.optimizer],
        spec.momentum, spec.eps, _vec4(D, ring, s, res, a, wstar),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "ring_apply_whatif")
    launches["ring_apply_whatif"] += 1
    return ring, s, res
