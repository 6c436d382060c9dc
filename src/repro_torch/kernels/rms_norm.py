"""RMSNorm in one pass over each row (CUDA, Hopper).

No TPU kernel corresponds: the reference leaves the norm to XLA, which
fuses it; the port's plain PyTorch (:func:`rms_norm_plain`, which every
model's ``layers.rms_norm`` is) runs it as ~8 launches a call through fp32
intermediates.  ``csrc/rms_norm.cu`` holds the kernel, built by
``kernels/build.py`` and bound with ``ctypes``.

:func:`rms_norm` normalises each row of ``x`` (…, W) in the model's dtype
(bf16 or fp32): fp32 x, the mean of its squares, rsqrt(mean + ``eps``),
x times that times ``scale`` (W,), rounded once to x's dtype.  With
``tail`` (…, W2) the row is concat(x, tail) (W + W2 columns, ``scale`` of
that width), read through two pointers so the concatenation is never
materialised; the plain version concatenates.

The kernel rounds where the plain version rounds; only the order of each
row's fp32 sum of squares differs, which moves 1/rms by a few fp32 ulps:
the kernel is held to the plain version within one ulp in bf16 and 8 in
fp32.  A CPU tensor runs the plain version.
``ops.rms_norm`` refuses autograd (no backward): training runs the plain
version (``use_pallas`` off).  ``launches`` counts one per launch on the
card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches()
launches = obs.counter_group("launch", ("rms_norm",))


def reset_launches() -> None:
    launches["rms_norm"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel with its C signatures declared."""
    lib = build.load("rms_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rms_norm_fwd.argtypes = [p] * 4 + [i] * 3 + [ctypes.c_float, i, p]
    lib.rms_norm_fwd.restype = i
    lib.rms_norm_max_width.restype = i
    return lib


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
             tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (or of concat(x, ``tail``) along the
    last dim), times ``scale``: the module docstring.  On the card x, tail
    and scale share one dtype (fp32 or bf16), are contiguous and have
    widths that are multiples of 8."""
    pieces = (x,) if tail is None else (x, tail)
    W = sum(t.shape[-1] for t in pieces)
    if (tail is not None and tail.shape[:-1] != x.shape[:-1]) \
            or tuple(scale.shape) != (W,):
        raise ValueError(f"rms_norm: x {tuple(x.shape)}, tail "
                         f"{None if tail is None else tuple(tail.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not build.on_card("rms_norm", *pieces, scale):
        return rms_norm_plain(x, scale, eps, tail=tail)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (*pieces, scale)):
        raise ValueError(f"rms_norm takes fp32 or bf16 operands of one "
                         f"dtype; got {[t.dtype for t in (*pieces, scale)]}")
    widths = [t.shape[-1] for t in pieces]
    lib = _library()
    if any(w % 8 or not w for w in widths) or W > lib.rms_norm_max_width():
        raise ValueError(f"rms_norm: the kernel reads 8 columns at a time "
                         f"and rows of at most {lib.rms_norm_max_width()}; "
                         f"got widths {widths}")
    if not all(t.is_contiguous() for t in (*pieces, scale)):
        raise ValueError("rms_norm: x, tail and scale must be contiguous")
    rows = x.numel() // widths[0]
    out = torch.empty(x.shape[:-1] + (W,), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    x, scale = build.aligned16(x), build.aligned16(scale)
    tail = x if tail is None else build.aligned16(tail)
    err = lib.rms_norm_fwd(
        x.data_ptr(), tail.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, W, widths[0], eps, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on(lib, "rms_norm", err, "rms_norm")
    launches["rms_norm"] += 1
    return out


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                   *, tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`rms_norm` in plain PyTorch (``models.layers.rms_norm``)."""
    if tail is not None:
        x = torch.cat([x, tail], dim=-1)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def nbytes(rows: int, width: int, itemsize: int = 2) -> int:
    """A call's least traffic: each row read once and written once."""
    return 2 * rows * width * itemsize
