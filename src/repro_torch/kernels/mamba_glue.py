"""The Mamba2 layer's elementwise chain around ``ssm_scan``: one prologue
launch and one epilogue launch per layer of a prefill (CUDA, Hopper).

No TPU kernel corresponds: the reference leaves this chain to XLA, which
fuses it; the port's plain PyTorch ran it as ~25 launches a layer, each
over a whole (B, S, ~7 000) tensor.  ``csrc/mamba_glue.cu`` holds both
kernels, built by ``kernels/build.py`` and bound with ``ctypes``.

:func:`mamba_in`, from the fused input projection [z | x B C | dt]'s
column views ``xbc`` (B, S, C) and ``dt`` (B, S, H), in the model's dtype
(bf16 or fp32):

* the depthwise causal convolution of ``xbc`` over its K = 4 taps with
  zeros before position 0, + ``conv_b``, SiLU: (B, S, C), contiguous, in
  ``xbc``'s dtype (the scan reads B and C as its column slices);
* dt = softplus(dt + ``dt_bias``) (threshold 20) and
  a = dt · −exp(``A_log``): (B, S, H) fp32;
* xdt = x · dt, x the first H·P convolved columns: (B, S, H, P) fp32.

:func:`mamba_out`, from the scan's y (B, S, H, P) fp32, x (B, S, H, P)
and z (B, S, H·P): (y + x·D) · silu(z), RMS-normalised over each of
``groups`` groups of columns with ``eps``, times ``gate_norm``: (B, S, H·P)
in z's dtype, the out projection's input.

The kernels round where the plain versions round (:func:`mamba_in_plain`,
:func:`mamba_out_plain`, which a CPU tensor runs): the prologue is bitwise
the plain version on the card, the epilogue within one ulp of its dtype
(the order of each group's fp32 sum of squares differs).  Both wrappers
refuse to run under autograd with an operand that requires a gradient
(``ops._no_graph``): training runs the plain versions (``use_pallas``
off).  ``launches`` counts one per launch on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import build

CONV_TAPS = 4                    # csrc/mamba_glue.cu: K
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches()
launches = obs.counter_group("launch", ("mamba_in", "mamba_out"))


def reset_launches() -> None:
    launches["mamba_in"] = 0
    launches["mamba_out"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (each refuses
    taps other than its K)."""
    lib = build.load("mamba_glue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba_in_fwd.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.mamba_in_fwd.restype = i
    lib.mamba_out_fwd.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, i, p]
    lib.mamba_out_fwd.restype = i
    return lib


def _check_widths(name: str, dtype, **widths) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"{name} takes fp32 or bf16, got {dtype}")
    odd = {k: w for k, w in widths.items() if w % 8}
    if odd:
        raise ValueError(f"{name}: the kernel reads 8 columns at a time; "
                         f"{odd} are not multiples of 8")


def mamba_in(xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
             conv_b: torch.Tensor, dt_bias: torch.Tensor,
             A_log: torch.Tensor, *, head_dim: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prologue (module docstring): xbc (B, S, C) and dt (B, S, H)
    with a contiguous last dim, conv_w (K, C), conv_b (C,) in xbc's dtype,
    dt_bias and A_log (H,) fp32.  Returns (convolved x B C, xdt, a)."""
    Bt, S, C = xbc.shape
    H = dt.shape[-1]
    Din = H * head_dim
    if tuple(dt.shape) != (Bt, S, H) or Din > C \
            or tuple(conv_w.shape) != (CONV_TAPS, C) \
            or tuple(conv_b.shape) != (C,) \
            or tuple(dt_bias.shape) != (H,) or tuple(A_log.shape) != (H,):
        raise ValueError(f"mamba_in: xbc {tuple(xbc.shape)}, dt "
                         f"{tuple(dt.shape)}, conv_w {tuple(conv_w.shape)}, "
                         f"conv_b {tuple(conv_b.shape)}, dt_bias "
                         f"{tuple(dt_bias.shape)}, A_log "
                         f"{tuple(A_log.shape)} at head dim {head_dim}")
    if not build.on_card("mamba_in", xbc, dt, conv_w, conv_b, dt_bias,
                         A_log):
        return mamba_in_plain(xbc, dt, conv_w, conv_b, dt_bias, A_log,
                              head_dim=head_dim)
    _check_widths("mamba_in", xbc.dtype, C=C, head_dim=head_dim)
    if not (xbc.dtype == dt.dtype == conv_w.dtype == conv_b.dtype) \
            or dt_bias.dtype != torch.float32 \
            or A_log.dtype != torch.float32:
        raise ValueError(f"mamba_in: xbc, dt, conv_w, conv_b share one "
                         f"dtype and dt_bias, A_log are fp32; got "
                         f"{xbc.dtype}, {dt.dtype}, {conv_w.dtype}, "
                         f"{conv_b.dtype}, {dt_bias.dtype}, {A_log.dtype}")
    if xbc.stride(-1) != 1 or dt.stride(-1) != 1:
        raise ValueError("mamba_in: xbc and dt need a contiguous last dim")
    xbc = build.aligned16(xbc)
    conv_w, conv_b, dt_bias, A_log = (t.contiguous() for t in
                                      (conv_w, conv_b, dt_bias, A_log))
    dev = xbc.device
    out = torch.empty((Bt, S, C), dtype=xbc.dtype, device=dev)
    xdt = torch.empty((Bt, S, H, head_dim), dtype=torch.float32, device=dev)
    a = torch.empty((Bt, S, H), dtype=torch.float32, device=dev)
    strides = (xbc.stride(0), xbc.stride(1), dt.stride(0), dt.stride(1))
    lib = _library()
    err = lib.mamba_in_fwd(
        xbc.data_ptr(), dt.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
        dt_bias.data_ptr(), A_log.data_ptr(), out.data_ptr(), xdt.data_ptr(),
        a.data_ptr(), (ctypes.c_longlong * 4)(*strides), Bt, S, C, Din, H,
        head_dim, CONV_TAPS, _DTYPES[xbc.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(lib, "mamba_glue", err, "mamba_in")
    launches["mamba_in"] += 1
    return out, xdt, a


def mamba_out(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
              D: torch.Tensor, gate_norm: torch.Tensor, *, groups: int,
              eps: float) -> torch.Tensor:
    """The epilogue (module docstring): y (B, S, H, P) fp32, xs
    (B, S, H, P) and z (B, S, H·P) with contiguous rows of H·P, D (H,)
    fp32, gate_norm (H·P,) in z's dtype.  Returns (B, S, H·P) in z's
    dtype."""
    Bt, S, H, P = y.shape
    Din = H * P
    if tuple(xs.shape) != (Bt, S, H, P) or tuple(z.shape) != (Bt, S, Din) \
            or tuple(D.shape) != (H,) or tuple(gate_norm.shape) != (Din,) \
            or groups < 1 or H % groups:
        raise ValueError(f"mamba_out: y {tuple(y.shape)}, xs "
                         f"{tuple(xs.shape)}, z {tuple(z.shape)}, D "
                         f"{tuple(D.shape)}, gate_norm "
                         f"{tuple(gate_norm.shape)} in {groups} groups")
    if not build.on_card("mamba_out", y, xs, z, D, gate_norm):
        return mamba_out_plain(y, xs, z, D, gate_norm, groups=groups,
                               eps=eps)
    _check_widths("mamba_out", z.dtype, head_dim=P,
                  group_width=Din // groups)
    if y.dtype != torch.float32 or D.dtype != torch.float32 \
            or not (xs.dtype == z.dtype == gate_norm.dtype):
        raise ValueError(f"mamba_out: y and D are fp32 and xs, z, "
                         f"gate_norm share one dtype; got {y.dtype}, "
                         f"{D.dtype}, {xs.dtype}, {z.dtype}, "
                         f"{gate_norm.dtype}")
    xs = xs.flatten(-2)
    if xs.stride(-1) != 1 or z.stride(-1) != 1:
        raise ValueError("mamba_out: xs and z need contiguous rows")
    y, D, gate_norm = (t.contiguous() for t in (y, D, gate_norm))
    y, xs, z = (build.aligned16(t) for t in (y, xs, z))
    out = torch.empty((Bt, S, Din), dtype=z.dtype, device=z.device)
    strides = (xs.stride(0), xs.stride(1), z.stride(0), z.stride(1))
    lib = _library()
    err = lib.mamba_out_fwd(
        y.data_ptr(), xs.data_ptr(), z.data_ptr(), D.data_ptr(),
        gate_norm.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 4)(*strides), Bt, S, Din, P, groups, eps,
        _DTYPES[z.dtype], torch.cuda.current_stream(z.device).cuda_stream)
    build.raise_on(lib, "mamba_glue", err, "mamba_out")
    launches["mamba_out"] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------
def causal_conv_plain(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      history: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  xc (B, S, D); w (K, D).  Returns the output
    and the trailing K-1 inputs (decode cache).  The K products are summed
    in the input dtype in the order i = 0…K−1, as the reference's Python
    ``sum`` does."""
    K = w.shape[0]
    S = xc.shape[1]
    if history is None:
        history = torch.zeros((xc.shape[0], K - 1, xc.shape[-1]),
                              dtype=xc.dtype, device=xc.device)
    xin = torch.cat([history, xc], dim=1)
    out = xin[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xin[:, i:i + S] * w[i]
    out = F.silu((out + b).to(torch.float32)).to(xc.dtype)
    return out, xin[:, -(K - 1):]


def mamba_in_plain(xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor, *, head_dim: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`mamba_in` in plain PyTorch: the convolution of
    :func:`causal_conv_plain` (each product and partial sum in the input
    dtype), then dt, a and xdt in fp32."""
    H = dt.shape[-1]
    xbc, _ = causal_conv_plain(xbc, conv_w, conv_b)
    xs = xbc[..., :H * head_dim].unflatten(-1, (H, head_dim))
    dt = F.softplus(dt.to(torch.float32) + dt_bias)          # (B,S,H)
    a = dt * -torch.exp(A_log)
    xdt = xs.to(torch.float32) * dt[..., None]
    return xbc, xdt, a


def mamba_out_plain(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                    D: torch.Tensor, gate_norm: torch.Tensor, *, groups: int,
                    eps: float) -> torch.Tensor:
    """:func:`mamba_out` in plain PyTorch."""
    y = y + xs.to(torch.float32) * D[:, None]
    return gated_norm_plain(y.flatten(-2), z, gate_norm, groups, eps,
                            z.dtype)


def gated_norm_plain(y: torch.Tensor, z: torch.Tensor,
                     gate_norm: torch.Tensor, groups: int, eps: float,
                     dtype) -> torch.Tensor:
    """RMSNorm(y · silu(z)) over ``groups`` groups of the last dim, times
    ``gate_norm``, in ``dtype``; y fp32 (…, Din)."""
    h = y * F.silu(z.to(torch.float32))
    hg = h.unflatten(-1, (groups, -1))
    hg = hg * torch.rsqrt(torch.mean(hg * hg, dim=-1, keepdim=True) + eps)
    return (hg.flatten(-2) * gate_norm.to(torch.float32)).to(dtype)


def in_bytes(Bt: int, S: int, C: int, H: int, P: int,
             itemsize: int = 2) -> int:
    """The prologue's least traffic: x B C and dt read once, the convolved
    x B C, xdt and a written once."""
    return Bt * S * ((2 * C + H) * itemsize + (H * P + H) * 4)


def out_bytes(Bt: int, S: int, H: int, P: int, itemsize: int = 2) -> int:
    """The epilogue's least traffic: y, x and z read once, h written
    once."""
    return Bt * S * H * P * (4 + 3 * itemsize)
