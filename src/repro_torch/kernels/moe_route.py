"""The two memory-bound ends of a dropless top-k MoE layer (CUDA, Hopper):
the dispatch of every (token, k) pair to its expert, and the combine of
the experts' rows back into the residual stream.

No TPU kernel corresponds: the reference's MoE is a capacity MoE in plain
jnp (``models/moe.py`` keeps it bitwise), and a dropless prefill is what
``models/granite.py`` serves.  ``csrc/moe_route.cu`` holds both kernels,
built by ``kernels/build.py`` and bound with ``ctypes``.

:func:`moe_dispatch` takes the router's fp32 logits (T, E) and the
normed rows x (T, M) and returns a :class:`Routed`: per token its ``k``
experts (larger logit first, ties to the lower expert; NaN ranks as
−inf) and the softmax over those k logits (``gates``, fp32); per expert
its ``counts`` and the ``ends`` of its rows (the cumulative counts,
int32, on the device: what a grouped product reads); ``pos`` (T, k), the
row of each pair in expert order, a stable permutation (within an
expert, rows in token order); and ``xs`` (T·k, M), x's rows gathered into
that order.  Three launches on the card, counted as one call.

:func:`moe_combine` adds, per token and column in fp32 and in k order,
the gate-weighted sum of the token's k expert rows, then the shared
MLP's output, multiplies by ``mult`` (the residual multiplier), adds the
residual and rounds once to the model dtype.  No atomics: the result is
the same on every run.

Each has a plain PyTorch version (``*_plain``) that CPU tensors run and
that the kernels are held to on the card: the dispatch bitwise but for
the gates (the kernel's ``expf`` and sum order against PyTorch's
softmax: within 4 fp32 ulps), the combine bitwise given the same gates.
``ops.moe_dispatch`` / ``ops.moe_combine`` refuse autograd (no
backward).  ``launches`` counts one per call on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches (calls) since the last reset_launches()
launches = obs.counter_group("launch", ("moe_dispatch", "moe_combine"))


def reset_launches() -> None:
    launches["moe_dispatch"] = 0
    launches["moe_combine"] = 0


class Routed(NamedTuple):
    """What :func:`moe_dispatch` returns (see the module docstring)."""
    experts: torch.Tensor   # (T, k) int32
    gates: torch.Tensor     # (T, k) fp32
    counts: torch.Tensor    # (E,) int32
    ends: torch.Tensor      # (E,) int32, cumulative counts
    pos: torch.Tensor       # (T, k) int32, each pair's row
    xs: torch.Tensor        # (T·k, M), x's rows in expert order


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("moe_route")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch_fwd.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.moe_dispatch_fwd.restype = i
    lib.moe_combine_fwd.argtypes = [p] * 6 + [i] * 3 + [ctypes.c_float, i,
                                                        p]
    lib.moe_combine_fwd.restype = i
    for name in ("moe_route_max_experts", "moe_route_max_topk",
                 "moe_route_tile"):
        getattr(lib, name).restype = i
    return lib


def _check_rows(name: str, *rows: torch.Tensor) -> None:
    if rows[0].dtype not in _DTYPES or any(r.dtype != rows[0].dtype
                                           for r in rows):
        raise ValueError(f"{name} takes fp32 or bf16 rows of one dtype; got "
                         f"{[r.dtype for r in rows]}")
    M = rows[0].shape[-1]
    if M % 8 or not all(r.is_contiguous() for r in rows):
        raise ValueError(f"{name}: contiguous rows of a width that is a "
                         f"multiple of 8; got width {M}")


def moe_dispatch(logits: torch.Tensor, x: torch.Tensor, k: int) -> Routed:
    """Route each row of x to the top ``k`` of its ``logits`` (fp32 (T,
    E)): the module docstring."""
    T, E = logits.shape
    if x.dim() != 2 or x.shape[0] != T or logits.dtype != torch.float32 \
            or not 1 <= k <= E:
        raise ValueError(f"moe_dispatch: logits {tuple(logits.shape)} "
                         f"{logits.dtype}, x {tuple(x.shape)}, k {k}")
    if not build.on_card("moe_dispatch", logits, x):
        return moe_dispatch_plain(logits, x, k)
    lib = _library()
    if E > lib.moe_route_max_experts() or k > lib.moe_route_max_topk():
        raise ValueError(f"moe_dispatch: the kernel takes at most "
                         f"{lib.moe_route_max_experts()} experts and k "
                         f"{lib.moe_route_max_topk()}; got {E}, {k}")
    _check_rows("moe_dispatch", x)
    logits = logits.contiguous()
    M, dev = x.shape[1], x.device
    i32 = dict(dtype=torch.int32, device=dev)
    experts, rank, pos = (torch.empty((T, k), **i32) for _ in range(3))
    gates = torch.empty((T, k), dtype=torch.float32, device=dev)
    tile = lib.moe_route_tile()
    tile_rows = torch.empty((-(-T // tile), E), **i32)
    counts, ends = torch.empty((E,), **i32), torch.empty((E,), **i32)
    xs = torch.empty((T * k, M), dtype=x.dtype, device=dev)
    x = build.aligned16(x)
    err = lib.moe_dispatch_fwd(
        logits.data_ptr(), x.data_ptr(), experts.data_ptr(),
        gates.data_ptr(), rank.data_ptr(), tile_rows.data_ptr(),
        counts.data_ptr(), ends.data_ptr(), pos.data_ptr(), xs.data_ptr(),
        T, E, k, M, _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(lib, "moe_route", err, "moe_dispatch")
    launches["moe_dispatch"] += 1
    return Routed(experts, gates, counts, ends, pos, xs)


def moe_dispatch_plain(logits: torch.Tensor, x: torch.Tensor,
                       k: int) -> Routed:
    """:func:`moe_dispatch` in plain PyTorch."""
    ranked = torch.sort(logits.nan_to_num(nan=float("-inf")), dim=-1,
                        descending=True, stable=True)
    return arrange(ranked.indices[:, :k],
                   torch.softmax(ranked.values[:, :k], dim=-1), x,
                   logits.shape[1])


def arrange(experts: torch.Tensor, gates: torch.Tensor, x: torch.Tensor,
            n_experts: int) -> Routed:
    """The :class:`Routed` of given (T, k) ``experts`` and ``gates``: the
    (token, j) pairs in a stable order by expert, and x's rows so."""
    T, k = experts.shape
    i32 = torch.int32
    flat = experts.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices        # pairs by expert
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=x.device)
    counts = torch.bincount(flat, minlength=n_experts)
    return Routed(experts.to(i32), gates, counts.to(i32),
                  torch.cumsum(counts, 0).to(i32),
                  pos.reshape(T, k).to(i32), x[order // k])


def moe_combine(rows: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                shared: torch.Tensor, residual: torch.Tensor,
                mult: float) -> torch.Tensor:
    """``residual + mult · (Σ_j gates_j · rows[pos_j] + shared)`` per
    token, in fp32, rounded once: the module docstring.  rows (T·k, M);
    gates (T, k) fp32; pos (T, k) int32; shared, residual (T, M)."""
    T, k = gates.shape
    M = residual.shape[-1]
    if rows.shape != (T * k, M) or tuple(pos.shape) != (T, k) \
            or shared.shape != residual.shape or residual.dim() != 2 \
            or gates.dtype != torch.float32 or pos.dtype != torch.int32:
        raise ValueError(f"moe_combine: rows {tuple(rows.shape)}, gates "
                         f"{tuple(gates.shape)} {gates.dtype}, pos "
                         f"{tuple(pos.shape)} {pos.dtype}, shared "
                         f"{tuple(shared.shape)}, residual "
                         f"{tuple(residual.shape)}")
    if not build.on_card("moe_combine", rows, gates, pos, shared, residual):
        return moe_combine_plain(rows, gates, pos, shared, residual, mult)
    lib = _library()
    if k > lib.moe_route_max_topk():
        raise ValueError(f"moe_combine: k {k} > "
                         f"{lib.moe_route_max_topk()}")
    _check_rows("moe_combine", rows, shared, residual)
    gates, pos = gates.contiguous(), pos.contiguous()
    rows, shared, residual = (build.aligned16(t)
                              for t in (rows, shared, residual))
    out = torch.empty_like(residual)
    err = lib.moe_combine_fwd(
        rows.data_ptr(), gates.data_ptr(), pos.data_ptr(), shared.data_ptr(),
        residual.data_ptr(), out.data_ptr(), T, k, M, mult,
        _DTYPES[rows.dtype], torch.cuda.current_stream(rows.device)
        .cuda_stream)
    build.raise_on(lib, "moe_route", err, "moe_combine")
    launches["moe_combine"] += 1
    return out


def moe_combine_plain(rows: torch.Tensor, gates: torch.Tensor,
                      pos: torch.Tensor, shared: torch.Tensor,
                      residual: torch.Tensor, mult: float) -> torch.Tensor:
    """:func:`moe_combine` in plain PyTorch, rounding where the kernel
    rounds."""
    f32 = torch.float32
    acc = torch.zeros(residual.shape, dtype=f32, device=residual.device)
    for j in range(gates.shape[1]):
        acc = acc + gates[:, j:j + 1] * rows[pos[:, j].long()].to(f32)
    out = (acc + shared.to(f32)) * mult + residual.to(f32)
    return out.to(residual.dtype)

