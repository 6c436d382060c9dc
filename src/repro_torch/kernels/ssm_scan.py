"""Mamba2 SSD chunked scan: one kernel launch per mamba layer of a prefill
(CUDA, Hopper).

Counterpart of ``repro/kernels/ssm_scan.py``, whose Pallas TPU kernel
(``ssm_scan``: ``_ssd_kernel``, grid (batch, heads, chunks) with the (N, P)
state carried across the sequential chunk axis in VMEM scratch) becomes
hand-written CUDA C++ in ``csrc/ssm_scan.cu``, built by ``kernels/build.py``
and bound with ``ctypes``.

Operands follow ``models.ssm.ssd_chunked``:

* x (B, S, H, P) fp32 — the dt-premultiplied inputs;
* a (B, S, H) fp32 — the per-step log decay (dt · A, negative);
* Bm / Cm (B, S, N) or (B, S, G, N) — the input and output projections,
  in G groups (Mamba2's ``n_groups``; (B, S, N) is G = 1): head h reads
  group h // (H / G).  fp32 or bf16 (one dtype for both), with a
  contiguous last dim: the mamba block passes column slices of its
  (B, S, 2N) or (B, S, 2GN) ``bc`` tensor, which the kernel reads through
  element strides without a copy.

Returns (y (B, S, H, P) fp32, final state (B, H, N, P) fp32).  Per chunk of
Q = min(chunk, S) steps, with cum the inclusive cumulative sum of a::

    y_i   = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) x_j + exp(cum_i) C_i·S₀
    S'    = exp(cum_Q) S₀ + Σ_j B_j ⊗ exp(cum_Q − cum_j) x_j

The decay exp(cum_i − cum_j) is formed for j ≤ i only, where its argument
is ≤ 0.  Above the diagonal the argument is as large as the chunk's whole
log decay (about +2 800 at zamba2's A = −(1…112) and dt up to 0.1), whose
exponential is inf: the TPU kernel computes it and then selects zero, but
a product inf · 0 is NaN.  The plain version masks to −inf before the
exponential (the reference's ``_segsum``), the kernel skips those pairs.

A ragged S: the plain version zero-pads to whole chunks and slices back
(the TPU wrapper's padding); the kernel reads zeros for the rows past S
instead, where a = 0 leaves the carried state unchanged, as the padding
does.  ``ssm_scan`` checks shapes, dtypes and strides, then launches the
kernel on CUDA tensors — or, for CPU tensors, runs :func:`ssm_scan_plain`,
which the kernel is held against on the card.  Nothing falls back: a CUDA
call launches or raises.

On the card one call is four launches on the current stream, the staged
algorithm of the source's header: C·Bᵀ per (b, chunk), each chunk's state
contribution per (b, h, chunk), the state pass per (b, h), and y per (b, h,
chunk, 128-row block); C·Bᵀ is formed once per (b, group, chunk).  Every
tile product runs on the tensor cores as split TF32: an fp32 operand is
split into a TF32 big part and the TF32 rounding of its remainder and the
product taken as big·small + small·big + big·big, fp32's accuracy; a bf16
B or C is exact in TF32 and not split.  The wrapper allocates their
scratch with ``torch.empty``
(:func:`scratch_shapes`): at zamba2_7b's layer (B 1, S 8 192, H 112,
N = P = 64, chunk 256, G 1) 8.4 MB of C·Bᵀ, 3.7 MB of cumulative sums and
58.7 MB of per-chunk states.  ``launches["ssm_scan"]`` counts one
per call, whatever the number of kernels it launched, and
``launches_by_bc`` the same calls by B / C dtype (``bf16_bc``,
``fp32_bc``: whether B and C were split).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build

DEFAULT_CHUNK = 256
MAX_CHUNK = 256                  # csrc/ssm_scan.cu: one scan of ≤ 256 rows
HEAD_DIMS = (32, 64, 128)        # P the kernel is built for
STATE_DIMS = (16, 32, 64, 128)   # N the kernel is built for
_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches(), and of those each call's
# B / C dtype: bf16 operands are exact in TF32 and not split, fp32 ones are
# split (csrc/ssm_scan.cu's header)
launches = obs.counter_group("launch", ("ssm_scan",))
launches_by_bc = obs.counter_group("launch.ssm_scan", ("bf16_bc", "fp32_bc"))
_BC_PATH = {torch.float32: "fp32_bc", torch.bfloat16: "bf16_bc"}


def reset_launches() -> None:
    launches["ssm_scan"] = 0
    for path in launches_by_bc:
        launches_by_bc[path] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel with its C signature declared; its chunk limit
    must be the one this module assumes."""
    lib = build.load("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                 i, i, i, i, i, i, i, i, p]
    lib.ssm_scan_fwd.restype = i
    lib.ssm_scan_max_chunk.restype = i
    if lib.ssm_scan_max_chunk() != MAX_CHUNK:
        raise RuntimeError(f"ssm_scan_max_chunk() = "
                           f"{lib.ssm_scan_max_chunk()}, expected "
                           f"{MAX_CHUNK}")
    return lib


def _shapes(x, a, Bm, Cm) -> Tuple[int, int, int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bt, S, H, P = x.shape
    if tuple(a.shape) != (Bt, S, H):
        raise ValueError(f"a must be {(Bt, S, H)}, got {tuple(a.shape)}")
    if Bm.dim() not in (3, 4) or tuple(Bm.shape[:2]) != (Bt, S) \
            or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"Bm/Cm must be ({Bt}, {S}, N) or ({Bt}, {S}, G, "
                         f"N), got {tuple(Bm.shape)} and "
                         f"{tuple(Cm.shape)}")
    G = Bm.shape[2] if Bm.dim() == 4 else 1
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"x and a must be fp32, got {x.dtype}, {a.dtype}")
    if Bm.dtype not in _BC_DTYPES or Cm.dtype != Bm.dtype:
        raise ValueError(f"Bm and Cm must share one dtype of fp32 / bf16, "
                         f"got {Bm.dtype}, {Cm.dtype}")
    if not (x.device == a.device == Bm.device == Cm.device):
        raise ValueError(f"x, a, Bm and Cm lie on {x.device}, {a.device}, "
                         f"{Bm.device}, {Cm.device}")
    if min(Bt, S, H, P, Bm.shape[-1]) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    return Bt, S, H, P, Bm.shape[-1], G


def scratch_shapes(Bt: int, S: int, H: int, P: int, N: int, Q: int,
                   G: int = 1) -> Tuple[Tuple[int, ...], ...]:
    """The kernel's fp32 scratch: C·Bᵀ (B, G, nc, Q, ldq), the cumulative
    sums (B, H, nc, Q) and the per-chunk states (B, nc, H, N, P), nc =
    ⌈S / Q⌉, ldq = Q rounded up to a multiple of 4 (16-byte rows)."""
    nc = -(-S // Q)
    return ((Bt, G, nc, Q, -(-Q // 4) * 4), (Bt, H, nc, Q),
            (Bt, nc, H, N, P))


def ssm_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = DEFAULT_CHUNK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state; operands and results as in the
    module docstring."""
    Bt, S, H, P, N, G = _shapes(x, a, Bm, Cm)
    if chunk < 1:
        raise ValueError(f"chunk = {chunk}")
    dev = x.device
    if dev.type == "cpu":
        return ssm_scan_plain(x, a, Bm, Cm, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev.type}")
    Q = min(chunk, S)
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q}; the kernel takes chunks up to "
                         f"{MAX_CHUNK}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"head dim {P}, state dim {N}; the kernel takes "
                         f"P in {HEAD_DIMS} and N in {STATE_DIMS}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("x, Bm and Cm must have a contiguous last dim")
    x, Bm, Cm = (build.aligned16(t) for t in (x, Bm, Cm))
    y = torch.empty((Bt, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bt, H, N, P), dtype=torch.float32, device=dev)
    cb, cum, st = (torch.empty(shape, dtype=torch.float32, device=dev)
                   for shape in scratch_shapes(Bt, S, H, P, N, Q, G))
    grouped = Bm.dim() == 4
    strides = (x.stride(0), x.stride(1), x.stride(2),
               a.stride(0), a.stride(1), a.stride(2),
               Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
               Bm.stride(2) if grouped else 0, Cm.stride(2) if grouped else 0)
    lib = _library()
    err = lib.ssm_scan_fwd(
        x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), cb.data_ptr(), cum.data_ptr(),
        st.data_ptr(), (ctypes.c_longlong * 12)(*strides), Bt, S, H, P, N, Q,
        G, _BC_DTYPES[Bm.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(lib, "ssm_scan", err, "ssm_scan")
    launches["ssm_scan"] += 1
    launches_by_bc[_BC_PATH[Bm.dtype]] += 1
    return y, state


def ssm_scan_plain(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the TPU kernel's chunk loop
    in fp32, vectorised over batch and heads, from ``init_state`` (zeros
    when None; (B, H, N, P)).  Returns (y in x's dtype, final state fp32).
    Also the port's ``models.ssm.ssd_chunked``: the reference's XLA path
    computes the same chunked algorithm.  Grouped B / C ((B, S, G, N))
    run the loop once per group over its H / G heads; G = 1 is the
    ungrouped loop itself."""
    if Bm.dim() == 4:
        G = Bm.shape[2]
        if G == 1:
            return ssm_scan_plain(x, a, Bm[:, :, 0], Cm[:, :, 0],
                                  chunk=chunk, init_state=init_state)
        hg = x.shape[2] // G
        parts = [ssm_scan_plain(
            x[:, :, g * hg:(g + 1) * hg], a[..., g * hg:(g + 1) * hg],
            Bm[:, :, g], Cm[:, :, g], chunk=chunk,
            init_state=None if init_state is None
            else init_state[:, g * hg:(g + 1) * hg]) for g in range(G)]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([st for _, st in parts], dim=1))
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, af, Bf, Cf = (t.to(f32) for t in (x, a, Bm, Cm))
    if pad:
        F = torch.nn.functional
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        af = F.pad(af, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xb = xf.reshape(Bt, nc, Q, H, P).permute(1, 0, 3, 2, 4)   # (nc,Bt,H,Q,P)
    ab = af.reshape(Bt, nc, Q, H).permute(1, 0, 3, 2)         # (nc,Bt,H,Q)
    Bb = Bf.reshape(Bt, nc, Q, N).transpose(0, 1)             # (nc,Bt,Q,N)
    Cb = Cf.reshape(Bt, nc, Q, N).transpose(0, 1)
    state = (torch.zeros((Bt, H, N, P), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for c in range(nc):
        xc, Bc, Cc = xb[c], Bb[c], Cb[c]
        cum = torch.cumsum(ab[c], dim=-1)                     # (Bt,H,Q)
        decay = torch.exp(segsum(cum))                        # lower-tri
        scores = torch.matmul(Cc, Bc.transpose(-1, -2))       # (Bt,Q,Q)
        y = torch.matmul(scores[:, None] * decay, xc)         # (Bt,H,Q,P)
        y = y + torch.exp(cum)[..., None] * torch.matmul(Cc[:, None], state)
        total = cum[..., -1:]                                 # (Bt,H,1)
        w = torch.exp(total - cum)                            # (Bt,H,Q)
        state = (torch.exp(total)[..., None] * state
                 + torch.matmul(Bc.transpose(-1, -2)[:, None],
                                w[..., None] * xc))
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(Bt, nc * Q, H, P)
    return y[:, :S].to(x.dtype), state


def segsum(cum: torch.Tensor) -> torch.Tensor:
    """cum: (..., Q), an inclusive cumulative sum.  Returns (..., Q, Q)
    with out[i, j] = cum_i − cum_j (= Σ_{t=j+1..i} a_t) for i ≥ j and −inf
    above the diagonal — masked before any exponential (the reference's
    ``models.ssm._segsum`` on the cumulative sum)."""
    Q = cum.shape[-1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.where(tri, diff, -torch.inf)
