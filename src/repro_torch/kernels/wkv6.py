"""RWKV6 WKV recurrence (chunked, data-dependent per-channel decay): one
call per rwkv layer of a prefill, three kernels counted as one launch
(CUDA, Hopper).

Counterpart of ``repro/kernels/wkv6.py``, whose Pallas TPU kernel
(``wkv6``: ``_wkv_kernel``, grid (batch, heads, chunks) with the (P, P)
state carried across the sequential chunk axis in VMEM scratch) becomes
hand-written CUDA C++ in ``csrc/wkv6.cu``, built by ``kernels/build.py`` and
bound with ``ctypes``.

Per head, with key dim = value dim = P::

    S_t   = diag(exp(w_t)) · S_{t-1} + k_t ⊗ v_t       (w_t < 0)
    out_t = r_t · (S_{t-1} + diag(u) · (k_t ⊗ v_t))

computed per chunk of Q = min(chunk, S) steps in the closed form (cum the
inclusive cumulative sum of w over the chunk, cum⁻ = cum − w, S₀ the state
entering the chunk)::

    out_i = (r_i ∘ exp(cum⁻_i)) · S₀
            + Σ_{j<i} [Σ_p r_ip k_jp exp(cum⁻_ip − cum_jp)] v_j
            + (r_i ∘ u ∘ k_i) · v_i
    S'    = diag(exp(cum_Q)) S₀ + Σ_j (k_j ∘ exp(cum_Q − cum_j)) ⊗ v_j

Every exponent is ≤ 0 where it is used.  For j ≥ i the pair term's
argument is ≥ 0 and overflows at a strong decay: the TPU kernel computes it
and selects zero afterwards; the plain version masks to −inf before the
exponential.  The kernel's direct form skips those pairs; its factored form
(a chunk whose decay span is at most ``FACTOR_SPAN``) multiplies factors
within e^±30, so every product is finite, and selects those pairs away.

Operands: r/k/v (B, S, H, P) fp32 or bf16 (one dtype), w (B, S, H, P) fp32
(the log decay), u (H, P) fp32, each with a contiguous last dim.  Returns
(out (B, S, H, P) fp32, final state (B, H, P, P) fp32).  The kernel starts
from a zero state, as the TPU kernel does (its scratch is zeroed; the
reference's ``ops.wkv6`` drops an ``init_state`` silently):
:func:`wkv6` refuses any ``init_state`` but None instead.  A ragged S: the
plain version zero-pads (w = 0 there: exp(0) = 1, a harmless tail) and
slices back; the kernel reads zeros past S, which is the same.

``wkv6`` checks shapes, dtypes and strides, then launches the kernels on
CUDA tensors — or, for CPU tensors, runs :func:`wkv6_plain`, which the
kernels are held against on the card.  Nothing falls back: a CUDA call
launches or raises.

On the card one call is three launches on the current stream, the staged
algorithm of the source's header: per (b, h, group of ``GROUP`` chunks)
the group's own state contribution and decay; a pass per (b, h) for the
state entering each group; per (b, h, group) the group's chunks from that
state, writing out.  A chunk's pair term takes a factored form (a
Q × Q × P product) where its decay span is at most ``FACTOR_SPAN``, the
direct form otherwise.  The wrapper allocates the scratch with
``torch.empty`` (:func:`scratch_shapes`): 16.8 MB of group states and
0.26 MB of group decays at rwkv6_7b's layer (B 1, S 8 192, H 64, P 64,
chunk 32).  ``launches["wkv6"]`` counts one per call, whatever the number
of kernels it launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build

DEFAULT_CHUNK = 32
MAX_CHUNK = 32                # csrc/wkv6.cu: at most 32 rows a chunk
HEAD_DIMS = (32, 64, 128)     # P the kernel is built for
GROUP = 16                    # csrc/wkv6.cu: chunks a group
FACTOR_SPAN = 60.0            # csrc/wkv6.cu: the factored pair term's limit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches()
launches = obs.counter_group("launch", ("wkv6",))


def reset_launches() -> None:
    launches["wkv6"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernels with their C signature declared; the chunk limit,
    the group size and the factored form's span limit must be the ones
    this module assumes."""
    lib = build.load("wkv6")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.wkv6_fwd.restype = i
    lib.wkv6_max_chunk.restype = i
    lib.wkv6_group.restype = i
    lib.wkv6_factor_span.restype = ctypes.c_float
    got = (lib.wkv6_max_chunk(), lib.wkv6_group(), lib.wkv6_factor_span())
    want = (MAX_CHUNK, GROUP, FACTOR_SPAN)
    if got != want:
        raise RuntimeError(f"wkv6 library: chunk limit, group size and "
                           f"factor span {got}, expected {want}")
    return lib


def scratch_shapes(Bt: int, S: int, H: int, P: int,
                   Q: int) -> Tuple[Tuple[int, ...], ...]:
    """The kernels' fp32 scratch: the group states (B, ng, H, P, P) and the
    group decays (B, ng, H, P), ng = ⌈⌈S / Q⌉ / GROUP⌉."""
    nc = -(-S // Q)
    ng = -(-nc // GROUP)
    return (Bt, ng, H, P, P), (Bt, ng, H, P)


def _shapes(r, k, v, w, u) -> Tuple[int, int, int, int]:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, P), got {tuple(r.shape)}")
    Bt, S, H, P = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} must be {tuple(r.shape)}, got "
                             f"{tuple(t.shape)}")
    if tuple(u.shape) != (H, P):
        raise ValueError(f"u must be {(H, P)}, got {tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k and v must share one dtype of fp32 / bf16, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"w and u must be fp32, got {w.dtype}, {u.dtype}")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("r, k, v, w and u must lie on one device")
    if min(Bt, S, H, P) < 1:
        raise ValueError(f"empty operand: r {tuple(r.shape)}")
    return Bt, S, H, P


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
         init_state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV from a zero state; operands and results as in the module
    docstring."""
    if init_state is not None:
        raise ValueError("wkv6 starts from a zero state (the TPU kernel's "
                         "zeroed scratch); run models.rwkv.wkv_recurrent or "
                         "wkv_chunked for another initial state")
    Bt, S, H, P = _shapes(r, k, v, w, u)
    if chunk < 1:
        raise ValueError(f"chunk = {chunk}")
    dev = r.device
    if dev.type == "cpu":
        return wkv6_plain(r, k, v, w, u, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev.type}")
    Q = min(chunk, S)
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q}; the kernel takes chunks up to "
                         f"{MAX_CHUNK}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P}; the kernel takes {HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    r, k, v, w = (build.aligned16(t) for t in (r, k, v, w))
    out = torch.empty((Bt, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bt, H, P, P), dtype=torch.float32, device=dev)
    st, dg = (torch.empty(shape, dtype=torch.float32, device=dev)
              for shape in scratch_shapes(Bt, S, H, P, Q))
    strides = tuple(s for t in (r, k, v, w) for s in t.stride()[:3])
    lib = _library()
    err = lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), out.data_ptr(), state.data_ptr(), st.data_ptr(),
        dg.data_ptr(), (ctypes.c_longlong * 12)(*strides), Bt, S, H, P, Q,
        _DTYPES[r.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(lib, "wkv6", err, "wkv6")
    launches["wkv6"] += 1
    return out, state


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               chunk: int = DEFAULT_CHUNK,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the TPU kernel's chunk loop
    in fp32 with its (Q, Q, P) pair tensor, vectorised over batch and
    heads, from ``init_state`` (zeros when None; (B, H, P, P)).  Returns
    (out fp32, final state fp32).  Also the port's
    ``models.rwkv.wkv_chunked``: the reference's unrolled path computes the
    same chunked closed form."""
    Bt, S, H, P = r.shape
    f32 = torch.float32
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):          # (B, S, H, P) → (nc, B, H, Q, P) fp32
        t = t.to(f32)
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(Bt, nc, Q, H, P).permute(1, 0, 3, 2, 4)

    rb, kb, vb, wb = (chunks(t) for t in (r, k, v, w))
    uf = u.to(f32)[None, :, None, :]                          # (1,H,1,P)
    state = (torch.zeros((Bt, H, P, P), dtype=f32, device=r.device)
             if init_state is None else init_state.to(f32))
    strict = torch.ones((Q, Q), dtype=torch.bool,
                        device=r.device).tril(-1)[..., None]  # j < i
    outs = []
    for c in range(nc):
        rc, kc, vc, wc = rb[c], kb[c], vb[c], wb[c]
        cum = torch.cumsum(wc, dim=-2)                        # (Bt,H,Q,P)
        cum_x = cum - wc
        y = torch.matmul(rc * torch.exp(cum_x), state)
        diff = cum_x[..., :, None, :] - cum[..., None, :, :]  # (Bt,H,Q,Q,P)
        E = torch.exp(torch.where(strict, diff, -torch.inf))
        A = (rc[..., :, None, :] * kc[..., None, :, :] * E).sum(-1)
        y = y + torch.matmul(A, vc) + (rc * uf * kc).sum(-1, keepdim=True) * vc
        last = cum[..., -1:, :]                               # (Bt,H,1,P)
        kw = kc * torch.exp(last - cum)
        state = (torch.exp(last).transpose(-1, -2) * state
                 + torch.matmul(kw.transpose(-1, -2), vc))
        outs.append(y)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(Bt, nc * Q, H, P)
    return out[:, :S], state
