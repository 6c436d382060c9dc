"""Flat-buffer update events — the plain PyTorch versions of the replay kernels
(counterpart of the flat-event part of ``repro/optim/backends.py``).

Every function here is the reference's jnp twin rewritten op for op in
eager PyTorch, with two deliberate differences:

* The combine ĝ = Σⱼ coefⱼ·gⱼ is an explicit loop in slot order 0…c−1
  (``acc = acc + coef[j]·g[j]``), not an ``einsum``: the CUDA kernels
  accumulate in exactly that order, so kernel ≡ plain version bitwise on
  the card.  Against the reference's ``einsum("cd,c->d")`` on the CPU the
  order differs, so the two agree within a few ulp (the tolerance is
  stated in ``tests/test_torch_optim.py``).
* Ring events update ``ring``, ``s`` and ``res`` **in place** (as the
  kernels do) and return them, so a (K, D) ring is never copied per event.

``prev``/``slot``/``ts`` are int32 or int64 index tensors on the ring's
device, read without a host sync.
"""

from __future__ import annotations

import torch

from repro_torch.optim.spec import UpdateSpec, update_event

RING_IMPLS = ("auto", "pallas", "fused", "stock")

# columns per pass of the streamed what-if plain version: bounds its
# temporaries to a few × 64 MB whatever D is
WHATIF_CHUNK = 1 << 24


def combine(g: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """ĝ = Σⱼ coefⱼ·gⱼ over the rows of (c, D) fp32 ``g``, in slot order."""
    acc = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    for j in range(g.shape[0]):
        acc = acc + coef[j] * g[j]
    return acc


def apply_event_flat(spec: UpdateSpec, w, s, g, coef, lrs,
                     mode: str = "combine"):
    """The multi-gradient update on flat fp32 buffers: ``w``/``s`` (D,)
    (``s`` None for sgd), ``g`` (c, D), ``coef``/``lrs`` (c,).  Returns
    ``(w', s')`` as new tensors."""
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no flat event path")
    g32 = g.to(torch.float32)
    if mode == "combine":
        return update_event(spec, w, s, combine(g32, coef), lrs[0])
    if mode != "sequential":
        raise ValueError(f"unknown mode {mode!r}")
    for i in range(g.shape[0]):
        w, s = update_event(spec, w, s, coef[i] * g32[i], lrs[i])
    return w, s


def resolve_ring_impl(impl: str, spec: UpdateSpec) -> str:
    """Resolve a RunConfig's ``ring_impl`` to a replay body.

    ``auto`` and ``pallas`` (the reference's name for its TPU megakernel)
    resolve to ``"kernel"``: the ``kernels/replay_ring`` wrappers, which
    launch the CUDA kernels on CUDA tensors and run these plain versions
    on CPU tensors.  ``fused`` calls the plain versions directly on any
    device.  Optimizers without a flat event path (adamw) resolve to
    ``"stock"``, which the port's engine does not run yet."""
    if impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {impl!r}: expected one of "
                         f"{RING_IMPLS}")
    if not spec.kernel_supported:
        return "stock"
    if impl in ("auto", "pallas"):
        return "kernel"
    return impl


def _row(ring: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-dim or (1,) index tensor) of ``ring`` as fp32."""
    return ring.index_select(0, i.reshape(1))[0].to(torch.float32)


def _write_back(ring, s, res, w, s2, slot, lo: int = 0, hi=None):
    """Quantize ``w`` into row ``slot`` (columns lo:hi) and store the new
    state and the error-feedback residue ``w − float(q)``, in place."""
    q = w.to(ring.dtype)
    ring[:, lo:hi].index_copy_(0, slot.reshape(1).to(torch.int64), q[None])
    if s is not None:
        s[lo:hi].copy_(s2)
    if res is not None:
        res[lo:hi].copy_(w - q.to(torch.float32))


def apply_event_ring(spec: UpdateSpec, ring, s, res, g, coef, lrs,
                     prev, slot, mode: str = "combine"):
    """ONE ring event, in place: read row ``prev`` (fp32 or bf16), add the
    fp32 residue ``res`` (bf16 ring), apply the c-gradient update, write the
    quantized result to row ``slot`` and the new residue to ``res``.

    ``ring`` (K, D); ``s``/``res`` (D,) fp32 or None; ``g`` (c, D) fp32;
    ``coef``/``lrs`` (c,) fp32.  The plain version of
    ``kernels.replay_ring.ring_apply``.  The master chain is exact: the
    weights entering the update are ``q(w) + (w − q(w)) = w``."""
    w = _row(ring, prev)
    if res is not None:
        w = w + res
    w, s2 = apply_event_flat(spec, w, s, g, coef, lrs, mode)
    _write_back(ring, s, res, w, s2, slot)
    return ring, s, res


def apply_event_ring_whatif(spec: UpdateSpec, ring, s, res, a, wstar, ts,
                            coef, lrs, prev, slot):
    """ONE ring event with closed-form gradients gⱼ = a ⊙ (ring[tsⱼ] − w*),
    combine mode, in place — the plain version of
    ``kernels.replay_ring.ring_apply_whatif``.

    Keeps the reference's expression order (``t = r − w*; g = a·t;
    acc = acc + coef·g``, slot order 0…c−1) and streams D in
    ``WHATIF_CHUNK`` columns, so the (c, D) pulled-weight and gradient
    matrices never exist — the memory property that makes what-if replay
    feasible at big-model D.  Columns are independent, so streaming
    changes no value; each chunk reads its pulled rows before writing its
    slot columns, so ``slot ∈ ts`` is safe."""
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no flat event path")
    D = ring.shape[1]
    for lo in range(0, D, WHATIF_CHUNK):
        hi = min(lo + WHATIF_CHUNK, D)
        sub = ring[:, lo:hi]
        a_c, ws_c = a[lo:hi], wstar[lo:hi]
        acc = torch.zeros(hi - lo, dtype=torch.float32, device=ring.device)
        for j in range(ts.shape[0]):
            t = _row(sub, ts[j]) - ws_c
            acc = acc + coef[j] * (a_c * t)
        w = _row(sub, prev)
        if res is not None:
            w = w + res[lo:hi]
        w, s2 = update_event(spec, w, None if s is None else s[lo:hi], acc,
                             lrs[0])
        _write_back(ring, s, res, w, s2, slot, lo, hi)
    return ring, s, res
