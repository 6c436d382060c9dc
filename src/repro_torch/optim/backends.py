"""The unified applyUpdate of the port: the pytree backends, the flat
kernel backend, and the flat-buffer events the CUDA kernels are held
against (counterpart of ``repro/optim/backends.py``).

Three interchangeable backends for :func:`apply_update`, the reference's
names:

* ``reference`` — eager PyTorch, leaf by leaf.  The oracle.
* ``jit``       — the same eager pytree function (the port compiles
  nothing: PyTorch runs eagerly, and no ``torch.compile`` stands in for
  ``jax.jit``).
* ``pallas``    — every leaf concatenated into one flat fp32 buffer and
  the whole model updated by ONE ``kernels.ps_update.ps_apply`` launch
  (the CUDA kernel on a card, its plain version :func:`apply_event_flat`
  on the CPU).  The host PS hot path.

All of them execute :func:`repro_torch.optim.spec.update_event`, with two
deliberate differences from the reference's jnp code:

* The combine ĝ = Σⱼ coefⱼ·gⱼ is an explicit loop in slot order 0…c−1
  (``acc = acc + coef[j]·g[j]``), not an ``einsum``: the CUDA kernels
  accumulate in exactly that order, so kernel ≡ plain version bitwise on
  the card.  Against the reference's ``einsum`` on the CPU the order
  differs, so the two agree within a few ulp (the tolerances are stated
  in ``tests/test_torch_optim.py`` and ``tests/test_torch_legacy.py``).
* Ring events update ``ring``, ``s`` and ``res`` **in place** (as the
  ring kernels do) and return them, so a (K, D) ring is never copied per
  event.  Everything else makes new tensors, as the reference does: the
  host PS hands its weights to learners, which must keep the stale copy.

``prev``/``slot``/``ts`` are int32 or int64 index tensors on the ring's
device, read without a host sync.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.optim import flatten
from repro_torch.optim.flatten import tree_map
from repro_torch.optim.spec import RoundFold, UpdateSpec, update_event

BACKENDS = ("reference", "jit", "pallas")

# host-side count of flat-kernel dispatches of apply_update (tests and
# chip_smoke.py assert the kernel path really is the one exercised)
pallas_dispatches = 0

RING_IMPLS = ("auto", "pallas", "fused", "stock")

# columns per pass of the streamed what-if plain version: bounds its
# temporaries to a few × 64 MB whatever D is
WHATIF_CHUNK = 1 << 24


def combine(g, coef: torch.Tensor) -> torch.Tensor:
    """ĝ = Σⱼ coefⱼ·gⱼ over the c fp32 rows of ``g`` (a (c, D) tensor or a
    sequence of c equal-shaped tensors), in slot order 0…c−1."""
    acc = torch.zeros(g[0].shape, dtype=torch.float32, device=g[0].device)
    for j in range(len(g)):
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


def apply_event_sharded(spec: UpdateSpec, w, s, g, coef, lrs,
                        mode: str = "combine"):
    """:func:`apply_event_flat` over a leading shard axis: the stock
    sharded replay's event.  ``w``/``s`` (S, Dp) (``s`` None for sgd),
    ``g`` (S, c, Dp), ``coef``/``lrs`` (c,) shared by every shard (the
    shards fold the same c pushes; only the pulled slices differ).  The
    event is elementwise, so each shard's rows are exactly the shard slice
    of the unsharded event — the same operations in the same order, one
    call over all S rows at once.  Returns ``(w', s')`` as new tensors."""
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no flat event path")
    return apply_event_flat(spec, w, s, g.to(torch.float32).movedim(1, 0),
                            coef, lrs, mode)


def _f32(tree):
    return tree_map(lambda x: x.to(torch.float32), tree)


def _combine(grads: Sequence, coef):
    """Σᵢ coefᵢ·Gᵢ in fp32 over c gradient trees, leaf by leaf, in slot
    order 0…c−1 — the staleness-weighted sumGradients."""
    return tree_map(
        lambda *g: combine([x.to(torch.float32) for x in g], coef), *grads)


# ---------------------------------------------------------------------------
# pytree event application (reference + jit backends)
# ---------------------------------------------------------------------------
def _adamw_event(spec: UpdateSpec, params, state, g32, lr):
    b1, b2, eps = spec.beta1, spec.beta2, spec.eps
    cnt = state["count"] + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], g32)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g),
                  state["nu"], g32)
    c1 = 1 - b1 ** cnt.to(torch.float32)
    c2 = 1 - b2 ** cnt.to(torch.float32)

    def step(p, m, n):
        p32 = p.to(torch.float32)
        return (p32 - lr * ((m / c1) / (torch.sqrt(n / c2) + eps)
                            + spec.weight_decay * p32)).to(p.dtype)
    return tree_map(step, params, mu, nu), {"mu": mu, "nu": nu, "count": cnt}


def _unzip(tree):
    """A tree whose leaves are (a, b) pairs → (tree of a, tree of b)."""
    if isinstance(tree, dict):
        pairs = {k: _unzip(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return tree


def apply_single(spec: UpdateSpec, params, state, grad, lr):
    """ONE optimizer event with gradient tree ``grad`` and lr ``lr`` (a
    float or a 0-dim fp32 tensor).  Returns new ``(params, state)``;
    ``params`` may be nested dicts (a model's tree).  The update runs in
    fp32 and rounds back to each leaf's dtype (bf16 leaves train with
    fp32 state); gradients go to fp32 one leaf at a time, so a bf16
    model's gradients are never all held in fp32 at once."""
    f32 = torch.float32
    if spec.optimizer == "adamw":
        return _adamw_event(spec, params, state, _f32(grad), lr)
    if spec.optimizer == "sgd":
        return tree_map(
            lambda p, g: update_event(spec, p.to(f32), None, g.to(f32),
                                      lr)[0].to(p.dtype),
            params, grad), state
    key = spec.state_keys[0]

    def event(p, s, g):
        w, s2 = update_event(spec, p.to(f32), s.to(f32), g.to(f32), lr)
        return w.to(p.dtype), s2.to(s.dtype)
    new_p, new_s = _unzip(tree_map(event, params, state[key], grad))
    return new_p, {key: new_s}


def apply_round_folded(spec: UpdateSpec, params, state, ghat,
                       fold: RoundFold):
    """Apply a whole round of c sequential momentum events in one shot,
    given only their weighted-mean gradient ``ghat`` (the fused engine's
    single backward pass): θ gets the exact affine fold, including the
    ``v0_coef`` carry from the incoming velocity, and v advances by
    (v_decay, v_gain)."""
    if spec.optimizer != "momentum":
        raise ValueError("apply_round_folded is momentum-only; other "
                         "optimizers use apply_single with the folded lr")
    total = float(np.sum(fold.theta_coef))
    f32 = torch.float32

    def event(p, g, v):
        g = g.to(f32)
        return ((p.to(f32) - total * g - fold.v0_coef * v).to(p.dtype),
                fold.v_decay * v + fold.v_gain * g)
    new_p, new_v = _unzip(tree_map(event, params, ghat, state["velocity"]))
    return new_p, {"velocity": new_v}


def apply_update_tree(spec: UpdateSpec, params, state, grads: Sequence,
                      coef, lrs, mode: str = "combine"):
    """The unified update on trees (the reference semantics).

    ``grads`` is a sequence of c gradient trees; ``coef``/``lrs`` are (c,)
    fp32 tensors (combination weights, per-event LRs)."""
    if mode == "combine":
        return apply_single(spec, params, state, _combine(grads, coef),
                            lrs[0])
    if mode != "sequential":
        raise ValueError(f"unknown mode {mode!r}")
    for i, gi in enumerate(grads):
        gi = tree_map(lambda g: coef[i] * g.to(torch.float32), gi)
        params, state = apply_single(spec, params, state, gi, lrs[i])
    return params, state


def apply_update_flat(spec: UpdateSpec, params, state, grads: Sequence,
                      coef, lrs, mode: str = "combine"):
    """Flatten → ONE ``ps_apply`` launch over the whole model → unflatten.
    The returned trees are views of the kernel's fresh output buffers."""
    from repro_torch.kernels import ps_update   # lazy: breaks import cycle

    p_layout = flatten.layout_of(params)
    w = flatten.tree_to_flat(params)
    g = flatten.stack_grads_flat(grads)
    if spec.optimizer == "sgd":
        w2, _ = ps_update.ps_apply(w, None, g, coef, lrs, spec=spec,
                                   mode=mode)
        return flatten.flat_to_tree(w2, p_layout), state
    key = spec.state_keys[0]
    s_layout = flatten.layout_of(state[key])
    s = flatten.tree_to_flat(state[key])
    w2, s2 = ps_update.ps_apply(w, s, g, coef, lrs, spec=spec, mode=mode)
    return (flatten.flat_to_tree(w2, p_layout),
            {key: flatten.flat_to_tree(s2, s_layout)})


def apply_update(spec: UpdateSpec, params, state, grads: Sequence,
                 coef, lrs, *, mode: str = "combine", backend: str = "jit"):
    """The one entry point every consumer routes through.

    ``grads``: sequence of c gradient trees.  ``coef``: (c,) combination
    weights.  ``lrs``: (c,) per-event LRs (``combine`` mode reads
    lrs[0]).  Both may be sequences or tensors; they go to the parameters'
    device as fp32, one transfer each.  adamw has no flat path: the
    ``pallas`` backend takes the pytree path for it, as in the
    reference."""
    global pallas_dispatches
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    grads = tuple(grads)
    dev = flatten.tree_device(params)
    coef = torch.as_tensor(coef, dtype=torch.float32, device=dev)
    lrs = torch.as_tensor(lrs, dtype=torch.float32, device=dev)
    if backend == "pallas" and spec.kernel_supported:
        pallas_dispatches += 1
        return apply_update_flat(spec, params, state, grads, coef, lrs,
                                 mode)
    return apply_update_tree(spec, params, state, grads, coef, lrs, mode)


def sgd_step(params, grad, lr):
    """Convenience plain-SGD event (baseline simulators)."""
    return apply_single(UpdateSpec(optimizer="sgd"), params, {}, grad, lr)[0]


def resolve_ring_impl(impl: str, spec: UpdateSpec) -> str:
    """Resolve a RunConfig's ``ring_impl`` to a replay body.

    ``auto`` and ``pallas`` (the reference's name for its TPU megakernel)
    resolve to ``"kernel"``: the ``kernels/replay_ring`` wrappers, which
    launch the CUDA kernels on CUDA tensors and run these plain versions
    on CPU tensors.  ``fused`` calls the plain versions directly on any
    device.  ``stock`` is the gather → :func:`apply_event_flat` → row-write
    chain, and optimizers without a flat event path (adamw) resolve to it
    (its pytree body: :func:`apply_update_tree`)."""
    if impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {impl!r}: expected one of "
                         f"{RING_IMPLS}")
    if not spec.kernel_supported:
        return "stock"
    if impl in ("auto", "pallas"):
        return "kernel"
    return impl


# ---------------------------------------------------------------------------
# SPMD replay collectives (DESIGN.md §13)
# ---------------------------------------------------------------------------
# ``mesh`` is a ``launch.mesh.SimMesh``.  gloo carries the collectives on
# host tensors (on the card every rank shares one device, and NCCL will not
# run two ranks on one device), so each helper stages its operand through
# the host and returns a tensor on the operand's device.
def all_gather(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``dist.all_gather`` over the mesh axis: the (size, *x.shape) stack
    of every rank's ``x`` in axis-index order."""
    import torch.distributed as dist
    size = mesh.axis_size(axis_name)
    if size == 1:
        return x[None]
    h = x.contiguous().cpu()
    out = [torch.empty_like(h) for _ in range(size)]
    dist.all_gather(out, h, group=mesh.group(axis_name))
    return torch.stack(out).to(x.device)


def ring_all_gather(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """:func:`all_gather` rebuilt from size − 1 neighbor exchanges
    (``dist.isend`` / ``dist.irecv``) — the parameter-server ring-pull
    pattern, where each PS rank forwards the slice it just received to its
    neighbor.  Pure data movement, so the result is **bitwise** that of
    :func:`all_gather`; it trades one collective for S − 1 dependent hops,
    so the engine uses it only when asked (``spmd_assembly='ppermute'``)."""
    import torch.distributed as dist
    size = mesh.axis_size(axis_name)
    if size == 1:
        return x[None]
    ranks, group = mesh.ranks(axis_name), mesh.group(axis_name)
    i = mesh.axis_index(axis_name)
    cur = x.contiguous().cpu()
    chunks = [cur]
    for _ in range(size - 1):
        got = torch.empty_like(cur)
        reqs = [dist.isend(cur, ranks[(i + 1) % size], group=group),
                dist.irecv(got, ranks[(i - 1) % size], group=group)]
        for r in reqs:
            r.wait()
        chunks.append(got)
        cur = got
    # chunk k on rank i originated at rank (i − k) mod size; reorder so
    # position s holds rank s's slice, as all_gather does
    return torch.stack([chunks[(i - s) % size]
                        for s in range(size)]).to(x.device)


def combine_spmd(g: torch.Tensor, coef: torch.Tensor, mesh,
                 axis_name: str) -> torch.Tensor:
    """The combine ĝ = Σⱼ coefⱼ·gⱼ with the slot axis split over the mesh
    axis: each learner rank folds its local slot block (:func:`combine`,
    slot order), then one ``dist.all_reduce(SUM)`` folds the partials.
    For a single learner rank this is bitwise :func:`combine`; with L > 1
    the partial sums reorder the fp32 reduction (the ~1 ulp/event
    tolerance of DESIGN.md §13)."""
    import torch.distributed as dist
    part = combine(g, coef)
    if mesh.axis_size(axis_name) == 1:
        return part
    h = part.cpu()
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=mesh.group(axis_name))
    return h.to(g.device)


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


def apply_event_ring_lanes(spec: UpdateSpec, ring, s, res, g, coef, lrs,
                           prev, slot, mode: str = "combine"):
    """:func:`apply_event_ring` on each of B lanes at once, in place: the
    plain version of ``kernels.replay_ring.ring_apply``'s lane axis.

    ``ring`` (B, K, D); ``s``/``res`` (B, D) fp32 or None; ``g`` (B, c, D)
    fp32; ``coef`` (c,) shared by every lane or (B, c); ``lrs`` (B, c);
    ``prev``/``slot`` shared.  The event is elementwise, so each lane's
    values are exactly :func:`apply_event_ring`'s on that lane: the same
    operations in the same order, each lane's coefficient and learning
    rate broadcast over its row."""
    B = ring.shape[0]
    w = ring.index_select(1, prev.reshape(1).to(torch.int64))[:, 0] \
        .to(torch.float32)
    if res is not None:
        w = w + res
    coef = coef if coef.dim() == 2 else coef[None].expand(B, -1)
    # slot-major operands, each slot's (B, 1) coefficient and rate
    w, s2 = apply_event_flat(spec, w, s, g.movedim(1, 0),
                             coef.t()[..., None], lrs.t()[..., None], mode)
    q = w.to(ring.dtype)
    ring.index_copy_(1, slot.reshape(1).to(torch.int64), q[:, None])
    if s is not None:
        s.copy_(s2)
    if res is not None:
        res.copy_(w - q.to(torch.float32))
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
