"""Parameter-server update kernel: one launch per host-PS update (CUDA, Hopper).

Counterpart of ``repro/kernels/ps_update.py``, whose Pallas TPU kernel
(``ps_apply``: ``_stateless_kernel`` for sgd, ``_stateful_kernel`` for
momentum / adagrad) becomes hand-written CUDA C++ in ``csrc/ps_update.cu``,
built by ``kernels/build.py`` and bound with ``ctypes``.  The PS receives c
gradients and applies the unified staleness-aware update in one pass over
the whole flattened model:

* ``combine``    — ĝ = Σᵢ coefᵢ·Gᵢ (slot order 0…c−1), then ONE optimizer
  event at lrs[0];
* ``sequential`` — c optimizer events, event i applying coefᵢ·Gᵢ at lrᵢ.

The update math and its schedule are ``csrc/update_event.cuh``, the
header the replay-ring kernels include too.  The reference's ``(R, 128)``
tiling and padding served the TPU's layout only: here the buffers have
width D and the kernel masks the ragged edge.

``ps_apply`` writes **new** w (and s) and never its inputs, as the
reference's ``pallas_call`` makes new arrays: the host PS hands its weights
to learners as their pulled snapshot, and an in-place write would move
every stale snapshot to the current weights.

The wrapper checks device, dtype, shape and contiguity, then launches the
kernel on a CUDA tensor — or, for a CPU tensor, runs the plain PyTorch
version (``optim.backends.apply_event_flat``) that the kernel is held
against.  Nothing falls back: a CUDA call launches or raises.
``launches["ps_apply"]`` counts kernel launches (plain-version calls do
not count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.optim import backends, flatten
from repro_torch.optim.spec import UpdateSpec

# kernel launches since the last reset_launches()
launches = obs.counter_group("launch", ("ps_apply",))

# coef and lrs are staged in the kernel's shared memory: the largest c
MAX_SLOTS = build.MAX_SLOTS


def reset_launches() -> None:
    launches["ps_apply"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel with its C signature declared (ctypes would
    otherwise pass pointers as 32-bit ints)."""
    lib = build.load("ps_update")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ps_apply.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i, i,
                             i, f, f, i, p]
    lib.ps_apply.restype = i
    build.check_max_slots(lib, "ps_update")
    return lib


def ps_apply(w: torch.Tensor, s: Optional[torch.Tensor], g: torch.Tensor,
             coef: torch.Tensor, lrs: torch.Tensor, *, spec: UpdateSpec,
             mode: str = "combine"
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fused applyUpdate.  ``w``/``s`` (D,) fp32 (``s`` None for sgd);
    ``g`` (c, D) fp32; ``coef``/``lrs`` (c,) fp32, all on one device.
    Returns new ``(w', s')``; the inputs are left as they were."""
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no kernel path")
    if mode not in ("combine", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    if (s is None) != (spec.optimizer == "sgd"):
        raise ValueError(f"{spec.optimizer} needs "
                         f"{'no' if s is None else 'a'} state vector")
    if w.dim() != 1 or g.dim() != 2:
        raise ValueError(f"w must be (D,) and g (c, D), got "
                         f"{tuple(w.shape)} and {tuple(g.shape)}")
    (D,), c, dev = w.shape, g.shape[0], w.device
    build.check_slots(c)
    for name, t, shape in (("w", w, (D,)), ("s", s, (D,)), ("g", g, (c, D)),
                           ("coef", coef, (c,)), ("lrs", lrs, (c,))):
        build.check_operand(name, t, shape, torch.float32, dev)
    if dev.type == "cpu":
        return backends.apply_event_flat(spec, w, s, g, coef, lrs, mode)
    if dev.type != "cuda":
        raise ValueError(f"ps_apply runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev.type}")
    lib = _library()
    w_out = torch.empty_like(w)
    s_out = None if s is None else torch.empty_like(s)
    err = lib.ps_apply(
        w.data_ptr(), build.ptr(s), g.data_ptr(), coef.data_ptr(),
        lrs.data_ptr(), w_out.data_ptr(), build.ptr(s_out), D, c,
        build.OPT_CODES[spec.optimizer], int(mode == "sequential"),
        spec.momentum, spec.eps, build.vec4(D, w, s, g, w_out, s_out),
        torch.cuda.current_stream().cuda_stream)
    build.raise_on(lib, "ps_update", err, "ps_apply")
    launches["ps_apply"] += 1
    return w_out, s_out


# ---------------------------------------------------------------------------
# the seed API's wrappers: momentum, combine mode
# ---------------------------------------------------------------------------
def ps_update_flat(w_flat: torch.Tensor, v_flat: torch.Tensor,
                   g_flat: torch.Tensor, coef, *, momentum: float = 0.9,
                   lr: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Momentum combine-mode entry.  w/v: (D,); g: (c, D); coef: (c,)."""
    c = g_flat.shape[0]
    spec = UpdateSpec(optimizer="momentum", momentum=momentum)
    dev = w_flat.device
    lrs = torch.full((c,), lr, dtype=torch.float32, device=dev)
    return ps_apply(w_flat, v_flat, g_flat,
                    torch.as_tensor(coef, dtype=torch.float32, device=dev),
                    lrs, spec=spec, mode="combine")


def ps_update_tree(params, velocity, grads_list, coef, *,
                   momentum: float = 0.9, lr: float = 1.0):
    """Tree convenience wrapper: ONE kernel launch over the whole
    concatenated model (``optim.flatten``), not a per-leaf loop."""
    p_layout = flatten.layout_of(params)
    v_layout = flatten.layout_of(velocity)
    w2, v2 = ps_update_flat(flatten.tree_to_flat(params),
                            flatten.tree_to_flat(velocity),
                            flatten.stack_grads_flat(grads_list), coef,
                            momentum=momentum, lr=lr)
    return (flatten.flat_to_tree(w2, p_layout),
            flatten.flat_to_tree(v2, v_layout))
