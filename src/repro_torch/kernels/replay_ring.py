"""Replay-ring update kernels: one launch per update event (CUDA, Hopper).

Counterpart of ``repro/kernels/replay_ring.py``, whose two Pallas TPU
megakernels (``ring_apply`` and ``ring_apply_whatif``) become hand-written
CUDA C++ in ``csrc/replay_ring.cu``, built by ``kernels/build.py`` and
bound with ``ctypes``.  One event:

    ring-read(prev row) → [+ error-feedback residue] → combine / sequential
    optimizer event → quantize → ring-write(slot row) [+ residue write]

On this card ``ring_apply`` is memory-bound (a few fp32 operations per
byte moved) and ``ring_apply_whatif`` bound by its slot-order sum (a
multiply and an add per slot and element).  ``ring_apply`` runs
``csrc/update_event.cuh``'s schedule, shared with ``ps_apply``.  It also
takes B lanes at once — a (B, K, D) ring, one launch per ``replay_batch``
event, the counterpart of the reference's ``jax.vmap`` of its
``pallas_call``.  The what-if kernel reads each distinct pulled row once
and forms its gⱼ once (up to :data:`WHATIF_ROWS` distinct rows, held in
registers; an event with more takes a per-slot variant in the same
launch); the source's header says why.  The reference's ``(rows, 128)``
tiling and ``padded_width`` served the TPU's layout only: here the ring
has width D and the kernels mask the ragged edge.

Each wrapper checks device, dtype, shape and contiguity, then launches the
kernel on a CUDA tensor — or, for a CPU tensor, runs the plain PyTorch
version (``optim/backends.py``) that the kernel is held against.  Nothing
falls back: a CUDA call launches or raises.  ``launches`` counts kernel
launches per wrapper (plain-version calls do not count), so a run can show
that its events really went through the kernels; ``lane_events`` counts
the lane events ``ring_apply``'s launches applied (B per lane-axis
launch); ``whatif_path`` counts ``ring_apply_whatif``'s launches by the
variant the kernel itself chose, once :func:`collect_whatif_path` has read
the kernel's device tally.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.optim import backends
from repro_torch.optim.spec import UpdateSpec

# kernel launches per wrapper since the last reset_launches(), those of the
# ranks an SPMD replay spawned from this process included
launches = obs.counter_group("launch", ("ring_apply", "ring_apply_whatif"))
# the lane events ring_apply's launches applied (one per launch and lane: B
# for a replay_batch event)
lane_events = obs.counter_group("lane_events", ("ring_apply",))
# per rank, the launches of the last SPMD replay this process spawned
rank_launches = []
# ring_apply_whatif's launches by the variant the kernel chose: ``walk``
# (at most WHATIF_ROWS distinct pulled rows, held in registers) or
# ``slots`` (more).  Block 0 of each launch adds 1 to a device tally;
# collect_whatif_path() adds the tallies in here.
whatif_path = obs.counter_group("whatif_path", ("walk", "slots"))
# device index -> its (2,) int32 tally [walk, slots]
_path_tallies: Dict[int, torch.Tensor] = {}

_RING_DTYPES = (torch.float32, torch.bfloat16)
# distinct pulled rows the what-if kernel holds in registers
# (csrc/replay_ring.cu: WHATIF_ROWS)
WHATIF_ROWS = 4
# coef and lrs are staged in ring_apply's shared memory: the largest c
MAX_SLOTS = build.MAX_SLOTS

Ring3 = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def reset_launches() -> None:
    for counter in (launches, lane_events, whatif_path):
        for name in counter:
            counter[name] = 0
    for tally in _path_tallies.values():
        tally.zero_()


def _path_tally(device: torch.device) -> torch.Tensor:
    tally = _path_tallies.get(device.index)
    if tally is None:
        tally = torch.zeros(2, dtype=torch.int32, device=device)
        _path_tallies[device.index] = tally
    return tally


def collect_whatif_path() -> None:
    """Add the kernel's device tallies into ``whatif_path`` and zero them.
    Reading a tally waits for the launches queued before it."""
    for tally in _path_tallies.values():
        walk, slots = tally.tolist()
        if walk or slots:
            whatif_path["walk"] += walk
            whatif_path["slots"] += slots
            tally.zero_()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (ctypes would
    otherwise pass pointers as 32-bit ints)."""
    lib = build.load("replay_ring")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ring_apply.argtypes = [p, i, p, p, p, p, p, p, ctypes.c_longlong,
                               i, i, i, i, i, i, f, f, i, p]
    lib.ring_apply.restype = i
    lib.ring_apply_whatif.argtypes = [p, i, p, p, p, p, p, p, p,
                                      ctypes.c_longlong, i, i, f, f, i, p, p]
    lib.ring_apply_whatif.restype = i
    lib.ring_apply_whatif_rows.restype = i
    if lib.ring_apply_whatif_rows() != WHATIF_ROWS:
        raise RuntimeError(f"ring_apply_whatif_rows() = "
                           f"{lib.ring_apply_whatif_rows()}, expected "
                           f"{WHATIF_ROWS}")
    build.check_max_slots(lib, "ring_apply")
    return lib


def _check_event(spec: UpdateSpec, ring, s, res, c: int, coef, lrs, idx,
                 n_idx: int, lead=(), coef_lanes: bool = False) -> None:
    """``lead``: the lane axis, () or (B,), of ring, s, res and lrs (and of
    coef when ``coef_lanes``)."""
    if not spec.kernel_supported:
        raise ValueError(f"{spec.optimizer!r} has no kernel path")
    if ring.dim() != 2 + len(lead) or ring.dtype not in _RING_DTYPES:
        raise ValueError(f"ring must be (K, D) fp32 or bf16, got "
                         f"{tuple(ring.shape)} {ring.dtype}")
    if not ring.is_contiguous():
        raise ValueError("ring must be contiguous")
    if (s is None) != (spec.optimizer == "sgd"):
        raise ValueError(f"{spec.optimizer} needs "
                         f"{'no' if s is None else 'a'} state vector")
    D, dev = ring.shape[-1], ring.device
    build.check_operand("s", s, lead + (D,), torch.float32, dev)
    build.check_operand("res", res, lead + (D,), torch.float32, dev)
    build.check_operand("coef", coef, (lead if coef_lanes else ()) + (c,),
                        torch.float32, dev)
    build.check_operand("lrs", lrs, lead + (c,), torch.float32, dev)
    build.check_operand("idx", idx, (n_idx,), torch.int32, dev)


def ring_apply(ring: torch.Tensor, s: Optional[torch.Tensor],
               res: Optional[torch.Tensor], g: torch.Tensor,
               coef: torch.Tensor, lrs: torch.Tensor, idx: torch.Tensor, *,
               spec: UpdateSpec, mode: str = "combine") -> Ring3:
    """ONE ring event with staged gradients, in place: read row ``idx[0]``,
    apply the c-gradient update, write row ``idx[1]`` — of one ring, or of
    each of B lanes in one launch.

    One ring: ``ring`` (K, D) fp32 or bf16; ``s`` (D,) fp32 state or None
    (sgd); ``res`` (D,) fp32 residue or None; ``g`` (c, D) fp32;
    ``coef``/``lrs`` (c,) fp32.  B lanes (``replay_batch``'s, the
    counterpart of the reference's ``jax.vmap`` over this event): ``ring``
    (B, K, D), ``s``/``res`` (B, D), ``g`` (B, c, D), ``coef`` (c,) shared
    or (B, c) (elastic masks), ``lrs`` (B, c).  ``idx`` (2,) int32
    [prev, slot] on the ring's device, shared by every lane.  c is at most
    :data:`MAX_SLOTS`.  Returns ``(ring, s, res)``, updated in place."""
    if mode not in ("combine", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    if ring.dim() not in (2, 3):
        raise ValueError(f"ring must be (K, D) or (B, K, D), got "
                         f"{tuple(ring.shape)}")
    lead = tuple(ring.shape[:-2])               # () or (B,)
    c = g.shape[-2] if g.dim() == len(lead) + 2 else -1
    build.check_slots(c)
    K, D, dev = ring.shape[-2], ring.shape[-1], ring.device
    _check_event(spec, ring, s, res, c, coef, lrs, idx, 2, lead,
                 coef_lanes=coef.dim() == 2)
    build.check_operand("g", g, lead + (c, D), torch.float32, dev)
    if dev.type == "cpu":
        if lead:
            return backends.apply_event_ring_lanes(
                spec, ring, s, res, g, coef, lrs, idx[0], idx[1], mode)
        return backends.apply_event_ring(spec, ring, s, res, g, coef, lrs,
                                         idx[0], idx[1], mode)
    if dev.type != "cuda":
        raise ValueError(f"ring_apply runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev.type}")
    lib = _library()
    B = lead[0] if lead else 1
    err = lib.ring_apply(
        ring.data_ptr(), int(ring.dtype == torch.bfloat16), build.ptr(s),
        build.ptr(res), g.data_ptr(), coef.data_ptr(), lrs.data_ptr(),
        idx.data_ptr(), D, K, B, c, c if coef.dim() == 2 else 0,
        build.OPT_CODES[spec.optimizer], int(mode == "sequential"),
        spec.momentum, spec.eps, build.vec4(D, ring, s, res, g),
        torch.cuda.current_stream().cuda_stream)
    build.raise_on(lib, "replay_ring", err, "ring_apply")
    launches["ring_apply"] += 1
    lane_events["ring_apply"] += B
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
        _path_tally(ring.device).data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.raise_on(lib, "replay_ring", err, "ring_apply_whatif")
    launches["ring_apply_whatif"] += 1
    return ring, s, res
