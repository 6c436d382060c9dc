"""Three-term roofline of a dry-run (counterpart of
``repro/launch/roofline.py``), with H100 constants (``launch/mesh.py``):

    compute term    = FLOPs per device / 989 TFLOP/s (dense bf16)
    memory term     = bytes per device / 3.35 TB/s (HBM3)
    collective term = wire bytes per device / 50 GB/s (inter-node NIC)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and parses
the collectives out of the compiled HLO text.  The port has no HLO: its
dry-run (``launch/dryrun.py``) counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` and reckons the collectives
the sharding policy implies as a list of :class:`Collective` (kind,
operand bytes, group size); :func:`collective_bytes` sums their wire
bytes with the reference's ring factors (:func:`_wire_bytes`).

``ring_bytes`` (the replay engine's device-resident carry) is ported as
written.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a step: its kind, its result's bytes per device
    (the reference's HLO result shape) and its group size."""

    kind: str
    result_bytes: float
    group: int
    count: int = 1             # how many times the step issues it

    def __post_init__(self):
        if self.kind not in _COLLECTIVES:
            raise ValueError(f"unknown collective {self.kind!r}; expected "
                             f"one of {_COLLECTIVES}")


def _wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Per-device wire traffic for a ring implementation.

    all-gather result = gathered tensor; each device sends its (1/g) shard
    (g−1) times ⇒ wire ≈ result·(g−1)/g.
    all-reduce (≡ reduce-scatter + all-gather) ⇒ ≈ 2·result·(g−1)/g.
    reduce-scatter result = the shard; input = result·g ⇒ ≈ result·(g−1).
    all-to-all: each device keeps 1/g, sends the rest ⇒ ≈ result·(g−1)/g.
    collective-permute: one send per device ⇒ result.
    """
    g = max(2, group)
    f = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "collective-permute":
        return float(result_bytes)
    return result_bytes * f


def collective_bytes(collectives: Iterable[Collective]) -> Dict[str, float]:
    """Per-device wire bytes per collective kind, and their ``total``.  A
    collective over a group of one device moves nothing."""
    totals: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for c in collectives:
        if c.group > 1:
            totals[c.kind] += c.count * _wire_bytes(c.kind, c.result_bytes,
                                                    c.group)
    totals["total"] = sum(totals[k] for k in _COLLECTIVES)
    return totals


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    coll_bytes: float           # per device (wire)
    model_flops: float          # 6·N·D (or 6·N_active·D) total, fwd+bwd
    coll_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs per device × chips) — remat/redundancy
        waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
        }


RING_DTYPE_BYTES = {"fp32": 4, "bf16": 2}

# optimizer state slots carried next to the ring (fp32 each): sgd none,
# momentum/adagrad one (velocity / accumulator), adamw two (m, v)
_OPT_STATE_SLOTS = {"sgd": 0, "momentum": 1, "adagrad": 1, "adamw": 2}


def ring_bytes(K: int, D: int, ring_dtype: str = "fp32",
               optimizer: str = "momentum", donated: bool = True) -> Dict:
    """Device-resident bytes of the replay engine's hot-loop carry
    (DESIGN.md §12): the (K, D) weight ring in ``ring_dtype``, the fp32
    optimizer state, and — with a compressed (bf16) ring — the fp32
    error-feedback residue of the latest row.  ``donated=False`` models a
    carry that is double-buffered across dispatches (2× every term).  This
    is the feasibility limit the what-if replay runs against: max feasible
    D ≈ device memory / bytes_per_param.
    """
    per = RING_DTYPE_BYTES.get(ring_dtype)
    if per is None:
        raise ValueError(f"unknown ring_dtype {ring_dtype!r}; expected one "
                         f"of {sorted(RING_DTYPE_BYTES)}")
    slots = _OPT_STATE_SLOTS.get(optimizer, 1)
    ring = K * D * per
    state = slots * D * 4
    residue = D * 4 if ring_dtype == "bf16" else 0
    mult = 1 if donated else 2
    total = (ring + state + residue) * mult
    return {
        "ring_bytes": ring * mult,
        "state_bytes": state * mult,
        "residue_bytes": residue * mult,
        "total_bytes": total,
        "bytes_per_param": total / D if D else 0.0,
    }


def normalize_cost_analysis(cost) -> Dict:
    """A cost record as one flat dict: a per-partition list of dicts is
    summed key by key, a dict is copied, None is empty (the reference's
    normaliser for ``compiled.cost_analysis()``; the port's dry-run hands
    it its own ``{"flops", "bytes accessed"}`` dict)."""
    if cost is None:
        return {}
    if isinstance(cost, (list, tuple)):
        merged: Dict = {}
        for entry in cost:
            for k, v in dict(entry).items():
                merged[k] = merged.get(k, 0.0) + v
        return merged
    return dict(cost)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D for training (fwd+bwd), 2·N·D for inference,
    with N = active params (MoE) and D = tokens processed."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyse(arch: str, shape_name: str, mesh_name: str, chips: int,
            cost: Dict, collectives: Iterable[Collective],
            mf: float) -> Roofline:
    """The roofline of one step: ``cost`` per device (``flops``, ``bytes
    accessed``), the step's collectives, ``mf`` its MODEL_FLOPS."""
    coll = collective_bytes(collectives)
    cost = normalize_cost_analysis(cost)
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=coll["total"],
        model_flops=mf,
        coll_breakdown=coll,
    )
