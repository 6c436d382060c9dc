"""Byte model of the replay engine's device-resident carry (counterpart of
``ring_bytes`` in ``repro/launch/roofline.py``, ported as written).

The rest of the reference's module — parsing collectives out of HLO text
and the per-chip roofline ``analyse`` with TPU constants — waits for
ROADMAP.md item 10, which needs H100 constants in their place.
"""

from __future__ import annotations

from typing import Dict

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
