"""Cell ``table1`` of the port (counterpart of
``repro/experiments/cells/table1_overlap.py``, ported as written) — paper
Table 1: communication overlap for Rudra-base / -adv / -adv* in the
adversarial scenario (μ = 4, 300 MB model, ~60 learners).  Paper: base
11.52 %, adv 56.75 %, adv* 99.56 %.

Pure analytic cell over the structural topology model (host floats; no
device work, ``device`` is accepted and unused).
"""

from __future__ import annotations

from repro_torch.experiments.registry import Cell, Claim, emit, register_cell

_PAPER = {"base": 0.1152, "adv": 0.5675, "adv*": 0.9956}


def compute(device=None, **params):
    from repro_torch.core import tradeoff as to

    wl = to.WorkloadModel(model_bytes=300e6)
    out = {}
    for arch in ("base", "adv", "adv*"):
        o = to.communication_overlap(arch, 4, 60, wl=wl)
        out[arch] = {"overlap": o, "paper": _PAPER[arch]}
        emit(f"table1/{arch}/overlap", f"{o:.4f}", f"paper:{_PAPER[arch]}")
    ordered = out["base"]["overlap"] < out["adv"]["overlap"] \
        < out["adv*"]["overlap"]
    emit("table1/ordering_base<adv<adv*", ordered, "")
    emit("table1/adv*_near_full_overlap", out["adv*"]["overlap"] > 0.95, "")
    return [], out


register_cell(Cell(
    name="table1", result="table1_overlap",
    title="Table 1: communication overlap per architecture",
    compute=compute,
    claims=(
        Claim("ordering_base_adv_advstar",
              lambda d: (d["base"]["overlap"] < d["adv"]["overlap"]
                         < d["adv*"]["overlap"])),
        Claim("adv_star_near_full_overlap",
              lambda d: d["adv*"]["overlap"] > 0.95),
    )))
