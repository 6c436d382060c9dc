"""Cell ``fig8`` of the port (counterpart of
``repro/experiments/cells/fig8_speedup.py``, ported as written) — paper
Fig. 8: training-time speed-up vs λ for hardsync / 1-softsync / λ-softsync
at μ = 128 and μ = 4 (calibrated runtime model).

Pure analytic cell: no simulator runs, just the calibrated cost model, so
``compute`` is deterministic in its params (``device`` is accepted and
unused).
"""

from __future__ import annotations

from repro_torch.experiments.registry import Cell, Claim, emit, register_cell

LAMS = (1, 2, 4, 10, 18, 30)


def compute(device=None, **params):
    from repro_torch.core import tradeoff as to

    hw = to.calibrate_to_baseline()
    out = {}
    for mu in (128, 4):
        base = to.training_time("base", "hardsync", mu, 1, hw)
        for proto, label in [("hardsync", "hardsync"),
                             ("softsync", "softsync1")]:
            for lam in LAMS:
                t = to.training_time("base", proto, mu, lam, hw)
                out[f"mu={mu}/{label}/lam={lam}"] = base / t
        # λ-softsync: the PS applies one update per gradient (λ× more
        # updates than 1-softsync) and each weight update stalls concurrent
        # pullWeights requests — the paper's μ=4/λ=30 runtime penalty.
        for lam in LAMS:
            wl = to.WorkloadModel()
            t = to.training_time("base", "softsync", mu, lam, hw, wl)
            t_svc = wl.model_bytes / hw.ps_service_bw + 2e-3
            penalty = 1.0 + (lam - 1) * t_svc / to.compute_time(mu, hw)
            out[f"mu={mu}/softsyncL/lam={lam}"] = base / (t * penalty)

    s128_1 = out["mu=128/softsync1/lam=30"]
    s128_h = out["mu=128/hardsync/lam=30"]
    emit("fig8/mu128/softsync1_speedup_30", f"{s128_1:.1f}", "")
    emit("fig8/mu128/softsync_beats_hardsync", s128_1 > s128_h,
         f"{s128_1:.1f}x vs {s128_h:.1f}x")
    s4_1 = out["mu=4/softsync1/lam=30"]
    s4_L = out["mu=4/softsyncL/lam=30"]
    emit("fig8/mu4/lambda_softsync_subdued", s4_L < s4_1,
         f"1-soft {s4_1:.1f}x vs L-soft {s4_L:.1f}x")
    return [], out


register_cell(Cell(
    name="fig8", result="fig8_speedup",
    title="Fig. 8: speed-up vs lambda per protocol",
    compute=compute,
    claims=(
        Claim("softsync_beats_hardsync",
              lambda d: (d["mu=128/softsync1/lam=30"]
                         > d["mu=128/hardsync/lam=30"])),
        Claim("lambda_softsync_subdued",
              lambda d: (d["mu=4/softsyncL/lam=30"]
                         < d["mu=4/softsync1/lam=30"])),
    )))
