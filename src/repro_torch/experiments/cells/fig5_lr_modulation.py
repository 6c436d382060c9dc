"""Cell ``fig5`` of the port (counterpart of
``repro/experiments/cells/fig5_lr_modulation.py``, ported as written) —
paper Fig. 5: α₀/⟨σ⟩ modulation rescues convergence for n-softsync; the
unmodulated rate diverges at high staleness.  Also measures footnote 3's
per-gradient α₀/σ_g modulation (suggested, never evaluated in the paper).
base_lr is intentionally aggressive — divergence of the ``const`` policy
is the point.

On the card every replayed event is one ``ring_apply`` launch; the
``per_gradient`` policy takes the sequential path (its per-slot LRs do not
batch) and runs final-only.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import Cell, Claim, emit, register_cell
from repro_torch.experiments.spec import ExperimentSpec

_LAM, _MU = 30, 32
_POLICIES = ("const", "staleness_inverse", "per_gradient")


def specs(epochs: int = 12, base_lr: float = 2.0):
    out = []
    for n in [4, _LAM]:
        for policy in _POLICIES:
            spec = ExperimentSpec(
                run=RunConfig(protocol="softsync", n_softsync=n,
                              n_learners=_LAM, minibatch=_MU,
                              base_lr=base_lr, lr_policy=policy,
                              optimizer="sgd", seed=5),
                problem="mlp_teacher", epochs=epochs, tag=f"n={n}/{policy}")
            # error-vs-updates curve at ~10 points (per_gradient runs
            # final-only, matching the paper's footnote-3 spot check).
            # eval_every must divide steps, else the trailing remainder
            # segment loses the final curve point — pick the nearest
            # divisor.
            if policy != "per_gradient":
                steps = spec.resolved_steps()
                target = max(1, steps // 10)
                eval_every = min((d for d in range(1, steps + 1)
                                  if steps % d == 0),
                                 key=lambda d: abs(d - target))
                spec = spec.replace(eval_every=eval_every)
            out.append(spec)
    return out


def derive(results, params, device=None):
    """Records → final errors and curves (pure in the records)."""
    out = {}
    for res in results:
        final = res.metrics["test_error"]
        out[res.tag] = {
            "final_test_error": final,
            "trace": res.curve,
            "mean_staleness": res.staleness["mean"],
        }
        emit(f"fig5/{res.tag}/test_error",
             f"{final:.4f}" if np.isfinite(final) else "diverged", "")
    for n in [4, _LAM]:
        e_mod = out[f"n={n}/staleness_inverse"]["final_test_error"]
        e_const = out[f"n={n}/const"]["final_test_error"]
        better = (not np.isfinite(e_const)) or e_mod <= e_const + 1e-6
        emit(f"fig5/n={n}/modulation_helps", better,
             f"alpha0/n:{e_mod:.3f} vs alpha0:{e_const:.3f}")
        e_pg = out[f"n={n}/per_gradient"]["final_test_error"]
        emit(f"fig5fn3/n={n}/per_gradient_vs_mean", f"{e_pg:.4f}",
             f"mean-mod:{e_mod:.4f} "
             f"{'BETTER' if e_pg < e_mod else 'comparable/worse'}")
    return out


def _modulation_helps(d, n):
    e_mod = d[f"n={n}/staleness_inverse"]["final_test_error"]
    e_const = d[f"n={n}/const"]["final_test_error"]
    return (not np.isfinite(e_const)) or e_mod <= e_const + 1e-6


register_cell(Cell(
    name="fig5", result="fig5_lr_modulation",
    title="Fig. 5: staleness-modulated LR rescues n-softsync",
    specs=specs, derive=derive,
    claims=tuple(Claim(f"modulation_helps_n{n}",
                       lambda d, n=n: _modulation_helps(d, n))
                 for n in (4, _LAM)),
    params={"epochs": 12, "base_lr": 2.0}, quick_params={"epochs": 3}))
