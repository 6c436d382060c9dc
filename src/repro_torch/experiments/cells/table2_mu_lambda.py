"""Cell ``table2`` of the port (counterpart of
``repro/experiments/cells/table2_mu_lambda.py``, ported as written) —
paper Table 2 / §5.3: μλ = constant ⇒ ≈ constant test error, largely
independent of staleness σ; error grows monotonically with the μλ
product.  Configurations mirror the paper's table scaled to the teacher
task (groups μλ ≈ {128, 512, 4096} with σ ∈ {1, λ}).  On the card every
replayed event is one ``ring_apply`` launch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import Cell, Claim, emit, register_cell
from repro_torch.experiments.spec import ExperimentSpec

_GROUPS = {
    128: [(1, 4, 32), (32, 4, 32), (8, 16, 8), (1, 128, 1)],
    512: [(1, 16, 32), (32, 16, 32), (8, 64, 8), (1, 128, 4)],
    4096: [(1, 128, 32), (32, 128, 32), (8, 256, 16)],
}


def _slots():
    return [(prod, n, mu, lam)
            for prod, cfgs in _GROUPS.items() for (n, mu, lam) in cfgs]


def specs(epochs: int = 10, base_lr: float = 0.35):
    out = []
    for prod, n, mu, lam in _slots():
        out.append(ExperimentSpec(
            run=RunConfig(protocol="softsync", n_softsync=n, n_learners=lam,
                          minibatch=mu, base_lr=base_lr,
                          lr_policy="staleness_inverse", optimizer="sgd",
                          seed=9),
            problem="mlp_teacher", epochs=epochs,
            tag=f"prod={prod}/n={n}/mu={mu}/lam={lam}"))
    return out


def derive(results, params, device=None):
    """Records → errors per μλ group (pure in the records)."""
    out = {}
    errs_by_prod = {prod: [] for prod in _GROUPS}
    for (prod, n, mu, lam), res in zip(_slots(), results):
        err, sig = res.metrics["test_error"], res.staleness["mean"]
        out[res.tag] = {"test_error": err, "measured_staleness": sig}
        errs_by_prod[prod].append(err)
        emit(f"table2/prod={prod}/sigma={n}/mu={mu}/lam={lam}",
             f"{err:.4f}", f"<sigma>={sig:.1f}")
    for prod, errs in errs_by_prod.items():
        spread = float(np.max(errs) - np.min(errs))
        out[f"prod={prod}/spread"] = spread
        emit(f"table2/prod={prod}/error_spread", f"{spread:.4f}",
             "claim:small-within-group")
    out["mean_error_by_prod"] = {str(prod): float(np.mean(errs))
                                 for prod, errs in errs_by_prod.items()}
    mean_small = out["mean_error_by_prod"]["128"]
    mean_big = out["mean_error_by_prod"]["4096"]
    emit("table2/error_grows_with_product", mean_big > mean_small,
         f"128:{mean_small:.3f} 4096:{mean_big:.3f}")
    return out


register_cell(Cell(
    name="table2", result="table2_mu_lambda",
    title="Table 2: mu*lambda = const => const error",
    specs=specs, derive=derive,
    claims=(
        Claim("error_grows_with_product",
              lambda d: (d["mean_error_by_prod"]["4096"]
                         > d["mean_error_by_prod"]["128"])),
    ),
    params={"epochs": 10, "base_lr": 0.35}, quick_params={"epochs": 3}))
