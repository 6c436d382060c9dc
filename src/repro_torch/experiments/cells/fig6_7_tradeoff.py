"""Cell ``fig6_7`` of the port (counterpart of
``repro/experiments/cells/fig6_7_tradeoff.py``, ported as written) — paper
Figs. 6/7: (σ, μ, λ) tradeoff curves — test error vs training time for
hardsync / 1-softsync / λ-softsync over the (μ, λ) grid.  Error axis from
the replay on the card (one ``ring_apply`` launch per event); time axis
from the calibrated Rudra-base runtime model (``core/tradeoff.py``).
"""

from __future__ import annotations

from repro_torch.config import RunConfig
from repro_torch.experiments.registry import Cell, Claim, emit, register_cell
from repro_torch.experiments.spec import ExperimentSpec

_DEF_MUS = (4, 16, 64, 128)
_DEF_LAMS = (1, 4, 10, 30)


def _grid(mus, lams):
    rows = []
    for proto, nfn in [("hardsync", lambda lam: 1),
                       ("softsync1", lambda lam: 1),
                       ("softsyncL", lambda lam: lam)]:
        base = "hardsync" if proto == "hardsync" else "softsync"
        policy = "sqrt_scale" if base == "hardsync" else "staleness_inverse"
        for mu in mus:
            for lam in lams:
                if lam == 1 and proto != "hardsync":
                    continue
                rows.append((proto, base, policy, nfn(lam), mu, lam))
    return rows


def specs(epochs: int = 6, base_lr: float = 0.35,
          mus=_DEF_MUS, lams=_DEF_LAMS):
    out = []
    for proto, base, policy, n, mu, lam in _grid(mus, lams):
        out.append(ExperimentSpec(
            run=RunConfig(protocol=base, n_softsync=n, n_learners=lam,
                          minibatch=mu, base_lr=base_lr, lr_policy=policy,
                          ref_batch=128, optimizer="sgd", seed=7),
            problem="mlp_teacher", epochs=epochs,
            tag=f"{proto}/mu={mu}/lam={lam}"))
    return out


def derive(results, params, device=None):
    """Records → error and modelled time per grid point (pure in the
    records)."""
    from repro_torch.core import tradeoff as to
    from repro_torch.experiments.problems import get_problem

    epochs = params["epochs"]
    mus, lams = params.get("mus", _DEF_MUS), params.get("lams", _DEF_LAMS)
    hw = to.calibrate_to_baseline()
    wl = to.WorkloadModel(dataset_size=get_problem("mlp_teacher").dataset_size,
                          epochs=epochs)
    out = {}
    for (proto, base, policy, n, mu, lam), res in zip(_grid(mus, lams),
                                                      results):
        t = to.training_time("base", base, mu, lam, hw, wl)
        out[res.tag] = {"test_error": res.metrics["test_error"],
                        "train_time_s": t, "mu_lambda": mu * lam}

    small = out["hardsync/mu=4/lam=1"]["test_error"]
    large = out["hardsync/mu=128/lam=30"]["test_error"]
    emit("fig6/error_grows_with_mu_lambda", large > small,
         f"{small:.3f}->{large:.3f}")
    e_big = out["softsyncL/mu=128/lam=30"]["test_error"]
    e_small = out["softsyncL/mu=4/lam=30"]["test_error"]
    emit("fig7/small_mu_restores_error", e_small < e_big,
         f"mu128:{e_big:.3f} mu4:{e_small:.3f}")
    t1 = out["hardsync/mu=128/lam=1"]["train_time_s"]
    t30 = out["hardsync/mu=128/lam=30"]["train_time_s"]
    emit("fig6/time_falls_with_lambda", t30 < t1, f"{t1:.0f}s->{t30:.0f}s")
    return out


register_cell(Cell(
    name="fig6_7", result="fig6_7_tradeoff",
    title="Figs. 6/7: (sigma, mu, lambda) error/time tradeoff curves",
    specs=specs, derive=derive,
    claims=(
        Claim("error_grows_with_mu_lambda",
              lambda d: (d["hardsync/mu=128/lam=30"]["test_error"]
                         > d["hardsync/mu=4/lam=1"]["test_error"])),
        Claim("small_mu_restores_error",
              lambda d: (d["softsyncL/mu=4/lam=30"]["test_error"]
                         < d["softsyncL/mu=128/lam=30"]["test_error"])),
        Claim("time_falls_with_lambda",
              lambda d: (d["hardsync/mu=128/lam=30"]["train_time_s"]
                         < d["hardsync/mu=128/lam=1"]["train_time_s"])),
    ),
    params={"epochs": 6, "base_lr": 0.35}, quick_params={"epochs": 3}))
