"""Cell ``baselines`` of the port (counterpart of
``repro/experiments/cells/baselines.py``, ported as written) —
related-work baselines (paper §6) vs n-softsync, plus the §3.3 accrual
claim and a straggler ablation the paper's homogeneous-cluster assumption
hides.

Claims examined:
  * SSP with slack s hard-bounds staleness (≤ s + O(1)) but pays stalls;
    1-softsync achieves comparable error without blocking.
  * EASGD converges with unbounded replica drift (damped, not bounded).
  * Accrual (npush=k at mini-batch μ) ≈ mini-batch kμ — the paper's §3.3
    argument for why Rudra-adv* refuses to accrue.
  * Stragglers: a 10× slow learner inflates λ-softsync staleness and
    hardsync round time; 1-softsync degrades gracefully.

Uses the legacy ``simulate``/``simulate_*`` entry points on ``device``
directly — the baseline protocols (SSP stalls, EASGD elastic pull,
accrual) are not trace-replayable, so this stays a compute cell.  On the
card every update of the host PS (``simulate`` and ``simulate_accrual``)
is one ``ps_apply`` launch; SSP and EASGD step their replicas in plain
PyTorch, as the reference does in jnp.  The straggler samplers draw from
the simulators' ``rng`` in the reference's order.
"""

from __future__ import annotations

from repro_torch.experiments.registry import (Cell, derived_claims, emit,
                                              register_cell)


def compute(epochs: int = 8, base_lr: float = 0.35, device="cuda"):
    from repro_torch.config import RunConfig
    from repro_torch.core.baselines import (simulate_accrual, simulate_easgd,
                                            simulate_ssp)
    from repro_torch.core.engine import resolve_device
    from repro_torch.core.simulator import _default_duration_sampler, simulate
    from repro_torch.experiments.driver import per_arrival_grad
    from repro_torch.experiments.problems import get_problem, updates_for_epochs

    dev = resolve_device(device)
    prob = get_problem("mlp_teacher")
    grad_fn = per_arrival_grad(prob.grad_fn)
    lam, mu = 16, 16
    out = {}

    def sgd_kw(m):
        return dict(grad_fn=grad_fn, init_params=prob.init(dev),
                    batch_fn=prob.batch_fn_for(m), device=dev)

    # ---- protocol comparison at matched sample budgets ---------------------
    budget_updates = updates_for_epochs(epochs, mu, 1, prob.task.n_train)

    soft = simulate(
        RunConfig(protocol="softsync", n_softsync=1, n_learners=lam,
                  minibatch=mu, base_lr=base_lr,
                  lr_policy="staleness_inverse", optimizer="sgd", seed=21),
        steps=budget_updates // lam, **sgd_kw(mu))
    out["1-softsync"] = {"err": prob.test_error(soft.params),
                         "mean_sigma": soft.clock_log.mean_staleness()}

    for slack in (2, 8):
        ssp = simulate_ssp(
            RunConfig(protocol="async", n_learners=lam, minibatch=mu,
                      base_lr=base_lr, lr_policy="staleness_inverse",
                      optimizer="sgd", seed=21),
            steps=budget_updates, slack=slack, **sgd_kw(mu))
        vals = ssp.clock_log.all_staleness_values()
        out[f"ssp_slack={slack}"] = {
            "err": prob.test_error(ssp.params),
            "mean_sigma": ssp.clock_log.mean_staleness(),
            "max_sigma": float(vals.max()),
            "stalls": getattr(ssp, "stalls", 0)}
        emit(f"baselines/ssp_s={slack}/max_staleness", f"{vals.max():.0f}",
             f"bound~slack+lam; stalls={getattr(ssp, 'stalls', 0)}")

    # SSP only *pays* under heterogeneity: with a 10x straggler the fast
    # learners hit the slack wall and block (the stall count), which is the
    # cost 1-softsync never pays.
    def straggler10(rng, m):
        base = _default_duration_sampler(rng, m)
        return base * (10.0 if rng.integers(0, lam) == 0 else 1.0)
    ssp_slow = simulate_ssp(
        RunConfig(protocol="async", n_learners=lam, minibatch=mu,
                  base_lr=base_lr, lr_policy="staleness_inverse",
                  optimizer="sgd", seed=21),
        steps=budget_updates // 2, slack=2, duration_sampler=straggler10,
        **sgd_kw(mu))
    out["ssp_straggler"] = {"stalls": getattr(ssp_slow, "stalls", 0),
                            "time": ssp_slow.simulated_time}
    emit("baselines/ssp_stalls_under_straggler",
         getattr(ssp_slow, "stalls", 0) > 0,
         f"stalls={getattr(ssp_slow, 'stalls', 0)} (softsync never blocks)")

    eas = simulate_easgd(
        RunConfig(protocol="async", n_learners=lam, minibatch=mu,
                  base_lr=base_lr / 4, optimizer="sgd", seed=21),
        steps=budget_updates, rho=0.2, **sgd_kw(mu))
    out["easgd"] = {"err": prob.test_error(eas.params)}

    emit("baselines/1-softsync/err", f"{out['1-softsync']['err']:.4f}", "")
    emit("baselines/ssp_s=2/err", f"{out['ssp_slack=2']['err']:.4f}", "")
    emit("baselines/easgd/err", f"{out['easgd']['err']:.4f}", "")
    competitive = (out["1-softsync"]["err"]
                   <= min(out["ssp_slack=2"]["err"],
                          out["easgd"]["err"]) + 0.03)
    emit("baselines/softsync_competitive", competitive,
         "within 3pts of the best related-work baseline")

    # ---- accrual ≈ bigger μ (§3.3) -----------------------------------------
    k = 4
    acc_steps = updates_for_epochs(epochs, mu * k, lam, prob.task.n_train)
    acc = simulate_accrual(
        RunConfig(protocol="softsync", n_softsync=1, n_learners=lam,
                  minibatch=mu, base_lr=base_lr,
                  lr_policy="staleness_inverse", optimizer="sgd", seed=23),
        steps=acc_steps, npush=k, **sgd_kw(mu))
    bigmu = simulate(
        RunConfig(protocol="softsync", n_softsync=1, n_learners=lam,
                  minibatch=mu * k, base_lr=base_lr,
                  lr_policy="staleness_inverse", optimizer="sgd", seed=23),
        steps=acc_steps, **sgd_kw(mu * k))
    e_acc, e_big = prob.test_error(acc.params), prob.test_error(bigmu.params)
    out["accrual_k4"] = {"err": e_acc}
    out["mu_x4"] = {"err": e_big}
    emit("baselines/accrual_equals_bigger_mu", abs(e_acc - e_big) < 0.05,
         f"npush=4@mu16:{e_acc:.4f} vs mu64:{e_big:.4f} (paper §3.3)")

    # ---- straggler ablation -------------------------------------------------
    def straggler_sampler(rng, m):
        base = _default_duration_sampler(rng, m)
        return base * (10.0 if rng.integers(0, lam) == 0 else 1.0)

    meas_uniform = simulate(
        RunConfig(protocol="softsync", n_softsync=lam, n_learners=lam,
                  minibatch=mu, seed=29), steps=1500, device=dev)
    meas_straggle = simulate(
        RunConfig(protocol="softsync", n_softsync=lam, n_learners=lam,
                  minibatch=mu, seed=29), steps=1500,
        duration_sampler=straggler_sampler, device=dev)
    s_u = meas_uniform.clock_log.all_staleness_values().max()
    s_s = meas_straggle.clock_log.all_staleness_values().max()
    out["straggler"] = {"max_sigma_uniform": float(s_u),
                        "max_sigma_straggler": float(s_s)}
    emit("baselines/straggler_inflates_max_staleness", bool(s_s > s_u),
         f"{s_u:.0f} -> {s_s:.0f} (heterogeneity breaks the 2n bound)")

    out["claims"] = {
        "softsync_competitive": bool(competitive),
        "ssp_stalls_under_straggler": getattr(ssp_slow, "stalls", 0) > 0,
        "accrual_equals_bigger_mu": bool(abs(e_acc - e_big) < 0.05),
        "straggler_inflates_max_staleness": bool(s_s > s_u),
    }
    return [], out


def ps_updates(epochs: float = 8, **_) -> int:
    """The host-PS updates ``compute`` applies at ``epochs`` — one
    ``ps_apply`` launch each on the card: the 1-softsync run, the accrual
    run and its bigger-μ twin (SSP and EASGD step in plain PyTorch; the
    straggler ablation is measure-only)."""
    from repro_torch.experiments.problems import get_problem, updates_for_epochs
    n = get_problem("mlp_teacher").task.n_train
    lam, mu, k = 16, 16, 4
    return (updates_for_epochs(epochs, mu, 1, n) // lam
            + 2 * updates_for_epochs(epochs, mu * k, lam, n))


register_cell(Cell(
    name="baselines", result="baselines",
    title="Related-work baselines: SSP / EASGD / accrual / stragglers",
    compute=compute,
    claims=derived_claims("softsync_competitive",
                          "ssp_stalls_under_straggler",
                          "accrual_equals_bigger_mu",
                          "straggler_inflates_max_staleness"),
    params={"epochs": 8, "base_lr": 0.35}, quick_params={"epochs": 3}))
