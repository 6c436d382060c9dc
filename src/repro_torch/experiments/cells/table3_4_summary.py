"""Cell ``table3_4`` of the port (counterpart of
``repro/experiments/cells/table3_4_summary.py``) — paper Tables 3/4 +
Fig. 9: best-(σ, μ, λ) selection (Table 3) and the ImageNet-scale analog —
the four deployment configurations base-hardsync / base-softsync /
adv-softsync / adv*-softsync (Table 4), with error from the
protocol-faithful legacy simulator on ``device`` (one ``ps_apply`` launch
per host-PS update on the card) and time/epoch from the calibrated
runtime model scaled to a 289 MB model.

Campaign report cell: depends on the topology / elastic / serve /
sim_engine cells and folds their ``derived`` blocks into the summary
envelope, reading them through the registry (``needs_results_dir``).
The reference also depends on ``distributed``, which the port does not
have yet (ROADMAP.md item 8): ``registry.resolve_order`` and
``cell_hash`` reject a dep that is not registered, so it is left out of
``_DEPS`` and its fold is skipped until then.
"""

from __future__ import annotations

from repro_torch.experiments.registry import (Cell, Claim, emit,
                                              load_envelope, register_cell)

_DEPS = ("topology", "elastic", "serve", "sim_engine")

# Table 3's candidates and Table 4's deployments (label, protocol, n, μ, λ)
_CANDIDATES = (
    ("1-softsync", "softsync", 1, 4, 30),
    ("hardsync", "hardsync", 1, 8, 30),
    ("L-softsync", "softsync", 30, 4, 30),
    ("hardsync", "hardsync", 1, 4, 30),
    ("18-softsync", "softsync", 18, 8, 18),
)
_DEPLOYMENTS = (
    ("base-hardsync", "base", "hardsync", 1, 16, 18, 0.0),
    ("base-softsync", "base", "softsync", 1, 16, 18, 0.0),
    ("adv-softsync", "adv", "softsync", 1, 4, 54, 0.0),
    ("adv*-softsync", "adv*", "softsync", 1, 4, 54, 0.3),
)


def _run_config(protocol, n, mu, lam, base_lr=0.35):
    from repro_torch.config import RunConfig
    policy = "sqrt_scale" if protocol == "hardsync" else "staleness_inverse"
    return RunConfig(protocol=protocol, n_softsync=n, n_learners=lam,
                     minibatch=mu, base_lr=base_lr, lr_policy=policy,
                     ref_batch=128, optimizer="sgd", seed=13)


def _steps(prob, cfg, epochs) -> int:
    from repro_torch.experiments.problems import updates_for_epochs
    return updates_for_epochs(epochs, cfg.minibatch,
                              cfg.gradients_per_update, prob.task.n_train)


def _sim_error(prob, protocol, n, mu, lam, epochs, device,
               extra_staleness: float = 0.0):
    from repro_torch.core.simulator import _default_duration_sampler, simulate
    from repro_torch.experiments.driver import per_arrival_grad

    cfg = _run_config(protocol, n, mu, lam)
    kw = dict(steps=_steps(prob, cfg, epochs),
              grad_fn=per_arrival_grad(prob.grad_fn),
              init_params=prob.init(device), batch_fn=prob.batch_fn_for(mu),
              device=device)
    if extra_staleness > 0:
        # adv*: async comm threads add delivery delay ⇒ extra staleness.
        # Model as a duration sampler with heavier jitter.
        def sampler(rng, m):
            return _default_duration_sampler(rng, m) * \
                rng.lognormal(0.0, 0.3)
        res = simulate(cfg, duration_sampler=sampler, **kw)
    else:
        res = simulate(cfg, **kw)
    return prob.test_error(res.params), res.clock_log.mean_staleness()


def ps_updates(epochs: float = 10, **_) -> int:
    """The host-PS updates ``compute`` applies at ``epochs`` — one
    ``ps_apply`` launch each on the card (every simulation runs exactly its
    step budget)."""
    from repro_torch.experiments.problems import get_problem
    prob = get_problem("mlp_teacher")
    rows = [r[1:] for r in _CANDIDATES] + [r[2:6] for r in _DEPLOYMENTS]
    return sum(_steps(prob, _run_config(*r), epochs) for r in rows)


def _derived_of(cell_name: str, results_dir: str):
    env = load_envelope(cell_name, results_dir)
    return (env or {}).get("derived") or {}


def compute(epochs: int = 10, results_dir: str = None, device="cuda"):
    from repro_torch.core import tradeoff as to
    from repro_torch.core.engine import resolve_device
    from repro_torch.experiments.problems import get_problem

    dev = resolve_device(device)
    prob = get_problem("mlp_teacher")
    hw = to.calibrate_to_baseline()
    out = {}

    # ---- Table 3: best configs (low error AND small time) ------------------
    rows = []
    for label, proto, n, mu, lam in _CANDIDATES:
        err, sig = _sim_error(prob, proto, n, mu, lam, epochs, dev)
        t = to.training_time("base", proto, mu, lam, hw,
                             to.WorkloadModel(dataset_size=prob.task.n_train,
                                              epochs=epochs))
        rows.append({"config": f"{label}(s={n},mu={mu},lam={lam})",
                     "test_error": err, "time_s": t, "staleness": sig})
        emit(f"table3/{label}/s={n}_mu={mu}_lam={lam}",
             f"err={err:.4f}", f"time={t:.0f}s")
    out["table3"] = rows
    # paper's selection: fastest among the configurations within 1% absolute
    # error of the best (Table 3 is sorted by this combination)
    err_min = min(r["test_error"] for r in rows)
    near = [r for r in rows if r["test_error"] <= err_min + 0.01]
    best = min(near, key=lambda r: r["time_s"])
    emit("table3/best_config", best["config"],
         "paper-best: 1-softsync mu=4 lam=30")
    # the paper's Table-3 top-2 are 1-softsync(μ4,λ30) and hardsync(μ8,λ30);
    # our runtime model may order those two either way (GEMM-efficiency
    # calibration), but the winner must come from that pair.
    top2 = best["config"].startswith(("1-softsync(s=1,mu=4,lam=30",
                                      "hardsync(s=1,mu=8,lam=30"))
    emit("table3/best_in_paper_top2", top2, best["config"])
    out["table3_best"] = {"config": best["config"], "in_paper_top2": top2}

    # ---- Table 4: the four ImageNet-analog deployments ---------------------
    wl = to.WorkloadModel(model_bytes=289e6, dataset_size=prob.task.n_train,
                          epochs=epochs)
    t4 = []
    for label, arch, proto, n, mu, lam, extra in _DEPLOYMENTS:
        err, sig = _sim_error(prob, proto, n, mu, lam, epochs, dev,
                              extra_staleness=extra)
        t_epoch = to.epoch_time(arch, proto, mu, lam, hw, wl)
        t4.append({"config": label, "test_error": err,
                   "minutes_per_epoch_model": t_epoch / 60.0,
                   "staleness": sig})
        emit(f"table4/{label}", f"err={err:.4f}",
             f"epoch={t_epoch/60:.1f}min <sigma>={sig:.2f}")
    out["table4"] = t4
    speeds = [r["minutes_per_epoch_model"] for r in t4]
    emit("table4/speed_ordering_adv*<adv<base-soft<base-hard",
         speeds[3] < speeds[2] < speeds[1] < speeds[0], "")
    err_hard = t4[0]["test_error"]
    err_star = t4[3]["test_error"]
    emit("table4/hardsync_best_error", err_hard <= err_star + 0.05,
         f"{err_hard:.3f} vs adv*:{err_star:.3f}")

    # ---- dependency cells: fold their derived blocks in --------------------
    derived = _derived_of("topology", results_dir)
    if derived:
        out["topology_scaling"] = derived
        for arch, curve in sorted(derived.get("train_seconds", {}).items()):
            span = {int(k): v for k, v in curve.items()}
            lam0, lam1 = min(span), max(span)
            emit(f"summary/topology/{arch}",
                 f"train[{lam0}]={span[lam0]:.0f}s "
                 f"train[{lam1}]={span[lam1]:.0f}s",
                 f"speedup={span[lam0] / span[lam1]:.1f}x over "
                 f"{lam1 // lam0}x learners")

    derived = _derived_of("elastic", results_dir)
    if derived:
        out["elastic_churn"] = derived
        for name, s in sorted(derived.get("scenarios", {}).items()):
            emit(f"summary/elastic/{name}",
                 f"err={s['test_error_mean']:.4f}",
                 f"train_s={s['train_s_mean']:.0f}")
        claims = derived.get("claims", {})
        emit("summary/elastic/chen_ordering_holds",
             all(claims.values()) if claims else False,
             " ".join(k for k, v in sorted(claims.items()) if not v))

    derived = _derived_of("serve", results_dir)
    if derived:
        out["train_while_serve"] = derived
        for name, s in sorted(derived.get("scenarios", {}).items()):
            emit(f"summary/serve/{name}",
                 f"acc={s['serving_accuracy_mean']:.4f}",
                 f"stale={s['staleness_mean']:.1f} "
                 f"p99={s['latency_p99_s']:.2f}s")
        claims = derived.get("claims", {})
        emit("summary/serve/staleness_tradeoff_holds",
             all(claims.values()) if claims else False,
             " ".join(k for k, v in sorted(claims.items()) if not v))

    rows = _derived_of("sim_engine", results_dir)
    if rows:
        out["sim_engine"] = rows
        for key, r in sorted(rows.items()):
            if "compiled_updates_per_s" in r:
                ring = (f" ring={r['ring_bytes_total'] / 1e6:.1f}MB"
                        if "ring_bytes_total" in r else "")
                emit(f"summary/sim_engine/{key}",
                     f"{r['compiled_updates_per_s']:.0f}up/s",
                     f"legacy={r['legacy_updates_per_s']:.0f} "
                     f"speedup={r['speedup']:.1f}x" + ring)
            elif "megakernel_vs_xla_ratio" in r:
                emit(f"summary/sim_engine/{key}",
                     f"{r['megakernel_updates_per_s']:.0f}up/s",
                     f"vs_xla={r['megakernel_vs_xla_ratio']:.2f}x "
                     f"bf16_ring_saves="
                     f"{r['bf16_ring_bytes_saved'] / 1e6:.1f}MB")
            elif "batched_s" in r:
                emit(f"summary/sim_engine/{key}",
                     f"{r['runs']}-run sweep {r['batched_s']:.2f}s batched",
                     f"sequential={r['sequential_s']:.2f}s "
                     f"speedup={r['speedup']:.1f}x")
    return [], out


register_cell(Cell(
    name="table3_4", result="table3_4_summary",
    title="Tables 3/4: best configs + deployment summary report",
    compute=compute, deps=_DEPS, needs_results_dir=True,
    claims=(
        Claim("best_in_paper_top2",
              lambda d: d["table3_best"]["in_paper_top2"]),
        Claim("table4_speed_ordering",
              lambda d: (d["table4"][3]["minutes_per_epoch_model"]
                         < d["table4"][2]["minutes_per_epoch_model"]
                         < d["table4"][1]["minutes_per_epoch_model"]
                         < d["table4"][0]["minutes_per_epoch_model"])),
        Claim("hardsync_best_error",
              lambda d: (d["table4"][0]["test_error"]
                         <= d["table4"][3]["test_error"] + 0.05)),
    ),
    params={"epochs": 10}, quick_params={"epochs": 3}))
