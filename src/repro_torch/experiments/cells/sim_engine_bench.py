"""Cell ``sim_engine`` of the port (counterpart of
``repro/experiments/cells/sim_engine_bench.py``) — simulator engine
throughput on ``device``: legacy loop vs replay vs the batched sweep
driver (DESIGN.md §4/§5).

Part 1 — per-run engines on the MLP stand-in at λ ∈ {8, 32, 128}, μ = 4
(the paper's small-minibatch sweet spot, Table 3), via the experiment
surface with ``engine="legacy"`` (the per-arrival host loop: one
``grad_fn`` call per arrival, one ``ps_apply`` launch per update on the
card) vs the default replay (one ``ring_apply`` launch per event):

* ``1-softsync`` (c = λ) — the paper's Table-3 winner and the shape where
  the legacy loop hurts most: λ ``grad_fn`` calls per update.
* ``(λ/4)-softsync`` (c = 4) — staleness-heavy: the replay ring buffer K
  grows to ~2n while per-update work stays fixed.
* ``λ-softsync`` (c = 1, Eq.-5 degenerate ≈ async) — maximal staleness:
  the ring buffer runs at its full K ≈ 2λ bound and the legacy loop pays
  one complete round trip per single-gradient update.

Part 2 — the sweep headline: a 4-LR × 5-seed grid cell replayed as one
(B, K, D) ring per group (``run_sweep``/``core.engine.replay_batch``) vs
the same grid executed as sequential per-spec replays
(``run_sweep(batch=False)``).

Part 3 — the fused row: the CUDA ``ring_apply`` event (``ring_impl=
"pallas"``) against the stock gather → update → row-write chain
(``ring_impl="stock"``) on the same trace and staged batches, and the
bf16 ring.  It stands where the reference compares its megakernel with
stock XLA, and keeps the reference's key names (``megakernel_*``,
``xla_stock_*``, ``megakernel_vs_xla_ratio``), which ``table3_4`` and
``bench_guard`` read.  Part 4 — the what-if row: ``quadratic_whatif`` at
D = 1 M, one ``ring_apply_whatif`` launch per event, against the staged
stock path.

Timing protocol: per configuration both paths are warmed, then timed
best-of-N end-to-end through the public API on identical RunConfig/seed
grids (identical traces), with the device synchronized around each run.
``max_param_drift`` cross-checks result equivalence on the benchmarked
runs themselves.  Wall-clock throughput is machine-dependent, so the cell
re-times on every execution; only the drift/equivalence numbers are
claim-checked.
"""

from __future__ import annotations

import time

from repro_torch.experiments.registry import Cell, Claim, emit, register_cell

LAMBDAS = (8, 32, 128)
MU = 4
MLP_D = 2762                    # mlp_teacher flat parameter count


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _best_of(fn, device, repeats: int = 5):
    # min over repeats: discards scheduler noise on a shared host
    times, res = [], None
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times), res


def _drift(a, b, key: str) -> float:
    return float((a.params[key] - b.params[key]).abs().max())


def _bench_one(cfg, updates: int, warm_updates: int = 4,
               repeats: int = 5, device="cuda") -> dict:
    from repro_torch.experiments.driver import run as run_spec
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.launch.roofline import ring_bytes

    spec = ExperimentSpec(run=cfg, problem="mlp_teacher", steps=updates)
    legacy_spec = spec.replace(engine="legacy")

    run_spec(legacy_spec.replace(steps=warm_updates), device=device)
    t_legacy, legacy = _best_of(
        lambda: run_spec(legacy_spec, device=device), device, repeats)

    _sync(device)
    t0 = time.perf_counter()
    run_spec(spec, device=device)                     # first replay (warm)
    _sync(device)
    t_compile = time.perf_counter() - t0
    t_replay, compiled = _best_of(lambda: run_spec(spec, device=device),
                                  device, repeats)

    K = compiled.staleness["ring_buffer_K"]
    return {
        "lambda": cfg.n_learners,
        "n_softsync": cfg.n_softsync,
        "c": cfg.gradients_per_update,
        "ring_buffer_K": K,
        "updates": updates,
        "legacy_updates_per_s": updates / t_legacy,
        "compiled_updates_per_s": updates / t_replay,
        "speedup": t_legacy / t_replay,
        "compile_s": t_compile,
        "max_param_drift": _drift(legacy, compiled, "w2"),
        "ring_bytes_total": ring_bytes(
            K, MLP_D, cfg.ring_dtype, cfg.optimizer)["total_bytes"],
    }


def _bench_sweep(updates: int = 60, lam: int = 32, mu: int = 1,
                 seeds: int = 5, repeats: int = 3, device="cuda") -> dict:
    """The batched-replay headline: 4 LRs × ``seeds`` seeds at 1-softsync
    (c = λ — the Table-3 winner shape) in the small-μ regime where
    per-slot staging dominates.  All grid points share one trace shape, so
    the whole cell is one batched replay."""
    from repro_torch.config import RunConfig
    from repro_torch.experiments.driver import run_sweep
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.experiments.sweep import Sweep

    base = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=lam,
                      minibatch=mu, base_lr=0.05,
                      lr_policy="staleness_inverse", optimizer="momentum",
                      seed=17),
        problem="mlp_teacher", steps=updates)
    sweep = Sweep.over(base, base_lr=[0.02, 0.05, 0.1, 0.2],
                       seed=range(seeds))

    run_sweep(sweep, device=device)                   # warm both paths
    run_sweep(sweep, batch=False, device=device)
    t_batch, batched = _best_of(lambda: run_sweep(sweep, device=device),
                                device, repeats)
    t_seq, seq = _best_of(
        lambda: run_sweep(sweep, batch=False, device=device), device,
        repeats)
    drift = max(_drift(a, b, "w2") for a, b in zip(batched, seq))
    return {
        "grid": f"4xlr * {seeds}xseed",
        "runs": 4 * seeds,
        "protocol_shape": f"1-softsync lam={lam} c={lam} mu={mu}",
        "updates_per_run": updates,
        "sequential_s": t_seq,
        "batched_s": t_batch,
        "speedup": t_seq / t_batch,
        "max_param_drift": drift,
    }


def _bench_megakernel(updates: int = 96, lam: int = 32,
                      repeats: int = 5, device="cuda") -> dict:
    """The CUDA ``ring_apply`` event vs the stock gather → update →
    row-write chain on the same trace and staged batches (DESIGN.md §12):
    both sides go through the driver's cached-trace + staged-minibatch
    path, so the ratio isolates the event body.  Also times the bf16
    compressed ring (same event count, half the ring bytes,
    error-feedback residue carried)."""
    from repro_torch.config import RunConfig
    from repro_torch.experiments.driver import run as run_spec
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.launch.roofline import ring_bytes

    def cell(**kw):
        cfg = RunConfig(protocol="softsync", n_softsync=1, n_learners=lam,
                        minibatch=MU, base_lr=0.05,
                        lr_policy="staleness_inverse", optimizer="momentum",
                        seed=17, **kw)
        return ExperimentSpec(run=cfg, problem="mlp_teacher", steps=updates)

    rows = {}
    ref = None
    for label, kw in (("xla_stock", {"ring_impl": "stock"}),
                      ("megakernel", {"ring_impl": "pallas"}),
                      ("megakernel_bf16", {"ring_impl": "pallas",
                                           "ring_dtype": "bf16"})):
        spec = cell(**kw)
        run_spec(spec, device=device)                 # warm
        t, res = _best_of(lambda s=spec: run_spec(s, device=device), device,
                          repeats)
        K = res.staleness["ring_buffer_K"]
        rows[label] = {
            "updates_per_s": updates / t,
            "seconds": t,
            "ring_bytes_total": ring_bytes(
                K, MLP_D, spec.run.ring_dtype,
                spec.run.optimizer)["total_bytes"],
            "max_param_drift": (0.0 if ref is None
                                else _drift(ref, res, "w2")),
        }
        if ref is None:
            ref = res
    return {
        "protocol_shape": f"1-softsync lam={lam} c={lam} mu={MU}",
        "updates": updates,
        **{f"{k}_{m}": v for k, row in rows.items() for m, v in row.items()},
        "megakernel_vs_xla_ratio": (rows["megakernel"]["updates_per_s"]
                                    / rows["xla_stock"]["updates_per_s"]),
        "bf16_ring_bytes_saved": (rows["megakernel"]["ring_bytes_total"]
                                  - rows["megakernel_bf16"]
                                  ["ring_bytes_total"]),
    }


def _bench_whatif(updates: int = 96, d: int = 1_000_000,
                  repeats: int = 3, device="cuda") -> dict:
    """The what-if replay (in-kernel closed-form gradients, no staged
    data; one ``ring_apply_whatif`` launch per event on the card) vs the
    staged-gradient stock path on the same quadratic problem and trace.
    The win is peak memory — no (c, D) pulled/gradient matrices — which is
    what runs at ``configs/`` big-model D."""
    from repro_torch.config import RunConfig
    from repro_torch.experiments.driver import run as run_spec
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.launch.roofline import ring_bytes

    cfg = RunConfig(protocol="softsync", n_softsync=2, n_learners=8,
                    minibatch=1, base_lr=0.02, optimizer="momentum", seed=11)
    args = (("d", d),)
    whatif = ExperimentSpec(run=cfg, problem="quadratic_whatif",
                            problem_args=args, steps=updates)
    stock = whatif.replace(run=cfg.replace(ring_impl="stock"))

    run_spec(whatif, device=device)
    t_whatif, rw = _best_of(lambda: run_spec(whatif, device=device), device,
                            repeats)
    run_spec(stock, device=device)
    t_stock, rs = _best_of(lambda: run_spec(stock, device=device), device,
                           repeats)
    K = rw.staleness["ring_buffer_K"]
    return {
        "d": d, "updates": updates, "ring_buffer_K": K,
        "whatif_updates_per_s": updates / t_whatif,
        "staged_stock_updates_per_s": updates / t_stock,
        "vs_staged_ratio": t_stock / t_whatif,
        "max_param_drift": _drift(rw, rs, "w"),
        "ring_bytes_total": ring_bytes(
            K, d, cfg.ring_dtype, cfg.optimizer)["total_bytes"],
    }


def compute(updates: int = 480, device="cuda"):
    from repro_torch.config import RunConfig

    out = {}
    for lam in LAMBDAS:
        for label, n in [("softsync_1", 1), ("softsync_quarter", lam // 4),
                         ("softsync_lambda", lam)]:
            cfg = RunConfig(protocol="softsync", n_softsync=n,
                            n_learners=lam, minibatch=MU, base_lr=0.05,
                            lr_policy="staleness_inverse",
                            optimizer="momentum", seed=17)
            row = _bench_one(cfg, updates, device=device)
            out[f"{label}_lambda_{lam}"] = row
            emit(f"sim_engine/{label}/lambda={lam}/updates_per_s",
                 f"legacy={row['legacy_updates_per_s']:.1f} "
                 f"compiled={row['compiled_updates_per_s']:.1f}",
                 f"speedup={row['speedup']:.1f}x c={row['c']} "
                 f"K={row['ring_buffer_K']} "
                 f"drift={row['max_param_drift']:.1e}")
    # scale the sweep cell's per-run budget with the engine rows' budget so
    # --quick stays quick
    sweep_row = _bench_sweep(updates=max(10, updates // 8), device=device)
    out["sweep_batched_vs_sequential"] = sweep_row
    emit("sim_engine/sweep_batched/4lr_x_5seed",
         f"sequential={sweep_row['sequential_s']:.2f}s "
         f"batched={sweep_row['batched_s']:.2f}s",
         f"speedup={sweep_row['speedup']:.1f}x "
         f"drift={sweep_row['max_param_drift']:.1e}")
    mk_row = _bench_megakernel(updates=max(24, updates // 5), device=device)
    out["megakernel_vs_xla"] = mk_row
    emit("sim_engine/megakernel_vs_xla",
         f"megakernel={mk_row['megakernel_updates_per_s']:.1f}up/s "
         f"xla={mk_row['xla_stock_updates_per_s']:.1f}up/s",
         f"ratio={mk_row['megakernel_vs_xla_ratio']:.2f}x "
         f"drift={mk_row['megakernel_max_param_drift']:.1e}")
    emit("sim_engine/megakernel_bf16_ring",
         f"{mk_row['megakernel_bf16_updates_per_s']:.1f}up/s",
         f"ring_bytes={mk_row['megakernel_bf16_ring_bytes_total']} "
         f"(saves {mk_row['bf16_ring_bytes_saved']}) "
         f"drift={mk_row['megakernel_bf16_max_param_drift']:.1e}")
    whatif_row = _bench_whatif(updates=max(24, updates // 5), device=device)
    out["whatif_quadratic"] = whatif_row
    emit("sim_engine/whatif_quadratic",
         f"{whatif_row['whatif_updates_per_s']:.1f}up/s at "
         f"D={whatif_row['d']}",
         f"staged={whatif_row['staged_stock_updates_per_s']:.1f}up/s "
         f"ratio={whatif_row['vs_staged_ratio']:.2f}x "
         f"ring={whatif_row['ring_bytes_total']/1e6:.0f}MB")
    return [], out


register_cell(Cell(
    name="sim_engine", result="sim_engine_bench",
    title="Engine throughput: legacy vs compiled vs batched sweep",
    compute=compute,
    claims=(
        Claim("engine_rows_drift_small",
              lambda d: all(v["max_param_drift"] < 1e-3
                            for k, v in d.items()
                            if k.startswith("softsync_"))),
        Claim("sweep_drift_small",
              lambda d: (d["sweep_batched_vs_sequential"]["max_param_drift"]
                         < 1e-3)),
        Claim("megakernel_drift_small",
              lambda d: (d["megakernel_vs_xla"]["megakernel_max_param_drift"]
                         < 1e-3)),
        Claim("whatif_drift_small",
              lambda d: d["whatif_quadratic"]["max_param_drift"] < 1e-3),
    ),
    params={"updates": 480}, quick_params={"updates": 40}))
