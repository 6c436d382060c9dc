"""The rest of the ``paper`` campaign on the port (ROADMAP.md item 6):
the cells ``fig4``, ``table1``, ``fig8``, ``fig5``, ``fig6_7``,
``table2``, ``baselines``, ``table3_4``, ``sim_engine``, ``kernels`` and
``bench_guard``, the ``smoke`` campaign, and ``launch/roofline.ring_bytes``,
against the reference package's.

Each cell runs at a tiny size through both packages' ``run_cell`` on the
CPU, each into its own temporary results directory (``fig4`` 200 steps;
``fig5``, ``fig6_7``, ``table2``, ``baselines`` and ``table3_4`` at
0.05–0.1 of an epoch; ``fig6_7`` over μ ∈ {4, 128}, λ ∈ {1, 30}).  Held:

* records in the same order with the same tags; ``simulated_time``,
  ``updates``, ``minibatches``, the staleness block and ``replay_path``
  exactly the reference's (host numpy, bitwise schedules);
* the claims exactly the reference's; the analytic ``derived`` of
  ``table1`` and ``fig8`` exactly, and every number of ``derived`` that
  does not come from a metric (simulated time, staleness, stalls,
  ``time_s``, ``minutes_per_epoch_model``) exactly; the metrics and the
  numbers derived from them within two of the 2 048 test samples (2/2048),
  the policy of ``test_torch_campaign.py``.

The timing cells (``sim_engine``, ``kernels``, ``bench_guard``) measure
wall clocks, so they are held by structure, claims and their analytic
parts: ``bench_guard.check`` against the reference's on the same dicts,
``kernels``' traffic model against the reference's committed envelope.

``python tests/test_torch_paper_cells.py`` (imports both packages; a few
minutes) prints how far today's reference is from the committed envelopes
of the replay and legacy cells at their default params — the basis of
``chip_smoke.py``'s phase 12 envelope tolerance.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import json
import math
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.experiments import campaign, registry
from repro_torch.experiments.cells import bench_guard, table3_4_summary
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "benchmarks" / "results"
METRIC_TOL = 2 / 2048
PAPER_CELLS = ("fig4", "table1", "fig8", "fig5", "fig6_7", "table2",
               "baselines", "table3_4")
PARAMS = {"fig4": {"steps": 200},
          "table1": {},
          "fig8": {},
          "fig5": {"epochs": 0.1},
          "fig6_7": {"epochs": 0.1, "mus": (4, 128), "lams": (1, 30)},
          "table2": {"epochs": 0.1},
          "baselines": {"epochs": 0.1},
          "table3_4": {"epochs": 0.05}}
# derived keys whose numbers come from the metrics (test error and what is
# computed from it)
METRIC_KEYS = ("err", "test_error", "trace", "spread", "mean_error_by_prod")
SCHEDULE_KEYS = ("simulated_time", "updates", "minibatches")


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.experiments import campaign as r_campaign
    from repro.experiments import registry as r_registry
    return types.SimpleNamespace(campaign=r_campaign, registry=r_registry)


@pytest.fixture(scope="module")
def envelopes(R, tmp_path_factory):
    """name → (port envelope, reference envelope)."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for name in PAPER_CELLS:
            port_dir = tmp_path_factory.mktemp(f"port_{name}")
            ref_dir = tmp_path_factory.mktemp(f"ref_{name}")
            campaign.run_cell(name, PARAMS[name], results_dir=str(port_dir),
                              device="cpu")
            R.campaign.run_cell(name, PARAMS[name], results_dir=str(ref_dir))
            out[name] = (registry.load_envelope(name, str(port_dir)),
                         R.registry.load_envelope(name, str(ref_dir)))
    return out


def _schedule_side(rec):
    side = {k: rec["runtime"][k] for k in SCHEDULE_KEYS}
    side["staleness"] = rec["staleness"]
    side["replay_path"] = rec["runtime"]["replay_path"]
    return side


def _finite_equal(a, b):
    """Both finite and within METRIC_TOL, or both non-finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.isfinite(a) == math.isfinite(b)
    return abs(a - b) <= METRIC_TOL


def _held(port, ref, path=()):
    """Every leaf of ``ref`` in ``port``: equal, or within METRIC_TOL (and
    non-finite on both sides together) below a metric key."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _held(port[k], ref[k], path + (k,))
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _held(a, b, path + (i,))
    elif isinstance(ref, float) and any(
            any(m in str(p) for m in METRIC_KEYS) for p in path):
        assert _finite_equal(port, ref), (path, port, ref)
    else:
        assert port == ref, path


@pytest.mark.parametrize("name", ("fig4", "fig5", "fig6_7", "table2"))
def test_spec_cell_records_match_reference(name, envelopes):
    port, ref = envelopes[name]
    assert len(port["records"]) == len(ref["records"]) > 0
    for p, r in zip(port["records"], ref["records"]):
        assert p["spec"]["tag"] == r["spec"]["tag"]
        assert _schedule_side(p) == _schedule_side(r), p["spec"]["tag"]
        assert set(p["metrics"]) == set(r["metrics"])
        for k, v in r["metrics"].items():
            assert _finite_equal(p["metrics"][k], v), (p["spec"]["tag"], k)
    if name == "fig4":
        assert {p["runtime"]["replay_path"] for p in port["records"]} == {
            "measure"}


@pytest.mark.parametrize("name", PAPER_CELLS)
def test_cell_derived_and_claims_match_reference(name, envelopes):
    port, ref = envelopes[name]
    assert port["campaign"]["claims"] == ref["campaign"]["claims"]
    assert len(port["campaign"]["claims"]) > 0
    _held(port["derived"], ref["derived"])
    if name in ("table1", "fig8"):          # analytic: exactly
        assert port["derived"] == ref["derived"]


def test_fig5_per_gradient_replays_sequentially_and_final_only(envelopes):
    port, _ = envelopes["fig5"]
    for rec in port["records"]:
        if rec["spec"]["tag"].endswith("per_gradient"):
            assert rec["runtime"]["replay_path"] == "sequential"
            assert rec["curve"] == []
        else:
            assert rec["curve"], rec["spec"]["tag"]


@pytest.mark.parametrize("name", ("table1", "fig8"))
def test_analytic_cells_equal_the_committed_envelopes(name):
    """The analytic cells at their default params give the reference's
    committed ``derived`` exactly (what phase 12 holds on the card)."""
    cell = registry.get_cell(name)
    env = json.loads((RESULTS / f"{cell.result}.json").read_text())
    _, derived = cell.compute(device="cpu")
    assert json.loads(json.dumps(derived)) == env["derived"]


def test_cells_in_paper_and_smoke_match_reference(R):
    have = [c.name for c in registry.cells_in("paper")]
    want = [c.name for c in R.registry.cells_in("paper")]
    assert have == want and {"ring", "distributed"} <= set(have)
    assert [c.name for c in registry.cells_in("smoke")] == [
        c.name for c in R.registry.cells_in("smoke")]


def test_table3_4_deps_leave_out_distributed(R):
    """Named when the port left ``distributed`` out of table3_4's deps
    (until ROADMAP.md item 8): now its five deps are the reference's, in
    the reference's order, and resolve dependency-first."""
    cell = registry.get_cell("table3_4")
    ref = R.registry.get_cell("table3_4")
    assert cell.deps == ref.deps == ("topology", "elastic", "serve",
                                     "distributed", "sim_engine")
    assert registry.get_cell("distributed").result == "distributed_replay"
    order = registry.resolve_order(["table3_4"])
    assert order[-1] == "table3_4" and set(cell.deps) <= set(order)


def test_table3_4_ps_updates_reckons_the_legacy_runs():
    """``ps_updates`` (what phase 12 reckons ``ps_apply`` launches from)
    counts the step budget of each of the nine simulations."""
    from repro_torch.experiments.cells import baselines
    # 8 192 training samples; Table 3: 682 + 341 + 20 480 + 682 + 10 240,
    # Table 4: 284 + 284 + 379 + 379 updates at 10 epochs
    assert table3_4_summary.ps_updates(epochs=10) == 32425 + 1326
    assert table3_4_summary.ps_updates(epochs=3) == 10122
    # the 1-softsync run (4 096 updates' budget over λ = 16), the accrual
    # run and its μ × 4 twin (8 each)
    assert baselines.ps_updates(epochs=8) == 4096 // 16 + 2 * 64
    assert baselines.ps_updates(epochs=3) == 144


@pytest.mark.parametrize("ring_dtype", ("fp32", "bf16"))
@pytest.mark.parametrize("optimizer", ("sgd", "momentum", "adagrad",
                                       "adamw"))
@pytest.mark.parametrize("donated", (True, False))
def test_ring_bytes_equal_reference(ring_dtype, optimizer, donated):
    pytest.importorskip("jax")
    from repro.launch.roofline import ring_bytes as r_ring_bytes
    for K, D in ((1, 2762), (8, 1 << 18), (3, 1_000_000)):
        assert roofline.ring_bytes(K, D, ring_dtype, optimizer, donated) \
            == r_ring_bytes(K, D, ring_dtype, optimizer, donated)
    with pytest.raises(ValueError):
        roofline.ring_bytes(2, 8, "fp16")


def test_bench_guard_check_matches_reference_and_trips():
    pytest.importorskip("jax")
    from repro.experiments.cells import bench_guard as r_bench_guard
    floor = json.loads(Path(bench_guard.FLOOR_PATH).read_text())
    assert set(floor["floors"]) == set(bench_guard.FLOOR_MARGINS)
    assert set(floor["floors"]) == set(r_bench_guard.FLOOR_MARGINS)
    for scale in (1.0, 0.5, 100.0):
        for factor in (0.5, 0.71, 1.0, 2.0):
            metrics = {k: v * factor for k, v in floor["floors"].items()}
            assert bench_guard.check(metrics, floor, scale) == \
                r_bench_guard.check(metrics, floor, scale)
    at_floor = {k: v for k, v in floor["floors"].items()}
    assert all(r["ok"] for r in bench_guard.check(at_floor, floor))
    assert not any(r["ok"] for r in bench_guard.check(at_floor, floor,
                                                      100.0))


def test_bench_guard_cli_passes_at_scale_1_and_fails_at_100(monkeypatch,
                                                            tmp_path,
                                                            capsys):
    """The CLI through ``run_cell`` with the measurement stubbed at the
    floors' own values: exit 0, then exit 1 at ``--floor-scale 100``; no
    metric is absent (the distributed one included)."""
    floor = json.loads(Path(bench_guard.FLOOR_PATH).read_text())
    monkeypatch.setattr(bench_guard, "measure", lambda device="cuda": {
        "metrics": dict(floor["floors"])})
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    argv = ["--device", "cpu"]
    assert bench_guard.main(argv) == 0
    env = registry.load_envelope("bench_guard", str(tmp_path))
    assert env["campaign"]["claims"]["all_perf_floors_hold"]["ok"]
    assert "absent" not in env["derived"]
    checked = {r["metric"] for r in env["derived"]["checks"]}
    assert checked == set(bench_guard.FLOOR_MARGINS)
    assert "distributed_replay_updates_per_s" in checked
    assert "ABSENT" not in capsys.readouterr().out
    assert bench_guard.main(argv + ["--floor-scale", "100"]) == 1
    env = registry.load_envelope("bench_guard", str(tmp_path))
    assert not env["campaign"]["claims"]["all_perf_floors_hold"]["ok"]


def test_bench_guard_command_line_runs_as_a_module():
    """``python -m repro_torch.experiments.bench_guard`` (the shim; the
    cell module itself is imported by the package first)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.experiments.bench_guard", "--help"],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert "--floor-scale" in out.stdout and "--write-floor" in out.stdout
    assert "Warning" not in out.stderr


def test_bench_guard_floor_file_is_the_ports():
    floor = json.loads(Path(bench_guard.FLOOR_PATH).read_text())
    assert Path(bench_guard.FLOOR_PATH).parent == (
        ROOT / "src" / "repro_torch" / "experiments")
    assert "H100" in floor["note"] and " W" in floor["note"]
    for k, v in floor["floors"].items():
        assert v == round(floor["measured"][k] * bench_guard.FLOOR_MARGINS[k],
                          3)


def test_kernels_cell_on_cpu():
    """Every correctness boolean true and the analytic traffic model and
    ring bytes equal to the reference's committed envelope."""
    from repro_torch.experiments.cells import kernel_bench
    ref = json.loads((RESULTS / "kernel_bench.json").read_text())["derived"]
    _, d = kernel_bench.compute(device="cpu")
    assert d["ps_update_allclose"] and d["ps_update_timed"]["allclose"]
    mk = d["replay_megakernel"]
    assert mk["fp32_bitwise"] and mk["bf16_master_exact"]
    for c in (2, 4, 8, 15, 30):
        assert d[f"ps_update_c={c}"] == ref[f"ps_update_c={c}"]
    for k in ("D", "K", "c", "ring_bytes_fp32", "ring_bytes_bf16"):
        assert mk[k] == ref["replay_megakernel"][k], k
    assert set(d) == set(ref)
    assert d["ssd"]["chunked_us"] > 0 and d["attention"]["naive_us"] > 0


def test_sim_engine_cell_on_cpu(tmp_path):
    """The cell at a tiny budget through ``run_cell``: every claim ok and
    the reference's row and key names (``table3_4`` and ``bench_guard``
    read them)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        d = campaign.run_cell("sim_engine", {"updates": 8},
                              results_dir=str(tmp_path), device="cpu")
    env = registry.load_envelope("sim_engine", str(tmp_path))
    assert all(c["ok"] for c in env["campaign"]["claims"].values())
    ref = json.loads((RESULTS / "sim_engine_bench.json").read_text())
    assert set(d) == set(ref["derived"])
    for key, row in ref["derived"].items():
        assert set(d[key]) == set(row), key
    assert d["softsync_1_lambda_128"]["c"] == 128
    assert d["whatif_quadratic"]["d"] == 1_000_000


def test_table3_4_folds_dependency_envelopes(tmp_path):
    """A dep envelope in the results directory is folded into the
    summary (here a stub ``sim_engine`` row), a missing one is skipped."""
    cell = registry.get_cell("sim_engine")
    row = {"compiled_updates_per_s": 10.0, "legacy_updates_per_s": 2.0,
           "speedup": 5.0}
    campaign.write_envelope(cell, [], {"softsync_1_lambda_8": row}, {},
                            False, False, str(tmp_path))
    dist = {"devices": 8, "cpu_count": 8, "d": 4096,
            "updates_per_s": {"spmd_s1": 10.0, "spmd_s4": 12.0},
            "scaling_s4_over_s1": 1.2}
    campaign.write_envelope(registry.get_cell("distributed"), [], dist, {},
                            False, False, str(tmp_path))
    _, d = table3_4_summary.compute(epochs=0.02, results_dir=str(tmp_path),
                                    device="cpu")
    assert d["sim_engine"] == {"softsync_1_lambda_8": row}
    assert d["distributed_replay"] == dist
    assert "topology_scaling" not in d and "elastic_churn" not in d


def test_smoke_campaign_twice_second_pass_all_cache_hits(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        first = campaign.run_campaign("smoke", results_dir=str(tmp_path),
                                      device="cpu")
        second = campaign.run_campaign("smoke", results_dir=str(tmp_path),
                                       device="cpu")
    assert first["executed"] == 3 and first["failed_claims"] == 0
    assert second["cached"] == 3 and second["executed"] == 0
    assert {e["action"] for e in second["cells"].values()} == {"cached"}


@pytest.mark.parametrize("name", ("fig4", "fig5", "fig6_7", "table2",
                                  "table1", "fig8"))
def test_reference_envelopes_of_paper_cells_are_current(R, name):
    """The committed card-side targets of phase 12: the reference's own
    envelopes, CURRENT at their default params."""
    status, detail = R.campaign.cell_status(R.registry.get_cell(name),
                                            results_dir=str(RESULTS))
    assert status == "CURRENT", (name, detail)


@pytest.mark.parametrize("name", ("fig5", "baselines", "table3_4",
                                  "sim_engine", "kernels", "bench_guard",
                                  "ring", "distributed"))
def test_new_cells_default_to_cuda_and_raise_without_card(name, monkeypatch,
                                                          tmp_path):
    """Without a card, a cell run with no ``device=`` raises instead of
    quietly using the CPU (before any measurement or simulation)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = registry.get_cell(name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if cell.compute is not None:
            cell.compute(**cell.resolved_params(quick=True))
        else:
            campaign.run_cell(name, {"epochs": 0.01},
                              results_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# envelope drift (not a test)
# ---------------------------------------------------------------------------
def _metric_leaves(d, path=()):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _metric_leaves(v, path + (k,))
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _metric_leaves(v, path + (i,))
    elif isinstance(d, float) and path and any(
            m in str(path[-1]) for m in ("err", "test_error")):
        yield path, d


def envelope_drift() -> int:
    """Today's reference at each replay and legacy cell's default params
    against its committed envelope: the largest |reference − envelope| of
    any test error (records' metrics and ``derived``), and whether every
    record's schedule side is the envelope's.  The basis of
    ``chip_smoke.py``'s ``PAPER_ENVELOPE_TOL``; takes a few minutes.  Run:
    ``PYTHONPATH=src python tests/test_torch_paper_cells.py``."""
    import tempfile

    from repro.experiments import campaign as r_campaign
    from repro.experiments import registry as r_registry
    for name in ("fig5", "fig6_7", "table2", "baselines", "table3_4"):
        cell = r_registry.get_cell(name)
        env = json.loads((RESULTS / f"{cell.result}.json").read_text())
        with tempfile.TemporaryDirectory() as tmp, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r_campaign.run_cell(name, results_dir=tmp)
            now = r_registry.load_envelope(name, tmp)
        worst, same_schedule = 0.0, True
        by_hash = {r["spec_hash"]: r for r in env["records"]}
        for rec in now["records"]:
            old = by_hash[rec["spec_hash"]]
            same_schedule &= _schedule_side(rec) == _schedule_side(
                dict(old, runtime=dict(
                    old["runtime"],
                    replay_path=rec["runtime"]["replay_path"])))
            for k, v in old["metrics"].items():
                a = rec["metrics"][k]
                if np.isfinite(a) and np.isfinite(v):
                    worst = max(worst, abs(a - v))
                elif np.isfinite(a) != np.isfinite(v):
                    print(f"{name} {rec['spec']['tag']} {k}: finite "
                          f"{np.isfinite(a)} now, {np.isfinite(v)} then")
        old_leaves = dict(_metric_leaves(env["derived"]))
        for path, v in _metric_leaves(now["derived"]):
            if path in old_leaves and np.isfinite(v) and np.isfinite(
                    old_leaves[path]):
                worst = max(worst, abs(v - old_leaves[path]))
        claims = {k: c["ok"] for k, c in now["campaign"]["claims"].items()}
        print(f"{name}: max |reference - envelope| test error {worst} "
              f"({worst * 2048:.1f} of 2048 samples); schedule sides equal: "
              f"{same_schedule}; claims {claims}")
    return 0


def fig5_sensitivity(perturbations: int = 8) -> int:
    """How far one ulp moves ``fig5``'s records: each record at its default
    params on the CPU, then again from initial weights with one entry of
    ``w1`` or ``w2`` moved up or down by one ulp.  Prints each record's
    largest change of the final test error, in test samples — the basis of
    ``chip_smoke.py``'s ``CHAOTIC`` tolerance (a card's matmuls round
    differently from the CPU's)."""
    import torch

    from repro_torch.experiments.driver import run
    from repro_torch.experiments.problems import get_problem

    prob = get_problem("mlp_teacher")
    for spec in registry.cell_specs(registry.get_cell("fig5")):
        base = run(spec, device="cpu").metrics["test_error"]
        moved = []
        for i in range(perturbations):
            init = prob.init("cpu")
            flat = init["w1" if i % 2 == 0 else "w2"].view(-1)
            j = i // 4
            toward = torch.tensor(np.inf if i % 4 < 2 else -np.inf)
            flat[j] = torch.nextafter(flat[j], toward)
            moved.append(run(spec, device="cpu", init=init)
                         .metrics["test_error"])
        spread = max(abs(m - base) for m in moved) * 2048
        print(f"fig5 {spec.tag}: test error {base}; from {perturbations} "
              f"one-ulp changes {sorted(moved)}; largest change "
              f"{spread:.0f} of 2048 samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(fig5_sensitivity(16) or envelope_drift())
