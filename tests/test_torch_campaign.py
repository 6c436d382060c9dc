"""The port's campaign layer (ROADMAP.md item 6): ``registry``,
``campaign``, ``validate``, ``smoke`` and the ``elastic``, ``serve`` and
``topology`` cells, against the reference package's.

Each cell runs at a tiny size (``epochs`` 0.05, 256 requests) through both
packages' ``run_cell`` on the CPU, each into its own temporary results
directory.  Held:

* records in the same order with the same tags; ``simulated_time``,
  ``updates``, ``minibatches``, the staleness block and the serving trace
  counts exactly the reference's (host numpy, bitwise schedules);
* ``replay_path`` record by record the reference's (the same fixed
  checkpoint slices, the same batch groups);
* the claims exactly the reference's, and every number of ``derived``
  exactly the reference's except those computed from the metrics (test
  error, serving accuracy, their spreads and noise bands): those within
  two of the 2 048 test samples (2/2048), the policy of
  test_torch_replay.py, and the timing of ``topology``'s engine
  overhead, which is a wall clock;
* ``validate`` accepts the port's envelopes, and their cell hashes differ
  from the reference's (a port envelope never passes as the reference's);
* the reference's committed envelopes of the three cells are CURRENT
  under the reference's own ``cell_status`` (what ``chip_smoke.py``'s
  phase 11 holds the card's records against).

The port's cells start from ``MLPProblem.init``, the reference's draw
reproduced in numpy (``data/threefry.py``): the random bits bitwise, the
normals within 3 ulps (measured: 2).
"""

import json
import math
import os
import shutil
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.data import threefry
from repro_torch.experiments import campaign, registry, smoke, validate
from repro_torch.experiments.problems import MLPProblem

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("elastic", "serve", "topology")
PARAMS = {"elastic": {"epochs": 0.05},
          "serve": {"epochs": 0.05, "requests": 256},
          "topology": {"epochs": 0.05}}
METRIC_TOL = 2 / 2048
# derived keys computed from the metrics (test error, serving accuracy)
METRIC_KEYS = ("test_error", "serving_accuracy", "test_errors", "noise_band",
               "curve")


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.experiments import campaign as r_campaign
    from repro.experiments import registry as r_registry
    return types.SimpleNamespace(campaign=r_campaign, registry=r_registry)


@pytest.fixture(scope="module")
def envelopes(R, tmp_path_factory):
    """name → (port envelope, reference envelope, port results dir)."""
    port_dir = tmp_path_factory.mktemp("results_torch")
    ref_dir = tmp_path_factory.mktemp("results_ref")
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for name in CELLS:
            campaign.run_cell(name, PARAMS[name], results_dir=str(port_dir),
                              device="cpu")
            R.campaign.run_cell(name, PARAMS[name], results_dir=str(ref_dir))
            out[name] = (registry.load_envelope(name, str(port_dir)),
                         R.registry.load_envelope(name, str(ref_dir)),
                         port_dir)
    return out


def _schedule_side(rec):
    side = {k: rec["runtime"][k]
            for k in ("simulated_time", "updates", "minibatches")}
    side["staleness"] = rec["staleness"]
    serving = rec["runtime"].get("serving")
    if serving is not None:
        side["serving"] = {k: serving[k] for k in (
            "n_requests", "n_served", "n_refreshes", "staleness_mean",
            "staleness_max")}
    return side


@pytest.mark.parametrize("name", CELLS)
def test_cell_records_match_reference(name, envelopes):
    port, ref, _ = envelopes[name]
    assert len(port["records"]) == len(ref["records"]) > 0
    for p, r in zip(port["records"], ref["records"]):
        assert p["spec"]["tag"] == r["spec"]["tag"]
        assert _schedule_side(p) == _schedule_side(r)
        assert p["runtime"]["replay_path"] == r["runtime"]["replay_path"]
        for k, v in r["metrics"].items():
            tol = METRIC_TOL if k in ("test_error", "serving_accuracy") \
                else 0.0
            assert abs(p["metrics"][k] - v) <= tol, (p["spec"]["tag"], k)
    if name == "topology":
        assert {p["runtime"]["replay_path"] for p in port["records"]} == {
            "measure"}


def _held(port, ref, path=()):
    """Every leaf of ``ref`` in ``port``: equal, or within METRIC_TOL
    below a metric key."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _held(port[k], ref[k], path + (k,))
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _held(a, b, path + (i,))
    elif isinstance(ref, float) and any(
            any(m in str(p) for m in METRIC_KEYS) for p in path):
        assert math.isclose(port, ref, abs_tol=METRIC_TOL), path
    else:
        assert port == ref, path


@pytest.mark.parametrize("name", CELLS)
def test_cell_derived_and_claims_match_reference(name, envelopes):
    port, ref, _ = envelopes[name]
    assert port["campaign"]["claims"] == ref["campaign"]["claims"]
    pd, rd = dict(port["derived"]), dict(ref["derived"])
    if name == "topology":          # a wall clock on each side
        p_over, r_over = pd.pop("engine_overhead_cell"), \
            rd.pop("engine_overhead_cell")
        assert p_over.keys() == r_over.keys() and p_over["updates"] == 40
        assert p_over["trivial_s"] > 0 and p_over["topology_s"] > 0
    _held(pd, rd)


def test_validate_accepts_port_envelopes(envelopes):
    port_dir = envelopes["elastic"][2]
    assert validate.validate_paths([str(port_dir)]) == len(CELLS)
    # owned by registered cells; STALE against the default params (the
    # envelopes were run at tiny ones), CURRENT at their own
    rows = validate.staleness_report([str(port_dir)])
    assert sorted(Path(p).stem for p, s, _ in rows if s == "STALE") == [
        "elastic_churn", "topology_scaling", "train_while_serve"]
    for name in CELLS:
        status, _ = campaign.cell_status(registry.get_cell(name),
                                         PARAMS[name],
                                         results_dir=str(port_dir))
        assert status == "CURRENT"
    assert validate.main([str(port_dir)]) == 0


def test_cell_hash_differs_from_reference(R, envelopes, tmp_path):
    for name in CELLS:
        port, ref, _ = envelopes[name]
        assert port["campaign"]["cell_hash"] != ref["campaign"]["cell_hash"]
        assert port["campaign"]["cell_hash"] == registry.cell_hash(
            registry.get_cell(name), PARAMS[name])
    # the reference's envelope in the port's results directory is STALE
    src = ROOT / "benchmarks" / "results" / "elastic_churn.json"
    shutil.copy(src, tmp_path / "elastic_churn.json")
    status, _ = campaign.cell_status(registry.get_cell("elastic"),
                                     results_dir=str(tmp_path))
    assert status == "STALE"


def test_reference_envelopes_are_current(R):
    """The committed card-side targets: the reference's own envelopes of
    the three cells, CURRENT at their default params."""
    results = str(ROOT / "benchmarks" / "results")
    for name in CELLS:
        status, detail = R.campaign.cell_status(R.registry.get_cell(name),
                                                results_dir=results)
        assert status == "CURRENT", (name, detail)


def test_results_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_RESULTS_DIR", raising=False)
    monkeypatch.setenv("REPRO_RESULTS_DIR", str(tmp_path / "ref"))
    assert registry.default_results_dir() == str(ROOT / "results_torch")
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path / "port"))
    assert registry.results_path(registry.get_cell("serve")) == str(
        tmp_path / "port" / "train_while_serve.json")
    names = [c.name for c in registry.cells_in("paper")]
    assert set(CELLS) <= set(names)
    # dependency-first: table3_4 folds the three cells' envelopes in
    assert max(names.index(n) for n in CELLS) < names.index("table3_4")


def test_mlp_init_reproduces_reference_draw(R):
    import jax
    from repro.experiments.problems import MLPProblem as RefMLP
    key = threefry.split(threefry.prng_key(0))[0]
    jkey = jax.random.split(jax.random.PRNGKey(0))[0]
    np.testing.assert_array_equal(
        threefry.random_bits(key, (7, 33)),
        np.asarray(jax.random.bits(jkey, (7, 33))))
    for hidden in (16, 64):
        ref = RefMLP(hidden=hidden).init
        got = MLPProblem(hidden=hidden).init("cpu")
        for k, v in ref.items():
            r = np.asarray(v)
            ulps = np.abs(got[k].numpy() - r) / np.spacing(
                np.maximum(np.abs(r), np.float32(1e-30)))
            assert ulps.max() <= 3, (hidden, k)


def test_campaign_cli_and_smoke_on_cpu(tmp_path):
    """The CLI with ``--device cpu`` (the topology cell at its default
    params: measure-mode records and the engine-overhead timing), then
    ``report`` and ``smoke --device cpu``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert campaign.main(["--only", "topology", "--device", "cpu",
                              "--results-dir", str(tmp_path), "--strict",
                              "--status-json", str(tmp_path / "s.json")]) == 0
        ledger = json.loads((tmp_path / "s.json").read_text())
        assert ledger["device"] == "cpu"
        assert ledger["cells"]["topology"]["action"] == "executed"
        assert campaign.main(["--only", "topology", "--device", "cpu",
                              "--results-dir", str(tmp_path),
                              "--status-json", str(tmp_path / "s.json")]) == 0
        ledger = json.loads((tmp_path / "s.json").read_text())
        assert ledger["cells"]["topology"]["action"] == "cached"
        assert smoke.main(["--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "topology_scaling.json")


def test_serve_throughput_probe_on_cpu():
    """``train_while_serve.measure``, the serving lane's throughput probe,
    at a tiny size: every request evaluated, a positive rate."""
    from repro_torch.experiments.cells import train_while_serve
    out = train_while_serve.measure(updates=8, requests=64, repeats=1,
                                    device="cpu")
    assert out["requests"] > 0 and out["requests_per_s"] > 0


def envelope_drift() -> int:
    """The metrics of the ``elastic`` and ``serve`` cells at their default
    params — the reference as it stands and the port on the CPU — against
    the reference's committed envelopes.  Prints each record and the
    largest differences (the basis of ``chip_smoke.py``'s
    ``ENVELOPE_TOL``); takes about half a minute, so it is not a test.
    Run: ``PYTHONPATH=src python tests/test_torch_campaign.py``."""
    from repro.experiments import registry as r_registry
    from repro.experiments.driver import run_sweep as r_sweep
    from repro_torch.experiments import run_sweep as t_sweep
    for name in ("elastic", "serve"):
        cell = r_registry.get_cell(name)
        env = json.loads((ROOT / "benchmarks" / "results"
                          / f"{cell.result}.json").read_text())
        by_tag = {r["spec"]["tag"]: r["metrics"] for r in env["records"]}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = r_sweep(r_registry.cell_specs(cell))
            port = t_sweep(registry.cell_specs(registry.get_cell(name)),
                           device="cpu")
        drift = {"reference - envelope": 0.0, "port - reference": 0.0}
        for r, p in zip(ref, port):
            for k, v in by_tag[r.tag].items():
                if k not in ("test_error", "serving_accuracy"):
                    continue
                print(f"{name} {r.tag} {k}: envelope {v} reference "
                      f"{r.metrics[k]} port {p.metrics[k]}")
                drift["reference - envelope"] = max(
                    drift["reference - envelope"], abs(r.metrics[k] - v))
                drift["port - reference"] = max(
                    drift["port - reference"],
                    abs(p.metrics[k] - r.metrics[k]))
        print(f"{name}: " + ", ".join(f"max |{k}| = {v}"
                                      for k, v in drift.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(envelope_drift())
