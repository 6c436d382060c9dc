"""The port's ``distributed`` cell (SPMD what-if replay throughput on a
mesh of ``torch.distributed`` ranks) at a tiny size on the CPU: one world
per shard count (1, 2 and 4 gloo ranks), through ``campaign.run_cell``.

Held against the reference's cell and committed envelope
(``benchmarks/results/distributed_replay.json``): both claims hold; the
``derived`` keys are the envelope's, plus ``card`` and ``ranks`` (the
card's ``nvidia-smi`` name and power limit — None on the CPU — and the
ranks behind each rate); the rate and ring-bytes rows are the envelope's;
the per-rank ring residency follows the reference's formula (K = 7 at the
envelope's D: 56 000 000 / S bytes).
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import json
from pathlib import Path

import pytest

from repro_torch.experiments import campaign, registry
from repro_torch.experiments.cells import distributed_replay as dr

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
TINY = {"updates": 8, "d": 4096, "repeats": 1}


@pytest.fixture(scope="module")
def cell_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    derived = campaign.run_cell("distributed", TINY, results_dir=str(tmp),
                                device="cpu")
    return derived, registry.load_envelope("distributed", str(tmp))


def test_claims_hold(cell_run):
    _, env = cell_run
    claims = env["campaign"]["claims"]
    assert set(claims) == {"emulated_mesh_has_8_devices",
                           "all_shard_counts_measured"}
    assert all(c["ok"] for c in claims.values())


def test_derived_keys_equal_the_envelope(cell_run):
    d, _ = cell_run
    ref = json.loads((RESULTS / "distributed_replay.json").read_text())
    want = ref["derived"]
    assert set(d) == set(want) | {"card", "ranks"}
    assert set(d["updates_per_s"]) == set(want["updates_per_s"])
    assert set(d["per_device_ring_bytes"]) == \
        set(want["per_device_ring_bytes"])
    assert d["devices"] == want["devices"] == dr.DEVICES
    assert d["card"] is None and d["ranks"] == {
        "spmd_s1": 1, "spmd_s2": 2, "spmd_s4": 4, "single_s4": 1}
    assert all(v > 0 for v in d["updates_per_s"].values())
    assert d["scaling_s4_over_s1"] == pytest.approx(
        d["updates_per_s"]["spmd_s4"] / d["updates_per_s"]["spmd_s1"])
    # K = 7 rows of the ⌈D/S⌉ slice, fp32: the reference's residency
    for s in dr.SHARDS:
        assert d["per_device_ring_bytes"][f"spmd_s{s}"] == \
            7 * -(-TINY["d"] // s) * 4
        assert want["per_device_ring_bytes"][f"spmd_s{s}"] == \
            7 * -(-want["d"] // s) * 4


def test_cell_matches_reference_registration():
    pytest.importorskip("jax")
    from repro.experiments import registry as r_registry
    cell, ref = registry.get_cell("distributed"), \
        r_registry.get_cell("distributed")
    assert (cell.result, cell.params, cell.quick_params, cell.campaigns) == \
        (ref.result, ref.params, ref.quick_params, ref.campaigns)
    assert [c.name for c in cell.claims] == [c.name for c in ref.claims]
