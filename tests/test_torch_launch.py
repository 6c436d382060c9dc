"""The port's launch tooling (``launch/mesh.py``'s production half,
``sharding.py``, ``specs.py``, ``roofline.py``, ``dryrun.py``,
``report.py``, ``dryrun_campaign.py``) against the reference's pure
functions.

The reference's dry-run tests are red (ROADMAP.md §3), so its compiled
numbers are no oracle; its pure functions are.  Its sharding functions read
a mesh's ``axis_names`` and ``devices.shape`` and wrap each spec in a
``NamedSharding``, which needs real devices: here they get a stand-in mesh
of those two attributes, and the ``NamedSharding`` (and ``_sds``) names of
their modules are swapped for functions that return the bare spec — the
reference's rules run unchanged.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import dryrun_campaign as jcamp
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import init_caches as jinit_caches
from repro.models import init_model as jinit_model
from repro_torch.config import INPUT_SHAPES, InputShape
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.experiments.spec_hash import content_hash
from repro_torch.launch import campaign, dryrun, dryrun_campaign, mesh
from repro_torch.launch import report, roofline, sharding, specs
from repro_torch.models import count_params

MESHES = {"16x16": False, "2x16x16": True}


class StandIn:
    """What the reference's sharding functions read of a mesh."""

    def __init__(self, m: mesh.AbstractMesh):
        self.axis_names = m.axis_names
        self.devices = np.empty(m.axis_sizes, dtype=object)


@pytest.fixture
def ref(monkeypatch):
    """The reference's sharding and specs modules, their specs bare."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jspecs, "_sds", lambda shape, dtype, m, spec: (
        tuple(shape), jnp.dtype(dtype), tuple(spec)))
    return jshd


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _jpaths(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _jtorch_dtype(dt):
    return {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.int32): torch.int32}[jnp.dtype(dt)]


def test_production_mesh_and_h100_constants():
    m = mesh.make_production_mesh()
    assert (m.axis_sizes, m.axis_names) == ((16, 16), ("data", "model"))
    mm = mesh.make_production_mesh(multi_pod=True)
    assert mm.axis_names == ("pod", "data", "model") and mm.name == "2x16x16"
    assert (mesh.n_chips(m), mesh.n_chips(mm)) == (256, 512)
    assert (mesh.n_learners(m), mesh.n_learners(mm)) == (16, 32)
    assert mesh.data_axes(mm) == ("pod", "data")
    assert mesh.make_debug_mesh(2, 4).shape == {"data": 2, "model": 4}
    # H100 SXM: dense bf16, HBM3, one 400 Gb/s NIC per GPU
    assert (mesh.PEAK_FLOPS, mesh.HBM_BW, mesh.ICI_BW) == (989e12, 3.35e12,
                                                           50e9)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_specs_equal_reference(arch, mesh_name, ref):
    """Every leaf's spec of the full-size config at the production axis
    sizes, the parallelism mode and FSDP, the batch and (decode) cache
    specs, and the micro-batch count."""
    m = mesh.make_production_mesh(multi_pod=MESHES[mesh_name])
    sm = StandIn(m)
    cfg, jcfg = get_config(arch), jget_config(arch)
    mode = sharding.parallelism_mode(cfg, 16)
    assert mode == ref.parallelism_mode(jcfg, 16)
    fsdp = sharding.needs_fsdp(cfg, m)
    assert fsdp == ref.needs_fsdp(jcfg, sm)
    wide = specs.fsdp_wide(cfg, m, fsdp, mode)
    jshapes = jax.eval_shape(functools.partial(jinit_model, jcfg),
                             jax.random.PRNGKey(0))
    want = _jpaths(ref.param_shardings(jshapes, sm, fsdp, mode=mode,
                                       fsdp_wide=wide))
    got = dict(_paths(specs.params_specs(cfg, m, fsdp)))
    assert set(got) == set(want)
    for path, s in got.items():
        assert tuple(s.spec) == tuple(want[path]), path
    for name, shape in INPUT_SHAPES.items():
        assert sharding.default_microbatches(cfg, shape) == \
            ref.default_microbatches(jcfg, JSHAPES[name])
        for B, S in ((shape.global_batch, shape.seq_len), (3, 5), (32, 17)):
            assert sharding.batch_spec_for(cfg, m, mode, B, S) == \
                ref.batch_spec_for(jcfg, sm, mode, B, S)
        if jspecs.validate_pairing(jcfg, JSHAPES[name]):
            continue
        jb = jspecs.batch_specs(jcfg, JSHAPES[name], sm)
        b = specs.batch_specs(cfg, shape, m)
        assert set(b) == set(jb)
        for k, s in b.items():
            assert (s.shape, tuple(s.spec)) == (jb[k][0], jb[k][2])
            assert s.dtype == _jtorch_dtype(jb[k][1])
    shape = INPUT_SHAPES["decode_32k"]
    if not jspecs.validate_pairing(jcfg, JSHAPES["decode_32k"]):
        jc = jax.eval_shape(functools.partial(
            jinit_caches, jcfg, shape.global_batch, shape.seq_len))
        want = _jpaths(ref.cache_shardings(jc, sm, shape.global_batch))
        got = dict(_paths(specs.cache_specs(cfg, shape, m)))
        assert set(got) == set(want)
        for path, s in got.items():
            assert tuple(s.spec) == tuple(want[path]), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_shapes_equal_eval_shape(arch):
    """The stand-ins of parameters, optimizer state and decode caches have
    the shapes and dtypes of ``jax.eval_shape`` of the reference's init
    and caches, and are meta tensors (nothing allocated)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    m = mesh.make_production_mesh()
    jshapes = dict(_paths(jax.eval_shape(
        functools.partial(jinit_model, jcfg), jax.random.PRNGKey(0))))
    p = specs.params_specs(cfg, m, sharding.needs_fsdp(cfg, m))
    got = dict(_paths(p))
    assert set(got) == set(jshapes)
    for path, s in got.items():
        assert s.value.device.type == "meta"
        assert s.shape == jshapes[path].shape, path
        assert s.dtype == _jtorch_dtype(jshapes[path].dtype), path
    run, _ = specs.make_run_config(cfg, INPUT_SHAPES["train_4k"], m)
    opt = dict(_paths(specs.opt_specs(run, p)))
    assert set(opt) == {f"velocity/{k}" for k in got}
    for path, s in opt.items():
        assert s.dtype == torch.float32
        assert s.spec == got[path.split("/", 1)[1]].spec
    shape = INPUT_SHAPES["decode_32k"]
    if cfg.encoder_only:
        return
    jc = dict(_paths(jax.eval_shape(functools.partial(
        jinit_caches, jcfg, shape.global_batch, shape.seq_len))))
    c = dict(_paths(specs.cache_specs(cfg, shape, m)))
    assert set(c) == set(jc)
    for path, s in c.items():
        assert s.shape == jc[path].shape, path
        assert s.dtype == _jtorch_dtype(jc[path].dtype), path


def _rows():
    """Synthetic dry-run rows of every kind the report reads."""
    rng = np.random.default_rng(0)
    rows = []
    for a in report.ARCH_ORDER[:4]:
        for s in report.SHAPE_ORDER:
            for m, kind in (("16x16", None), ("2x16x16", None),
                            ("16x16", "probe")):
                if a == "hubert_xlarge" and s == "decode_32k":
                    rows.append({"arch": a.replace("_", "-"), "shape": s,
                                 "mesh": m, "status": "skip",
                                 "reason": "encoder-only", "kind": kind})
                    continue
                r = {"arch": a, "shape": s, "mesh": m,
                     "status": "error" if (a, s) == ("rwkv6_7b", "train_4k")
                     and m == "2x16x16" else "ok",
                     "compile_s": float(rng.integers(1, 90)),
                     "bytes_per_device": int(rng.integers(1, 80)) * 2**30,
                     "num_microbatches": int(rng.integers(1, 9)),
                     "fsdp": bool(rng.integers(0, 2)),
                     "t_compute_s": float(rng.random()),
                     "t_memory_s": float(rng.random()),
                     "t_collective_s": float(rng.random()),
                     "dominant": str(rng.choice(["compute", "memory",
                                                 "collective"])),
                     "useful_ratio": float(rng.random()),
                     "model_flops": float(rng.random() * 1e18),
                     "coll_bytes_per_dev": float(rng.random() * 1e10)}
                if kind:
                    r["kind"] = kind
                rows.append(r)
    return rows


def test_report_tables_equal_reference(tmp_path):
    rows = _rows()
    for i in range(0, len(rows), 5):
        (tmp_path / f"job{i}.json").write_text(json.dumps(rows[i:i + 5]))
    got, want = report.load(str(tmp_path)), jreport.load(str(tmp_path))
    assert got == want
    assert report.dryrun_table(got) == jreport.dryrun_table(want)
    assert report.roofline_table(got) == jreport.roofline_table(want)
    assert report.summary_stats(got) == jreport.summary_stats(want)
    assert report.ARCH_ORDER == jreport.ARCH_ORDER == ARCH_IDS
    assert report.SHAPE_ORDER == jreport.SHAPE_ORDER


def test_campaign_jobs_equal_reference_but_their_hash():
    assert dryrun_campaign.ARCHS == jcamp.ARCHS
    assert dryrun_campaign.SHAPES == jcamp.SHAPES
    assert campaign.job_hash is dryrun_campaign.job_hash
    assert dryrun_campaign.OUT_DIR.endswith("results_torch/dryrun")
    for arch in ARCH_IDS[:3]:
        for mode, multi in (("main", False), ("main", True),
                            ("probe", False)):
            args = (arch, "train_4k", mode, multi)
            assert dryrun_campaign.job_id(*args) == jcamp.job_id(*args)
            assert dryrun_campaign.job_spec(*args) == jcamp.job_spec(*args)
            h = dryrun_campaign.job_hash(*args)
            assert h != jcamp.job_hash(*args)
            assert h == content_hash({"backend": "torch",
                                      "job": jcamp.job_spec(*args)})


def test_campaign_stamps_every_row(tmp_path):
    path = tmp_path / "job.json"
    path.write_text(json.dumps([{"arch": "a", "status": "ok"}]))
    args = ("qwen2_1_5b", "prefill_32k", "main", False)
    want = dryrun_campaign.job_hash(*args)
    assert not dryrun_campaign._is_cached(str(path), want)
    dryrun_campaign._stamp(str(path), *args)
    assert dryrun_campaign._is_cached(str(path), want)
    assert json.loads(path.read_text())[0]["campaign"]["job_hash"] == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in INPUT_SHAPES:
        assert roofline.model_flops(cfg, INPUT_SHAPES[name]) == \
            jrl.model_flops(jcfg, JSHAPES[name])


def test_roofline_terms_under_each_packages_constants():
    """The same costs give each package's terms under its own chip's
    constants; ratios and the bound term's name follow."""
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=3e13,
              hlo_bytes=2e11, coll_bytes=1e9, model_flops=5e15)
    got, want = roofline.Roofline(**kw), jrl.Roofline(**kw)
    assert got.t_compute == 3e13 / 989e12 and want.t_compute == 3e13 / 197e12
    assert got.t_memory == 2e11 / 3.35e12 and want.t_memory == 2e11 / 819e9
    assert got.t_collective == want.t_collective == 1e9 / 50e9
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.dominant == "memory" and want.dominant == "memory"
    assert set(got.row()) == set(want.row())
    for cost in (None, {"flops": 2.0}, [{"flops": 1.0}, {"flops": 2.0,
                                                         "x": 1.0}]):
        assert roofline.normalize_cost_analysis(cost) == \
            jrl.normalize_cost_analysis(cost)
    assert roofline.ring_bytes(3, 1000, "bf16") == jrl.ring_bytes(3, 1000,
                                                                  "bf16")


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_equal_reference(kind):
    for group in (1, 2, 16, 256):
        assert roofline._wire_bytes(kind, 1 << 20, group) == \
            jrl._wire_bytes(kind, 1 << 20, group)
    c = [roofline.Collective(kind, 1000, 16, 3),
         roofline.Collective(kind, 5000, 1)]        # one device: no wire
    tot = roofline.collective_bytes(c)
    assert tot[kind] == tot["total"] == 3 * jrl._wire_bytes(kind, 1000, 16)


def test_dryrun_one_allocates_no_real_tensor(monkeypatch):
    """One (arch × shape) pair at the production mesh and one 1 × 1 pair:
    every tensor made along the way is a meta tensor but for a few tiny
    host tables (RoPE frequencies), the parameter bytes on one device are
    ``count_params`` × 2 (bf16), and a 1 × 1 mesh has no collectives."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Real(TorchDispatchMode):
        nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    Real.nbytes += t.numel() * t.element_size()
            return out

    with Real():
        row = dryrun.dryrun_one("qwen3-14b", "decode_32k", verbose=False)
        cfg = get_smoke("llama4_maverick_400b_a17b")
        one = dryrun.dryrun_one(
            "llama4-smoke", "prefill", verbose=False, cfg=cfg,
            shape=InputShape("prefill_64", 64, 2, "prefill"),
            mesh=mesh.make_debug_mesh(1, 1))
    assert Real.nbytes < 1 << 16
    assert row["status"] == "ok" and row["hlo_flops_per_dev"] > 0
    assert row["coll_bytes_per_dev"] > 0 and row["mesh"] == "16x16"
    # bf16 leaves, and the MoE router in fp32 (two more bytes each)
    tree = specs.values(specs.params_specs(cfg, mesh.make_debug_mesh(1, 1),
                                           False))
    router = tree["units"]["block_1"]["moe"]["w_router"].numel()
    assert one["param_bytes"] == count_params(tree) * 2 + router * 2
    assert one["arg_bytes"] == one["param_bytes"] + 2 * 64 * 4
    assert one["coll_bytes_per_dev"] == 0
    assert one["hlo_flops_per_dev"] >= roofline.model_flops(
        cfg, InputShape("p", 64, 2, "prefill")) * 0.5


def test_dryrun_main_prints_its_rows(capsys):
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape",
                        "decode_32k"]) == 0
    out = capsys.readouterr().out
    rows = json.loads(out.strip().splitlines()[0])
    assert rows[0]["status"] == "skip"
    assert "0 ok / 1 skip / 0 error" in out
