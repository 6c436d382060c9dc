"""SPMD replay of the port (DESIGN.md §13) on ``torch.distributed`` ranks,
against the single placement and the reference package.

``placement="spmd"`` runs the replay on a mesh of gloo ranks, each a
process spawned with the ``spawn`` start method (``launch/mesh.py``).  On
the CPU the ranks run the kernels' plain versions.  Held, as DESIGN.md §13
states:

* ``placement_plan`` ≡ the reference's, bitwise (host-side);
* what-if spmd ≡ single **bitwise** at S = 1, 2 and 4 (closed-form
  gradients are shard-local; at S > 1 the single placement's staged
  sharded body forms the same gⱼ = a·(w − w*) and sums them in the same
  slot order);
* ``spmd_assembly="ppermute"`` ≡ ``"all_gather"`` **bitwise** (data
  movement only);
* the staged bodies (combine, sequential, learner groups, elastic masks,
  the bf16 ring, the kernel wrappers) within ``atol`` 1e-5 of single:
  with L > 1 learner ranks the combine's partial sums reorder the fp32
  reduction;
* at 1×1, the port's spmd replay against the reference's (one jax
  device) within the tolerances of ``test_torch_replay.py``: staged
  ``atol`` 1e-5 on carried initial weights, what-if within 4 ulps of the
  largest weight on the reference's own a and w*.

The equivalence cases run in ONE world of four ranks per module (the
``world`` fixture calls ``replay`` inside the ranks, as the ``distributed``
cell does); the spawn path that ``replay`` takes from an ordinary process
runs once (at 1×1, against the reference), and ``shard_map``'s failure
modes once each.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import types

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig
from repro_torch.core import replay
from repro_torch.core.engine import replay_batch
from repro_torch.core.trace import PlacementPlan, placement_plan, \
    schedule_cached
from repro_torch.experiments.problems import MLPProblem, QuadraticProblem
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.membership import MembershipTimeline

WORLD = 4
ATOL = 1e-5
HIDDEN = 8
CHURN = MembershipTimeline(((2.0, 0, "crash"), (3.5, 0, "join"),
                            (4.0, 1, "leave")))


def _cfg(**kw):
    base = dict(protocol="softsync", n_softsync=4, n_learners=16,
                minibatch=8, base_lr=0.05, lr_policy="staleness_inverse",
                optimizer="momentum", seed=7)
    base.update(kw)
    return RunConfig(**base)


# name → (RunConfig overrides, what-if?, replay kwargs); c = 4 slots
CASES = {
    "combine_1x1": (dict(placement="spmd", spmd_learners=1), False, {}),
    "combine_1x4": (dict(), False, {}),
    "sequential_1x1": (dict(placement="spmd", spmd_learners=1,
                            lr_policy="per_gradient"), False, {}),
    "sharded_2x2": (dict(shards=2), False, {}),
    "sharded_4x1": (dict(shards=4), False, {}),
    "explicit_2x2": (dict(shards=2, placement="spmd", spmd_learners=2),
                     False, {}),
    "sequential_2x2": (dict(shards=2, lr_policy="per_gradient"), False, {}),
    "groups": (dict(n_softsync=2, groups=8), False, {}),
    "elastic_masked": (dict(n_softsync=2, n_learners=8, shards=2,
                            membership=CHURN), False, {}),
    "bf16_ring": (dict(shards=4, ring_dtype="bf16"), False, {}),
    "kernel_ring": (dict(shards=4, ring_impl="pallas"), False, {}),
    "eval_history": (dict(), False, {"eval_every": 5}),
    "ppermute_s2": (dict(shards=2), False, {"spmd_assembly": "ppermute"}),
    "ppermute_s4": (dict(shards=4), False,
                    {"spmd_assembly": "ppermute"}),
    "whatif_s1": (dict(), True, {}),
    "whatif_s2": (dict(shards=2), True, {}),
    "whatif_s4": (dict(shards=4), True, {}),
    "whatif_s4_bf16": (dict(shards=4, ring_dtype="bf16",
                            ring_impl="pallas"), True, {}),
}
STAGED = [n for n, (_, w, kw) in CASES.items()
          if not w and "spmd_assembly" not in kw]


def _staged(prob, trace, mu):
    """The trace's minibatches as ``driver`` stages them ((steps, c, gs)
    member counters with learner groups)."""
    members = trace.member_learners()
    if members is None:
        return prob.stage_minibatches(trace.learner, trace.mb_index, mu)
    mb = np.broadcast_to(trace.mb_index[:, :, None], members.shape)
    return prob.stage_minibatches(members, mb, mu)


def _run_case(name: str, placement: str, steps: int = 24):
    kw, whatif, extra = CASES[name]
    cfg = _cfg(**kw)
    trace = schedule_cached(cfg, steps)
    prob = (QuadraticProblem(d=64, seed=3) if whatif
            else MLPProblem(hidden=HIDDEN))
    common = dict(grad_fn=prob.grad_fn, init_params=prob.init("cpu"),
                  batches=_staged(prob, trace, cfg.minibatch), device="cpu")
    if whatif:
        common["flat_grad"] = prob.flat_grad("cpu")
    if "eval_every" in extra:
        common.update(eval_fn=prob.eval_fn, eval_every=extra["eval_every"])
    if placement == "spmd" and "spmd_assembly" in extra:
        common["spmd_assembly"] = extra["spmd_assembly"]
    return replay(trace, cfg, placement=placement, **common)


def _world_cases(names):
    """Every rank replays every case (rank 0 gets the results)."""
    return {name: _run_case(name, "spmd") for name in names}


@pytest.fixture(scope="module")
def world():
    """name → (spmd result, single result), the spmd results from one
    world of four ranks."""
    mesh_lib.ensure_host_devices(WORLD)
    spmd = mesh_lib.shard_map(_world_cases, WORLD, list(CASES))
    return {n: (spmd[n], _run_case(n, "single")) for n in CASES}


def _max_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


# ---------------------------------------------------------------------------
# equivalence on the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STAGED)
def test_staged_spmd_matches_single(name, world):
    spmd, single = world[name]
    assert _max_diff(spmd.params, single.params) <= ATOL
    assert spmd.updates == single.updates
    assert spmd.simulated_time == single.simulated_time
    assert spmd.minibatches == single.minibatches


@pytest.mark.parametrize("name", ["whatif_s1", "whatif_s2", "whatif_s4",
                                  "whatif_s4_bf16"])
def test_whatif_spmd_bitwise_single(name, world):
    spmd, single = world[name]
    assert torch.equal(spmd.params["w"], single.params["w"])


@pytest.mark.parametrize("shards", [2, 4])
def test_ppermute_assembly_bitwise_all_gather(shards, world):
    pp, _ = world[f"ppermute_s{shards}"]
    ag, _ = world["sharded_2x2" if shards == 2 else "sharded_4x1"]
    for k in ag.params:
        assert torch.equal(pp.params[k], ag.params[k])


def test_eval_history_matches_single(world):
    spmd, single = world["eval_history"]
    assert [h["update"] for h in spmd.history] == [5, 10, 15, 20]
    for a, b in zip(spmd.history, single.history):
        assert a["update"] == b["update"] and a["time"] == b["time"]
        assert abs(a["test_error"] - b["test_error"]) <= 2 / 2048


def test_elastic_case_is_masked():
    trace = schedule_cached(_cfg(**CASES["elastic_masked"][0]), 24)
    assert trace.valid is not None and trace.mode == "combine"


# ---------------------------------------------------------------------------
# against the reference at 1×1 (its one jax device)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def R():
    jax = pytest.importorskip("jax")
    from repro.config import RunConfig as RRun
    from repro.core import replay as r_replay
    from repro.core.trace import placement_plan as r_placement_plan
    from repro.core.trace import schedule_cached as r_schedule_cached
    from repro.experiments.problems import get_problem
    return types.SimpleNamespace(jax=jax, Run=RRun, replay=r_replay,
                                 plan=r_placement_plan,
                                 schedule=r_schedule_cached,
                                 problem=get_problem)


def test_spmd_1x1_matches_reference_staged(R):
    """mlp_teacher(hidden=8) on the reference's initial weights through the
    spawn path ``replay`` takes from an ordinary process (a world of one
    rank), against the reference's spmd replay; the rank's launches come
    back as this process's (none on the CPU: the plain versions)."""
    from repro_torch.experiments import params_from_jax
    from repro_torch.kernels import replay_ring
    rcfg = R.Run(protocol="softsync", n_softsync=4, n_learners=16,
                 minibatch=8, base_lr=0.05, lr_policy="staleness_inverse",
                 optimizer="momentum", seed=7)
    jp = R.problem("mlp_teacher", (("hidden", HIDDEN),))
    rtrace = R.schedule(rcfg, 24)
    ref = R.replay(rtrace, rcfg, placement="spmd", grad_fn=jp.grad_fn,
                   init_params=jp.init,
                   batch_fn=jp.batch_fn_for(rcfg.minibatch))
    assert R.plan(rtrace, rcfg, R.jax.device_count()).devices == 1
    cfg = _cfg(placement="spmd", spmd_learners=1)
    trace = schedule_cached(cfg, 24)
    prob = MLPProblem(hidden=HIDDEN)
    init = params_from_jax({k: np.asarray(v) for k, v in jp.init.items()},
                           "cpu")
    port = replay(trace, cfg, grad_fn=prob.grad_fn, init_params=init,
                  batch_fn=prob.batch_fn_for(cfg.minibatch), device="cpu")
    assert replay_ring.rank_launches == [
        {"ring_apply": 0, "ring_apply_whatif": 0}]
    for k in ref.params:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]), atol=ATOL,
                                   rtol=0)


def test_spmd_1x1_matches_reference_whatif(R, world):
    """The world's what-if replay at 1×1 against the reference's spmd
    replay fed the port's a and w*: within 4 ulps of the largest weight
    (the reference contracts its update with FMAs)."""
    jnp = R.jax.numpy
    kw = dict(protocol="softsync", n_softsync=4, n_learners=16, minibatch=8,
              base_lr=0.05, lr_policy="staleness_inverse",
              optimizer="momentum", seed=7)
    rcfg = R.Run(**kw)
    _, a, wstar = QuadraticProblem(d=64, seed=3).flat_grad("cpu")
    jq = R.problem("quadratic_whatif", (("d", 64),))
    ref = R.replay(R.schedule(rcfg, 24), rcfg, placement="spmd",
                   grad_fn=jq.grad_fn, init_params={"w": jnp.zeros(64)},
                   batch_fn=jq.batch_fn_for(rcfg.minibatch),
                   flat_grad=("quadratic", jnp.asarray(a.numpy()),
                              jnp.asarray(wstar.numpy())))
    r = np.asarray(ref.params["w"])
    p = world["whatif_s1"][0].params["w"].numpy()
    assert np.max(np.abs(r - p)) <= 4 * np.spacing(np.abs(r).max())


PLAN_GRID = [(s, l) for s in (1, 2, 4) for l in (0, 1, 2, 4)]


@pytest.mark.parametrize("shards,learners", PLAN_GRID)
def test_placement_plan_equals_reference(shards, learners, R):
    """Every (S, L, device count) of the reference's own pins and around
    them: the same plan, or the same exception type."""
    kw = dict(protocol="softsync", n_softsync=4, n_learners=16,
              minibatch=8, seed=7, shards=shards,
              placement="spmd" if learners else "single",
              spmd_learners=learners)
    cfg, rcfg = RunConfig(**kw), R.Run(**kw)
    trace, rtrace = schedule_cached(cfg, 12), R.schedule(rcfg, 12)
    for devices in (1, 2, 3, 4, 8):
        try:
            want = R.plan(rtrace, rcfg, devices)
        except (RuntimeError, ValueError) as e:
            with pytest.raises(type(e)):
                placement_plan(trace, cfg, devices)
            continue
        got = placement_plan(trace, cfg, devices)
        assert (got.shards, got.learners, got.c, got.devices,
                got.slot_block, got.describe()) == (
            want.shards, want.learners, want.c, want.devices,
            want.slot_block, want.describe())


def test_placement_plan_pins():
    """The reference's own pins (tests/test_spmd.py)."""
    cfg = _cfg(shards=4)
    trace = schedule_cached(cfg, 12)
    plan = placement_plan(trace, cfg, device_count=8)
    assert (plan.shards, plan.learners) == (4, 2)
    assert plan.devices == 8 and plan.slot_block == 2
    assert placement_plan(trace, cfg, device_count=4).learners == 1
    with pytest.raises(RuntimeError, match="ensure_host_devices"):
        placement_plan(trace, cfg, device_count=2)
    assert PlacementPlan(2, 2, 4).describe() == \
        "spmd[2ps×2learner] slot_block=2"


def test_sharding_specs_equal_reference(R):
    from jax.sharding import PartitionSpec
    from repro.launch import sharding as r_sharding
    assert [tuple(p) for p in sharding.spmd_carry_specs()] == \
        [tuple(p) for p in r_sharding.spmd_carry_specs()]
    assert [tuple(p) for p in sharding.spmd_aux_specs()] == \
        [tuple(p) for p in r_sharding.spmd_aux_specs()]
    ours = sharding.spmd_xs_specs(["idx", "lrs", "sts", "coef", "batch"])
    theirs = r_sharding.spmd_xs_specs(["prev", "lrs", "ts", "coef",
                                       "batch"])
    # the port's per-shard pulled-row matrix is "sts"; the reference's "ts"
    assert tuple(ours["sts"]) == tuple(theirs["ts"]) == (None, None, "ps")
    assert tuple(ours["batch"]) == tuple(theirs["batch"])
    for k in ("idx", "lrs", "coef"):
        assert tuple(ours[k]) == () == tuple(PartitionSpec())


# ---------------------------------------------------------------------------
# the mesh layer
# ---------------------------------------------------------------------------
def test_local_block_cuts_each_ranks_block():
    x = np.arange(4 * 6).reshape(4, 6)
    for rank in range(4):
        m = mesh_lib.SimMesh((2, 2), rank, (), ())
        s, l = divmod(rank, 2)
        assert m.axis_index("ps") == s and m.axis_index("learner") == l
        np.testing.assert_array_equal(
            sharding.local_block(x, sharding.P("ps"), m), x[2 * s:2 * s + 2])
        np.testing.assert_array_equal(
            sharding.local_block((x, x), sharding.P(None, "learner"), m)[1],
            x[:, 3 * l:3 * l + 3])
        np.testing.assert_array_equal(sharding.local_block(x, sharding.P(),
                                                           m), x)
    assert not mesh_lib.SimMesh((1, 2), 2, (), ()).active
    with pytest.raises(ValueError, match="split"):
        sharding.local_block(np.zeros(3), sharding.P("ps"),
                             mesh_lib.SimMesh((2, 1), 0, (), ()))


def test_ensure_host_devices():
    with pytest.raises(ValueError, match="at least 1"):
        mesh_lib.ensure_host_devices(0)
    have = mesh_lib.ensure_host_devices(2)
    assert have >= 2 and mesh_lib.ensure_host_devices(1) == have
    assert not mesh_lib.in_world()
    with pytest.raises(RuntimeError, match="inside a world"):
        mesh_lib.make_sim_mesh(1, 1)
    with pytest.raises(RuntimeError, match="ensure_host_devices"):
        mesh_lib.make_sim_mesh(have + 1, 1)


def test_refusals():
    cfg = _cfg()
    trace = schedule_cached(cfg, 8)
    prob = MLPProblem(hidden=HIDDEN)
    kw = dict(grad_fn=prob.grad_fn, init_params=prob.init("cpu"),
              batch_fn=prob.batch_fn_for(8), device="cpu")
    with pytest.raises(ValueError, match="placement"):
        replay(trace, cfg, placement="multihost", **kw)
    with pytest.raises(ValueError, match="spmd_assembly"):
        replay(trace, cfg, placement="spmd", spmd_assembly="bogus", **kw)
    with pytest.raises(ValueError, match="kernel-supported"):
        replay(trace, cfg.replace(optimizer="adamw"), placement="spmd",
               **kw)
    with pytest.raises(ValueError, match="single-placement"):
        replay_batch([trace], [cfg.replace(placement="spmd")],
                     grad_fn=prob.grad_fn, init_params=prob.init("cpu"),
                     batch_fns=[prob.batch_fn_for(8)], device="cpu")


def _raise_on_rank_1():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("boom on rank 1")
    dist.barrier()


def _sleep():
    import time
    time.sleep(60)


def test_shard_map_carries_a_ranks_failure_and_times_out():
    """The first failure's traceback, rank 1's, leads the error (rank 0's
    barrier fails after it); a world past its limit is killed."""
    mesh_lib.ensure_host_devices(2)
    with pytest.raises(RuntimeError, match="^rank 1 failed:") as err:
        mesh_lib.shard_map(_raise_on_rank_1, 2)
    assert "RuntimeError: boom on rank 1" in str(err.value)
    with pytest.raises(TimeoutError, match="limit"):
        mesh_lib.shard_map(_sleep, 1, timeout=2.0)
