"""PS shards, learner groups, the stock body and adamw in the port's
replay (ROADMAP.md items 2, 4.5 and 4.2), against the reference package.

* ``shard_pack`` / ``shard_pack_grads`` / ``shard_unpack``: bitwise the
  reference's (pure layout).
* ``apply_event_sharded``: bitwise the port's ``apply_event_flat`` on the
  concatenated shards (the event is elementwise; one operation order).
* Sharded (S ∈ {2, 4}), grouped and sharded + grouped replays through
  ``driver.run`` against the reference's, on carried initial weights:
  final parameters ``rtol=1e-5, atol=2e-6``, the staleness block and the
  runtime axis exactly equal (test_torch_replay.py's policy).
* The trivial topology (S = 1, groups = λ ⇒ gs = 1) replays bitwise the
  default configuration.
* ``ring_impl="stock"`` against the fused body: the reference allows ~1
  ulp per event between them (its stock sharded body phrases the combine
  on (S, c, Dp) operands); the port sums one slot order in both, so they
  agree bitwise, which is what is held.
* adamw (the stock pytree body) against the reference.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import types

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.core import schedule
from repro_torch.core.engine import replay_batch
from repro_torch.experiments import ExperimentSpec as TSpec, run as t_run
from repro_torch.experiments import params_from_jax
from repro_torch.membership import MembershipTimeline as TTimeline
from repro_torch.optim import UpdateSpec, backends, flatten

STEPS = 24
HIDDEN = 16


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.config import RunConfig
    from repro.experiments import ExperimentSpec, run
    from repro.experiments.problems import get_problem
    from repro.membership import MembershipTimeline
    from repro.optim import flatten as rflat
    return types.SimpleNamespace(Run=RunConfig, Spec=ExperimentSpec, run=run,
                                 problem=get_problem, flatten=rflat,
                                 Timeline=MembershipTimeline)


def _kw(**run_kw):
    kw = dict(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4,
              base_lr=0.05, optimizer="momentum")
    kw.update(run_kw)
    return kw


COMMON = dict(problem="mlp_teacher", problem_args={"hidden": HIDDEN},
              steps=STEPS)


def _port(**run_kw):
    return t_run(TSpec(run=TRun(**_kw(**run_kw)), **COMMON), device="cpu")


def _against_reference(R, crash=None, **run_kw):
    """``crash``: the (learners, at, down) of a crash-restart membership,
    built with each package's own ``MembershipTimeline``."""
    r_kw, t_kw = _kw(**run_kw), _kw(**run_kw)
    if crash is not None:
        r_kw["membership"] = R.Timeline.crash_restart(*crash)
        t_kw["membership"] = TTimeline.crash_restart(*crash)
    ref = R.run(R.Spec(run=R.Run(**r_kw), **COMMON))
    prob = R.problem("mlp_teacher", (("hidden", HIDDEN),))
    init = params_from_jax({k: np.asarray(v) for k, v in prob.init.items()},
                           "cpu")
    port = t_run(TSpec(run=TRun(**t_kw), **COMMON), device="cpu",
                 init=init)
    for k in ref.params:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]), rtol=1e-5,
                                   atol=2e-6)
    assert ref.staleness == port.staleness
    assert ref.runtime == port.runtime
    return port


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("shards,dim", [(1, 10), (2, 11), (3, 11), (4, 37)])
def test_shard_pack_unpack_match_reference(shards, dim, R):
    rng = np.random.default_rng(shards)
    x = rng.normal(size=(3, dim)).astype(np.float32)
    width = -(-dim // shards)
    got = flatten.shard_pack(torch.tensor(x[0]), shards, width)
    want = np.asarray(R.flatten.shard_pack(x[0], shards, width))
    np.testing.assert_array_equal(got.numpy(), want)
    grads = flatten.shard_pack_grads(torch.tensor(x), shards, width)
    np.testing.assert_array_equal(
        grads.numpy(), np.asarray(R.flatten.shard_pack_grads(x, shards,
                                                              width)))
    np.testing.assert_array_equal(flatten.shard_unpack(got, dim).numpy(),
                                  x[0])


@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adagrad"])
def test_apply_event_sharded_matches_flat(opt, mode):
    """Per shard, the event is the shard slice of the unsharded event,
    bit for bit, padding included (the zeros stay zero)."""
    S, D, c = 3, 50, 4
    Dp = -(-D // S)
    rng = np.random.default_rng(7)
    w = torch.tensor(rng.normal(size=D).astype(np.float32))
    s = (None if opt == "sgd"
         else torch.tensor(rng.uniform(0.1, 1, D).astype(np.float32)))
    g = torch.tensor(rng.normal(size=(c, D)).astype(np.float32))
    coef = torch.full((c,), 1.0 / c)
    lrs = torch.tensor(rng.uniform(0.01, 0.1, c).astype(np.float32))
    spec = UpdateSpec(opt)
    w1, s1 = backends.apply_event_flat(spec, w, s, g, coef, lrs, mode)
    w2, s2 = backends.apply_event_sharded(
        spec, flatten.shard_pack(w, S, Dp),
        None if s is None else flatten.shard_pack(s, S, Dp),
        flatten.shard_pack_grads(g, S, Dp), coef, lrs, mode)
    assert torch.equal(flatten.shard_unpack(w2, D), w1)
    assert not w2.reshape(-1)[D:].any()
    if s is not None:
        assert torch.equal(flatten.shard_unpack(s2, D), s1)


@pytest.mark.parametrize("shards,opt", [(2, "sgd"), (2, "momentum"),
                                        (4, "sgd"), (4, "momentum")])
def test_sharded_replay_matches_reference(shards, opt, R):
    """Inconsistent per-shard reads (pull jitter 0.1): every slot's weights
    assembled from S rows at S timestamps, one ring event over S·Dp."""
    port = _against_reference(R, shards=shards, shard_pull_jitter=0.1,
                              optimizer=opt)
    sts = port.trace.shard_pulled_ts
    assert sts.shape[2] == shards and (sts != sts[:, :, :1]).any()


@pytest.mark.parametrize("run_kw", [
    dict(groups=4),                                       # gs = 2
    dict(groups=2, shards=2, shard_pull_jitter=0.1),      # gs = 4, S = 2
    dict(groups=4, crash=([1], 2.0, 3.0)),                # masked members
    dict(groups=4, shards=2, crash=([1], 2.0, 3.0))])
def test_grouped_replay_matches_reference(run_kw, R):
    """With a crashed member, its group folds the ``mcoef``-weighted sum
    of its survivors' gradients: the reference's weighting, not the
    port's own ``member_coef`` read back."""
    port = _against_reference(R, **run_kw)
    assert port.trace.group_size == 8 // run_kw["groups"]
    if "crash" in run_kw:
        mv = port.trace.member_valid
        assert mv is not None and not mv.all()


def test_trivial_topology_is_bitwise_the_default():
    """S = 1 and groups = λ (gs = 1) replay bit for bit as the default
    configuration: the same trace, the same body."""
    base = _port()
    assert _equal(base.params, _port(shards=1, groups=8).params)


@pytest.mark.parametrize("run_kw", [
    dict(), dict(shards=3, shard_pull_jitter=0.1),
    dict(groups=4, shards=2)])
def test_stock_body_matches_fused(run_kw):
    fused = _port(ring_impl="fused", **run_kw)
    stock = _port(ring_impl="stock", **run_kw)
    assert _equal(fused.params, stock.params)


def test_adamw_matches_reference(R):
    """adamw resolves to the stock pytree body (``apply_update_tree``)."""
    _against_reference(R, optimizer="adamw", base_lr=0.01)


def test_replay_batch_rejects_topology():
    cfg = TRun(**_kw(shards=2))
    tr = schedule(cfg, 8)
    bf = lambda l, i: np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="trivial"):
        replay_batch([tr, tr], [cfg, cfg], grad_fn=lambda p, b: {"w": b},
                     init_params={"w": torch.zeros(3)}, batch_fns=[bf, bf],
                     device="cpu")


def test_sharded_adamw_is_refused():
    cfg = TRun(**_kw(shards=2, optimizer="adamw"))
    with pytest.raises(ValueError, match="no sharded"):
        t_run(TSpec(run=cfg, **COMMON), device="cpu")


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_spec(**run_kw):
    """mlp_teacher at its defaults (D 2 762), 1-softsync λ 8."""
    return TSpec(run=TRun(**_kw(**run_kw)), problem="mlp_teacher",
                 steps=STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sharded_masked_run_on_card_equals_fused(dtype, cuda):
    """S = 4 with pull jitter and a crash-restart: every event one
    ``ring_apply`` launch over the padded width 4·691, bitwise the same
    run through the plain versions on the card."""
    from repro_torch.kernels import replay_ring
    from repro_torch.membership import MembershipTimeline
    spec = _card_spec(shards=4, shard_pull_jitter=0.1, ring_dtype=dtype,
                      membership=MembershipTimeline.crash_restart(
                          [1, 2], 2.0, 3.0))
    replay_ring.reset_launches()
    a = t_run(spec, device=cuda)
    assert replay_ring.launches == {"ring_apply": STEPS,
                                    "ring_apply_whatif": 0}
    assert not a.trace.valid.all()
    b = t_run(spec.replace(run=spec.run.replace(ring_impl="fused")),
              device=cuda)
    assert _equal(a.params, b.params)


@pytest.mark.cuda
def test_batched_sweep_on_card_equals_fused(cuda):
    """``replay_batch`` launches ``ring_apply`` once per lane and event, is
    bitwise its plain versions' batched run, and is the sequential replay
    within the tolerance policy (its difference printed)."""
    from repro_torch.experiments import Sweep, run_sweep
    from repro_torch.kernels import replay_ring
    spec = _card_spec()
    sweep = Sweep.over(spec, seed=[0, 1, 2])
    replay_ring.reset_launches()
    a = run_sweep(sweep, device=cuda)
    assert replay_ring.launches["ring_apply"] == 3 * STEPS
    b = run_sweep(Sweep.over(spec.replace(run=spec.run.replace(
        ring_impl="fused")), seed=[0, 1, 2]), device=cuda)
    for x, y in zip(a, b):
        assert x.runtime["replay_path"] == "batched"
        assert _equal(x.params, y.params)
    # against the sequential replay: the tolerance policy (the B·c
    # gradients are one cuBLAS call here, c per lane there)
    seq = run_sweep(sweep, batch=False, device=cuda)
    worst = max(float((x.params[k] - y.params[k]).abs().max())
                for x, y in zip(a, seq) for k in x.params)
    print(f"batched vs sequential on the card: max |diff| = {worst}")
    for x, y in zip(a, seq):
        for k in x.params:
            torch.testing.assert_close(x.params[k], y.params[k], rtol=1e-5,
                                       atol=2e-6)
