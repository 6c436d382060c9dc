"""Elastic membership in the port's replay (ROADMAP.md item 4.4), against
the reference package.

Same spec and schedule (bitwise, test_torch_schedule.py), the reference's
initial weights carried across (``params_from_jax``): crash-restart
softsync and backup hardsync replay to the reference's parameters within
the tolerance policy of test_torch_replay.py (fp32: ``rtol=1e-5,
atol=2e-6``; bf16: half a bf16 ulp at the leaf's scale), with the
staleness block and runtime axis exactly equal.  Masked slots are inert
bit for bit (port against itself), and the grouped survivor weighting
folds exactly the gradients the trace's masks predict.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.core import schedule
from repro_torch.core.engine import replay, replay_batch
from repro_torch.experiments import ExperimentSpec as TSpec, run as t_run
from repro_torch.experiments import params_from_jax
from repro_torch.experiments.problems import MLPProblem
from repro_torch.membership import MembershipTimeline as TTimeline

STEPS = 24
HIDDEN = 16


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.config import RunConfig
    from repro.experiments import ExperimentSpec, run
    from repro.experiments.problems import get_problem
    from repro.membership import MembershipTimeline
    return types.SimpleNamespace(Run=RunConfig, Spec=ExperimentSpec, run=run,
                                 problem=get_problem,
                                 Timeline=MembershipTimeline)


def _close(ref, port, dtype):
    for k in ref:
        r, p = np.asarray(ref[k]), port[k].cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=2e-6)
        else:
            assert np.abs(r - p).max() <= 2.0 ** -8 * np.abs(r).max(), k


def _carried_init(R):
    prob = R.problem("mlp_teacher", (("hidden", HIDDEN),))
    return params_from_jax({k: np.asarray(v) for k, v in prob.init.items()},
                           "cpu")


@pytest.mark.parametrize("scenario,dtype", [
    ("crash_restart", "fp32"), ("crash_restart", "bf16"),
    ("backup_hardsync", "fp32")])
def test_elastic_replay_matches_reference(scenario, dtype, R):
    """Crash-restart 1-softsync (two of 8 learners down mid-run: masked
    coefficients per event) and backup-2 hardsync (each round folds the
    first 6 of 8 arrivals) through ``driver.run``, combine mode."""
    kw = dict(n_learners=8, minibatch=4, base_lr=0.05, optimizer="momentum",
              ring_dtype=dtype)
    if scenario == "crash_restart":
        kw.update(protocol="softsync", n_softsync=1)
        t_kw = dict(kw, membership=TTimeline.crash_restart([1, 2], 2.0, 3.0))
        r_kw = dict(kw, membership=R.Timeline.crash_restart([1, 2], 2.0,
                                                             3.0))
    else:
        kw.update(protocol="hardsync", backup=2)
        t_kw = r_kw = kw
    common = dict(problem="mlp_teacher", problem_args={"hidden": HIDDEN},
                  steps=STEPS, eval_every=12)
    ref = R.run(R.Spec(run=R.Run(**r_kw), **common))
    port = t_run(TSpec(run=TRun(**t_kw), **common), device="cpu",
                 init=_carried_init(R))
    if scenario == "crash_restart":
        assert not port.trace.valid.all()
    else:                      # each round commits the first P − b = 6
        assert port.trace.c == 6
    _close(ref.params, port.params, dtype)
    assert ref.staleness == port.staleness
    assert ref.runtime == port.runtime
    for r, p in zip(ref.curve, port.curve):
        assert r["update"] == p["update"] and r["time"] == p["time"]
        assert abs(r["test_error"] - p["test_error"]) <= 2 / 2048


@pytest.mark.parametrize("ring_impl", ["auto", "stock"])
def test_masked_slots_are_inert_in_replay(ring_impl):
    """Re-point every cancelled slot at another (learner, minibatch): the
    slot's gradient changes, its coefficient is 0, and the replay does not
    move by a single bit (0 × finite = 0 in the combine)."""
    cfg = TRun(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4,
               base_lr=0.05, optimizer="momentum", seed=3,
               ring_impl=ring_impl,
               membership=TTimeline.crash_restart([2, 5], 2.0, 3.0))
    tr = schedule(cfg, 25)
    assert tr.valid is not None and not tr.valid.all()
    prob = MLPProblem(hidden=HIDDEN)
    kw = dict(grad_fn=prob.grad_fn, init_params=prob.init("cpu"),
              batch_fn=prob.batch_fn_for(4), device="cpu")
    ref = replay(tr, cfg, **kw)
    learner2, mb2 = tr.learner.copy(), tr.mb_index.copy()
    learner2[~tr.valid] = 3
    mb2[~tr.valid] = 77
    alt = replay(dataclasses.replace(tr, learner=learner2, mb_index=mb2),
                 cfg, **kw)
    for k in ref.params:
        assert torch.equal(ref.params[k], alt.params[k]), k


def test_grouped_survivor_gradient_weighting_in_replay():
    """grad(p, b) = b and batch_fn(l, i) = const(l + 1): every event's
    folded gradient is predictable from the trace's member and slot masks
    (a group with a crashed member averages over its survivors)."""
    cfg = TRun(protocol="softsync", n_softsync=1, n_learners=4, groups=2,
               minibatch=4, base_lr=1.0, lr_policy="const", optimizer="sgd",
               seed=21, membership=TTimeline(((0.9, 1, "crash"),)))
    tr = schedule(cfg, 12)
    assert tr.member_valid is not None and not tr.member_valid.all()
    sim = replay(tr, cfg, grad_fn=lambda p, b: {"w": b},
                 init_params={"w": torch.zeros(3)},
                 batch_fn=lambda l, i: np.full(3, float(l + 1), np.float32),
                 device="cpu")
    members = tr.topology.members(4)[tr.learner]         # (steps, c, gs)
    folded = ((members + 1.0) * tr.member_coef()).sum(axis=2)
    expect = -(folded * tr.event_coef()).sum(axis=1).sum()
    np.testing.assert_allclose(sim.params["w"].numpy(), np.full(3, expect),
                               rtol=1e-5)


def test_replay_batch_rejects_mixed_elasticity():
    cfg_d = TRun(protocol="softsync", n_softsync=1, n_learners=8,
                 minibatch=4, seed=3)
    cfg_e = cfg_d.replace(membership=TTimeline.crash_restart([2], 2.0, 3.0))
    td, te = schedule(cfg_d, 20), schedule(cfg_e, 20)
    bf = lambda l, i: np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="elasticity"):
        replay_batch([td, te], [cfg_d, cfg_e], grad_fn=lambda p, b: {"w": b},
                     init_params={"w": torch.zeros(3)}, batch_fns=[bf, bf],
                     device="cpu")


def test_elastic_whatif_replay_matches_reference(R):
    """The what-if body reads the masked coefficients too: quadratic_whatif
    (d 4096) under crash-restart, through ``ring_apply_whatif``'s plain
    version, against the reference's own a and w* (fp32: within 4 ulps at
    the weights' scale, as test_torch_replay.py's what-if pin)."""
    kw = dict(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4,
              base_lr=0.1, optimizer="momentum")
    common = dict(problem="quadratic_whatif", problem_args={"d": 4096},
                  steps=STEPS)
    ref = R.run(R.Spec(run=R.Run(**kw, membership=R.Timeline.crash_restart(
        [1, 2], 2.0, 3.0)), **common))
    cfg = TRun(**kw, membership=TTimeline.crash_restart([1, 2], 2.0, 3.0))
    tr = schedule(cfg, STEPS)
    assert not tr.valid.all()
    jp = R.problem("quadratic_whatif", (("d", 4096),))
    flat_grad = ("quadratic", torch.tensor(np.asarray(jp.flat_grad[1])),
                 torch.tensor(np.asarray(jp.flat_grad[2])))
    sim = replay(tr, cfg, init_params={"w": torch.zeros(4096)},
                 flat_grad=flat_grad, device="cpu")
    r, p = np.asarray(ref.params["w"]), sim.params["w"].numpy()
    assert np.max(np.abs(r - p)) <= 4 * np.spacing(np.abs(r).max())
