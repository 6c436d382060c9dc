"""``Sweep``, ``run_sweep`` and ``replay_batch`` of the port (ROADMAP.md
items 5 and 4.6), against the reference package and against the port's
own sequential replay.

* ``Sweep`` expands to the reference's grid: the same spec echoes, in the
  same order, with the same tags.
* ``run_sweep``'s batched path (one (B, K, D) ring, one ``grad_fn`` call
  over B·c slots per event, one ring event per lane) against the port's
  sequential replay: within ``rtol=1e-5, atol=2e-6`` (the B·c gradients
  may sum in another order than c per lane).  On the CPU they come out
  bitwise, which the test reports but does not demand.  Against the
  reference's *sequential* replay (its batched-vs-sequential pin is red,
  ROADMAP.md §3): the tolerance policy of test_torch_replay.py.
* The fallback warning: one per sweep, naming the same reasons for the
  same specs as the reference's; ``replay_path`` on every record.
"""

import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.core import schedule
from repro_torch.core.engine import replay_batch
from repro_torch.experiments import ExperimentSpec as TSpec, Sweep as TSweep
from repro_torch.experiments import params_from_jax, run_sweep
from repro_torch.membership import MembershipTimeline as TTimeline
from repro_torch.serve.fleet import FleetConfig as TFleet

HIDDEN = 16


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.config import RunConfig
    from repro.experiments import ExperimentSpec, Sweep, run_sweep
    from repro.experiments.problems import get_problem
    from repro.membership import MembershipTimeline
    from repro.serve.fleet import FleetConfig
    return types.SimpleNamespace(Run=RunConfig, Spec=ExperimentSpec,
                                 Sweep=Sweep, run_sweep=run_sweep,
                                 problem=get_problem, Fleet=FleetConfig,
                                 Timeline=MembershipTimeline)


def _base(Run, Spec, steps=24, eval_every=12, **kw):
    run = dict(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4,
               base_lr=0.05, optimizer="momentum")
    run.update(kw)
    return Spec(run=Run(**run), problem="mlp_teacher",
                problem_args={"hidden": HIDDEN}, steps=steps,
                eval_every=eval_every)


def _grid(Sweep, base, Timeline):
    return Sweep.over(base, cases=[
        {"protocol": "softsync", "n_softsync": 2,
         "lr_policy": "staleness_inverse"},
        {"protocol": "async", "tag": "async"},
    ], membership=[Timeline(), Timeline.crash_restart([1], 2.0, 2.0)],
        seed=[0, 1])


def test_sweep_expansion_equals_reference(R):
    ref = _grid(R.Sweep, _base(R.Run, R.Spec), R.Timeline)
    port = _grid(TSweep, _base(TRun, TSpec), TTimeline)
    assert len(ref) == len(port) == 8
    for r, p in zip(ref.specs(), port.specs()):
        assert r.tag == p.tag
        assert r.echo() == p.echo()
    with pytest.raises(ValueError, match="unknown axis"):
        TSweep.over(_base(TRun, TSpec), nonsense=[1])


@pytest.mark.parametrize("run_kw", [
    dict(), dict(ring_dtype="bf16"), dict(optimizer="adagrad"),
    dict(lr_policy="per_gradient"),
    dict(membership=TTimeline.crash_restart([1, 2], 2.0, 3.0))])
def test_batched_sweep_matches_sequential_and_reference(run_kw, R):
    """Four lanes (2 seeds × 2 LRs) in one batch, against the port's
    sequential replay of each and against the reference's sequential
    replay on carried weights."""
    sweep = TSweep.over(_base(TRun, TSpec, **run_kw), seed=[0, 1],
                        base_lr=[0.05, 0.1])
    batched = run_sweep(sweep, device="cpu")
    sequential = run_sweep(sweep, batch=False, device="cpu")
    assert [r.runtime["replay_path"] for r in batched] == ["batched"] * 4
    assert [r.runtime["replay_path"]
            for r in sequential] == ["sequential"] * 4
    for b, s in zip(batched, sequential):
        for k in b.params:
            torch.testing.assert_close(b.params[k], s.params[k], rtol=1e-5,
                                       atol=2e-6)
        assert b.staleness == s.staleness and b.curve[0]["time"] == \
            s.curve[0]["time"]
    r_kw = dict(run_kw)
    if "membership" in r_kw:
        r_kw["membership"] = R.Timeline.crash_restart([1, 2], 2.0, 3.0)
    init = params_from_jax({k: np.asarray(v) for k, v in R.problem(
        "mlp_teacher", (("hidden", HIDDEN),)).init.items()}, "cpu")
    ref = R.run_sweep(R.Sweep.over(_base(R.Run, R.Spec, **r_kw),
                                   seed=[0, 1], base_lr=[0.05, 0.1]),
                      batch=False)
    from repro_torch.experiments.driver import _Job
    lanes = [_Job(i, s) for i, s in enumerate(sweep)]
    sims = replay_batch([j.trace for j in lanes], [j.spec.run for j in lanes],
                        grad_fn=lanes[0].problem.grad_fn, init_params=init,
                        batches=[j.staged_batches() for j in lanes],
                        device="cpu")
    for r, sim in zip(ref, sims):
        for k in r.params:
            want = np.asarray(r.params[k])
            if run_kw.get("ring_dtype") == "bf16":
                assert np.abs(sim.params[k].numpy() - want).max() <= \
                    2.0 ** -8 * np.abs(want).max()
            else:
                np.testing.assert_allclose(sim.params[k].numpy(), want,
                                           rtol=1e-5, atol=2e-6)


def _mixed(Run, Spec, Fleet, Timeline):
    """Two grid points that batch together, then one or two for every
    reason a grid point cannot batch (an elastic spec alone in its group
    replays sequentially too, without a warning), then measure and
    legacy."""
    base = _base(Run, Spec, steps=6, eval_every=0)

    def with_run(**kw):
        return base.replace(run=base.run.replace(**kw))
    return [base, with_run(seed=1),
            with_run(optimizer="adamw"), with_run(optimizer="adamw", seed=1),
            with_run(shards=2), with_run(groups=4),
            with_run(serving=Fleet(request_rate=2.0, request_samples=4)),
            with_run(membership=Timeline.crash_restart([1], 1.0, 1.0)),
            base.replace(problem=None, problem_args={}),
            base.replace(engine="legacy")]


def _warned(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        results = fn()
    return results, [str(w.message) for w in rec
                     if issubclass(w.category, RuntimeWarning)]


def test_fallback_warning_names_the_reference_specs(R):
    ref, ref_msgs = _warned(lambda: R.run_sweep(
        _mixed(R.Run, R.Spec, R.Fleet, R.Timeline)))
    port, msgs = _warned(lambda: run_sweep(
        _mixed(TRun, TSpec, TFleet, TTimeline), device="cpu"))
    assert len(ref_msgs) == len(msgs) == 1
    assert msgs == ref_msgs
    assert [r.runtime["replay_path"] for r in port] == \
        [r.runtime["replay_path"] for r in ref] == \
        ["batched", "batched"] + ["sequential"] * 6 + ["measure", "legacy"]
    for r, p in zip(ref, port):
        assert ({k: v for k, v in r.runtime.items() if k != "serving"}
                == {k: v for k, v in p.runtime.items() if k != "serving"})


def test_replay_batch_restrictions():
    cfg = TRun(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4)
    tr = schedule(cfg, 8)
    bf = lambda l, i: np.zeros(3, np.float32)
    kw = dict(grad_fn=lambda p, b: {"w": b},
              init_params={"w": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="share trace shape"):
        replay_batch([tr, schedule(cfg, 9)], [cfg, cfg], batch_fns=[bf, bf],
                     **kw)
    serve = cfg.replace(serving=TFleet(request_rate=2.0))
    with pytest.raises(ValueError, match="serving traces"):
        replay_batch([schedule(serve, 8)], [serve], batch_fns=[bf], **kw)
    with pytest.raises(ValueError, match="exactly one"):
        replay_batch([tr], [cfg], **kw)
