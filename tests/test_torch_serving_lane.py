"""The serving lane of the port's replay (ROADMAP.md item 4.5), against
the reference package and against itself.

* ``MLPProblem.stage_requests``: bitwise the reference's draw.
* Published rows: every served request sees bit for bit the weights a
  replay of the trace's first v events leaves (version v); with a bf16
  ring, those weights rounded through bf16 (the quantized row, residue
  excluded).
* Serving leaves training bitwise unchanged, whatever the body.
* ``request_metric``: per request equal to the reference's, except where
  a sample's top-two logits are within 1e-5 (fp32 products in another
  order may flip that argmax): there within one sample of the request.
* A serving run end to end: the serving summary exactly the reference's
  (it comes off the bitwise schedule), the metrics within the policy of
  test_torch_replay.py (test error within two of the 2 048 test samples).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.core import schedule
from repro_torch.core.engine import replay
from repro_torch.experiments import ExperimentSpec as TSpec, run as t_run
from repro_torch.experiments import params_from_jax
from repro_torch.experiments.problems import MLPProblem
from repro_torch.membership import MembershipTimeline as TTimeline
from repro_torch.serve.fleet import FleetConfig as TFleet, ServingResult
from repro_torch.serve.publication import PublicationPolicy as TPolicy

HIDDEN = 16


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import jax
    from repro.config import RunConfig
    from repro.experiments import ExperimentSpec, run
    from repro.experiments.problems import get_problem
    from repro.serve.fleet import FleetConfig
    from repro.serve.publication import PublicationPolicy
    return types.SimpleNamespace(jax=jax, Run=RunConfig, Spec=ExperimentSpec,
                                 run=run, problem=get_problem,
                                 Fleet=FleetConfig, Policy=PublicationPolicy)


@pytest.fixture(scope="module")
def prob():
    return MLPProblem(hidden=HIDDEN)


def _kw(**kw):
    base = dict(protocol="softsync", n_learners=4, n_softsync=2,
                minibatch=8, lr_policy="staleness_inverse",
                optimizer="momentum")
    base.update(kw)
    return base


def _fleet(Fleet, Policy, policy=None, **kw):
    return Fleet(replicas=2, policy=policy or Policy(), request_rate=2.0,
                 request_samples=8, **kw)


def _replay(trace, cfg, prob, **kw):
    serve = {}
    if trace.serving is not None:
        serve = dict(serve_batches=prob.stage_requests(trace.serving,
                                                       cfg.serving),
                     serve_eval_fn=prob.request_metric)
    serve.update(kw)
    return replay(trace, cfg, grad_fn=prob.grad_fn,
                  init_params=prob.init("cpu"),
                  batch_fn=prob.batch_fn_for(cfg.minibatch), device="cpu",
                  **serve)


def test_stage_requests_bitwise(R, prob):
    ref_prob = R.problem("mlp_teacher", (("hidden", HIDDEN),))
    kw = _kw(serving=_fleet(R.Fleet, R.Policy))
    from repro.core.trace import schedule as r_schedule
    r_trace = r_schedule(R.Run(**kw), 24)
    t_cfg = TRun(**_kw(serving=_fleet(TFleet, TPolicy)))
    t_trace = schedule(t_cfg, 24)
    for seed in (0, 5):
        want = ref_prob.stage_requests(r_trace.serving, kw["serving"],
                                       seed=seed)
        got = prob.stage_requests(t_trace.serving, t_cfg.serving, seed=seed)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_published_rows_bitwise_equal_replayed_weights(dtype, prob):
    """Every request's row is the weights after its version's prefix of
    events — a raw weight component exported through serve_eval_fn."""
    cfg = TRun(**_kw(protocol="async", ring_dtype=dtype,
                     serving=_fleet(TFleet, TPolicy,
                                    TPolicy(kind="every_n", every=1))))
    trace = schedule(cfg, 10)
    sv = trace.serving
    assert sv.n_requests > 0
    sim = _replay(trace, cfg, prob,
                  serve_eval_fn=lambda p, b: p["w1"][:, 0, 0])
    got = sim.serving.request_metric
    bare = cfg.replace(serving=None)
    first = prob.init("cpu")["w1"][0, 0]
    by_version = {0: first}
    for i in np.flatnonzero(sv.served):
        v = int(sv.version[i])
        if v not in by_version:
            prefix = schedule(bare, v)
            np.testing.assert_array_equal(prefix.pulled_ts,
                                          trace.pulled_ts[:v])
            by_version[v] = _replay(prefix, bare, prob).params["w1"][0, 0]
        want = by_version[v]
        if dtype == "bf16":
            want = want.to(torch.bfloat16).to(torch.float32)
        assert got[i] == np.float32(want), (i, v)


@pytest.mark.parametrize("run_kw", [
    dict(ring_impl="auto"), dict(ring_impl="stock"),
    dict(ring_impl="fused", ring_dtype="bf16"),
    dict(membership=TTimeline.crash_restart([1], 3.0, 8.0))])
def test_serving_leaves_training_bitwise_unchanged(run_kw, prob):
    fleet = _fleet(TFleet, TPolicy,
                   membership=((2.0, 1, "crash"), (6.0, 1, "join")))
    cfg = TRun(**_kw(serving=fleet, **run_kw))
    sim = _replay(schedule(cfg, 24), cfg, prob)
    bare = cfg.replace(serving=None)
    sim0 = _replay(schedule(bare, 24), bare, prob)
    assert all(torch.equal(sim.params[k], sim0.params[k])
               for k in sim.params)
    assert isinstance(sim.serving, ServingResult) and sim0.serving is None
    assert sim.serving.summary()["n_served"] > 0


def test_request_metric_matches_reference(R, prob):
    """Both packages' metric on the same 64 requests of 32 samples, each
    request on its own perturbed weights."""
    jax = R.jax
    ref_prob = R.problem("mlp_teacher", (("hidden", HIDDEN),))
    rng = np.random.default_rng(3)
    n, s = 64, 32
    base = {k: np.asarray(v) for k, v in ref_prob.init.items()}
    params = {k: (v[None] + 0.5 * rng.normal(size=(n,) + v.shape))
              .astype(np.float32) for k, v in base.items()}
    idx = rng.integers(0, prob.task.n_test, (n, s))
    x, y = prob.task.x_test[idx], prob.task.y_test[idx]
    want = np.asarray(jax.vmap(ref_prob.request_metric)(params, (x, y)))
    got = prob.request_metric({k: torch.tensor(v) for k, v in
                               params.items()},
                              (torch.tensor(x), torch.tensor(y))).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    h = np.tanh(np.einsum("nsf,nfh->nsh", x, params["w1"])
                + params["b1"][:, None])
    logits = np.einsum("nsh,nhc->nsc", h, params["w2"]) + params["b2"][:, None]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) < 1e-5).any(axis=1)
    exact = ~near_tie
    np.testing.assert_array_equal(got[exact], want[exact])
    assert np.all(np.abs(got - want) <= 1.0 / s + 1e-7)


def test_serving_run_matches_reference(R):
    """``driver.run`` with a serving lane: the serving summary bitwise the
    reference's, metrics within the policy, on carried initial weights."""
    common = dict(problem="mlp_teacher", problem_args={"hidden": HIDDEN},
                  steps=24)
    ref = R.run(R.Spec(run=R.Run(**_kw(serving=_fleet(
        R.Fleet, R.Policy, R.Policy(max_version_lag=2)))), **common))
    init = params_from_jax({k: np.asarray(v) for k, v in R.problem(
        "mlp_teacher", (("hidden", HIDDEN),)).init.items()}, "cpu")
    port = t_run(TSpec(run=TRun(**_kw(serving=_fleet(
        TFleet, TPolicy, TPolicy(max_version_lag=2)))), **common),
        device="cpu", init=init)
    rs, ps = ref.runtime.pop("serving"), port.runtime.pop("serving")
    assert ref.runtime == port.runtime
    assert abs(rs.pop("accuracy") - ps.pop("accuracy")) <= 1e-6
    assert rs == ps
    assert abs(ref.metrics["test_error"]
               - port.metrics["test_error"]) <= 2 / 2048
    assert abs(ref.metrics["serving_accuracy"]
               - port.metrics["serving_accuracy"]) <= 1e-6
    for k in ("serving_staleness_mean", "serving_latency_p99_s"):
        assert ref.metrics[k] == port.metrics[k]
