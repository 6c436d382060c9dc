"""The port's replay, end to end, against the reference package.

Same spec, same schedule (bitwise, see test_torch_schedule.py), same
initial weights (the reference's jax.random draw carried across as numpy
with ``params_from_jax``): the port's ``driver.run(spec, device="cpu")``
must give the reference's ``repro.experiments.run(spec)`` numbers.

Tolerances, with their reasons:

* Final parameters: ``atol=2e-6, rtol=1e-5`` (measured ≤ 2.4e-7 on these
  weights of magnitude ≈ 1).  The port's MLP gradients come from explicit
  batched matmuls where the reference vmaps ``jax.grad``, and XLA fuses
  the event with FMA contraction while the port rounds every operation
  (test_torch_optim.py) — fp32 rounding differences, compounded over 24
  events.
* Staleness block, runtime axis and the ring depth K: exactly equal (they
  come off the bitwise trace).
* bf16 ring: a 1-ulp fp32 difference can flip one bf16 rounding of a
  snapshot, moving the gradients evaluated there by a bf16 rounding step.
  The bound is half a bf16 ulp at the leaf's scale, 2⁻⁸·max|ref|
  (measured: ≤ 0.0023 on weights of magnitude 1.2 for what-if momentum,
  the worst cell).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.core import replay, schedule
from repro_torch.experiments import ExperimentSpec as TSpec, run as t_run
from repro_torch.experiments import params_from_jax
from repro_torch.experiments.problems import MLPProblem, QuadraticProblem
from repro_torch.kernels import replay_ring
from repro_torch.membership import MembershipTimeline as TTimeline

STEPS = 24
HIDDEN = 16


@pytest.fixture(scope="module")
def R():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.config import RunConfig
    from repro.experiments import ExperimentSpec, run
    from repro.experiments.problems import get_problem
    return types.SimpleNamespace(jax=jax, Run=RunConfig, Spec=ExperimentSpec,
                                 run=run, problem=get_problem)


def _specs(problem, problem_args, eval_every=0, R=None, **run_kw):
    """(reference spec or None, port spec) for the same experiment."""
    kw = dict(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4,
              base_lr=0.05)
    kw.update(run_kw)
    common = dict(problem=problem, problem_args=problem_args, steps=STEPS,
                  eval_every=eval_every)
    ref = None if R is None else R.Spec(run=R.Run(**kw), **common)
    return ref, TSpec(run=TRun(**kw), **common)


def _close_params(ref, port, dtype):
    for k in ref:
        r = np.asarray(ref[k])
        p = port[k].cpu().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=2e-6)
        else:
            bound = 2.0 ** -8 * np.abs(r).max()
            assert np.abs(r - p).max() <= bound, k


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("opt,lr_policy", [
    ("sgd", "const"), ("momentum", "const"), ("adagrad", "const"),
    ("momentum", "per_gradient")])
def test_driver_run_matches_reference(opt, lr_policy, dtype, R):
    """mlp_teacher(hidden=16), 1-softsync λ=8, 24 updates, eval segments;
    per_gradient LRs replay in sequential mode."""
    js, ts = _specs("mlp_teacher", {"hidden": HIDDEN}, eval_every=8, R=R,
                    optimizer=opt, lr_policy=lr_policy, ring_dtype=dtype)
    ref = R.run(js)
    init = params_from_jax(
        {k: np.asarray(v) for k, v in
         R.problem("mlp_teacher", (("hidden", HIDDEN),)).init.items()},
        "cpu")
    port = t_run(ts, device="cpu", init=init)
    assert ref.trace.mode == port.trace.mode
    _close_params(ref.params, port.params, dtype)
    assert ref.staleness == port.staleness
    assert ref.runtime == port.runtime
    assert [r["update"] for r in ref.curve] == [r["update"] for r in
                                                port.curve] == [8, 16, 24]
    for r, p in zip(ref.curve, port.curve):
        assert r["time"] == p["time"]
        assert abs(r["test_error"] - p["test_error"]) <= 2 / 2048
    assert abs(ref.metrics["test_error"]
               - port.metrics["test_error"]) <= 2 / 2048
    assert ref.record()["spec"] == port.record()["spec"]


def test_mlp_gradients_match_jax(R):
    """The explicit-slot-dimension backward pass ≡ jax.grad, per slot."""
    jax = R.jax
    jp = R.problem("mlp_teacher", (("hidden", HIDDEN),))
    tp = MLPProblem(hidden=HIDDEN)
    rng = np.random.default_rng(0)
    c, mu = 3, 5
    x = rng.normal(size=(c, mu, 32)).astype(np.float32)
    y = rng.integers(0, 10, (c, mu))
    params = {k: np.stack([np.asarray(v) + 0.1 * i for i in range(c)])
              for k, v in jp.init.items()}
    ref = jax.vmap(jax.grad(jp.loss))(params, (x, y.astype(np.int32)))
    got = tp.grad_fn({k: torch.tensor(v) for k, v in params.items()},
                     (torch.tensor(x), torch.tensor(y)))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)
    loss = tp.loss({k: torch.tensor(v[0]) for k, v in params.items()},
                   (torch.tensor(x[0]), torch.tensor(y[0])))
    ref_loss = jp.loss({k: v[0] for k, v in params.items()},
                       (x[0], y[0].astype(np.int32)))
    assert abs(float(loss) - float(ref_loss)) <= 1e-6


def test_quadratic_coefficients(R):
    """a and w* follow the reference's iota formulas.  The port divides
    by 1000 as written; XLA rewrites that into fma(r, 0.001, 0.5), so a
    agrees within 1 ulp.  sin is a different fp32 implementation on each
    side: w* agrees within 2 ulps of its scale."""
    jp = R.problem("quadratic_whatif", (("d", 4096),))
    _, a, wstar = QuadraticProblem(d=4096).flat_grad("cpu")
    ja = np.asarray(jp.flat_grad[1])
    assert np.max(np.abs(ja - a.numpy()) / np.spacing(ja)) <= 1
    assert np.max(np.abs(np.asarray(jp.flat_grad[2]) - wstar.numpy())) \
        <= 2 * np.spacing(np.float32(1.0))
    assert float(a.min()) >= 0.5 and float(a.max()) < 1.5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adagrad"])
def test_whatif_replay_matches_reference(opt, dtype, R):
    """quadratic_whatif(d=4096) through the what-if body: the port's engine
    fed the reference's own a and w* tracks the reference replay (fp32:
    ≤ 4 ulps at scale, measured 3), and driver.run end to end (the port's
    own a and w*) gives the reference's loss within 1e-5 relative."""
    js, ts = _specs("quadratic_whatif", {"d": 4096}, R=R, optimizer=opt,
                    base_lr=0.1, ring_dtype=dtype)
    ref = R.run(js)
    jp = R.problem("quadratic_whatif", (("d", 4096),))
    flat_grad = ("quadratic", torch.tensor(np.asarray(jp.flat_grad[1])),
                 torch.tensor(np.asarray(jp.flat_grad[2])))
    trace = schedule(ts.run, STEPS)
    assert trace.max_staleness + 1 >= 2          # K = 1: the test below
    sim = replay(trace, ts.run, init_params=QuadraticProblem(4096).init(
        "cpu"), flat_grad=flat_grad, device="cpu")
    r, p = np.asarray(ref.params["w"]), sim.params["w"].numpy()
    if dtype == "fp32":
        assert np.max(np.abs(r - p)) <= 4 * np.spacing(np.abs(r).max())
    else:
        _close_params(ref.params, sim.params, dtype)
    port = t_run(ts, device="cpu")
    np.testing.assert_allclose(port.metrics["loss"], ref.metrics["loss"],
                               rtol=1e-5 if dtype == "fp32" else 1e-4)
    assert port.staleness == ref.staleness


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_whatif_hardsync_matches_reference(dtype, R):
    """Hardsync: K = 1, so every event reads and writes row 0.  The port's
    what-if body runs it through the wrapper like any other K (bounds as
    in test_whatif_replay_matches_reference)."""
    js, ts = _specs("quadratic_whatif", {"d": 4096}, R=R, protocol="hardsync",
                    optimizer="momentum", base_lr=0.1, ring_dtype=dtype)
    ref = R.run(js)
    jp = R.problem("quadratic_whatif", (("d", 4096),))
    flat_grad = ("quadratic", torch.tensor(np.asarray(jp.flat_grad[1])),
                 torch.tensor(np.asarray(jp.flat_grad[2])))
    trace = schedule(ts.run, STEPS)
    assert trace.max_staleness + 1 == 1
    sim = replay(trace, ts.run, init_params=QuadraticProblem(4096).init(
        "cpu"), flat_grad=flat_grad, device="cpu")
    r, p = np.asarray(ref.params["w"]), sim.params["w"].numpy()
    if dtype == "fp32":
        assert np.max(np.abs(r - p)) <= 4 * np.spacing(np.abs(r).max())
    else:
        _close_params(ref.params, sim.params, dtype)
    assert ref.staleness == t_run(ts, device="cpu").staleness


def test_fused_and_kernel_wrappers_agree_on_cpu():
    """ring_impl='fused' (plain versions called directly) and the default
    'auto' (the kernel wrappers, which run the plain versions on CPU
    tensors) give bitwise the same run, with no kernel launch counted."""
    _, ts = _specs("mlp_teacher", {"hidden": HIDDEN}, optimizer="momentum",
                   ring_dtype="bf16")
    replay_ring.reset_launches()
    a = t_run(ts, device="cpu")
    b = t_run(ts.replace(run=ts.run.replace(ring_impl="fused")),
              device="cpu")
    assert replay_ring.launches == {"ring_apply": 0, "ring_apply_whatif": 0}
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_execute_raw_callables():
    from repro_torch.experiments import execute
    prob = MLPProblem(hidden=HIDDEN)
    run = TRun(protocol="async", n_learners=4, minibatch=4, base_lr=0.05)
    sim = execute(run, steps=12, grad_fn=prob.grad_fn,
                  init_params=prob.init("cpu"), batch_fn=prob.batch_fn_for(4),
                  eval_fn=prob.eval_fn, eval_every=6, device="cpu")
    assert sim.updates == 12 and [h["update"] for h in sim.history] == [6, 12]
    measured = execute(run, steps=12, device="cpu")
    assert measured.params is None and measured.updates == 12


@pytest.mark.parametrize("change,item", [
    (dict(ring_impl="stock"), "4.2"),
    (dict(optimizer="adamw"), "4.2"),
    (dict(shards=2), "4.5"),
    (dict(groups=2), "4.5"),
    (dict(placement="spmd"), "item 8"),
    (dict(membership=TTimeline.crash_restart([1], 2.0, 3.0)), "4.4"),
])
def test_not_ported_paths_raise(change, item):
    ts = TSpec(run=TRun(protocol="softsync", n_learners=8, minibatch=4,
                        **change),
               problem="mlp_teacher", problem_args={"hidden": HIDDEN},
               steps=STEPS)
    with pytest.raises(NotImplementedError, match=item):
        t_run(ts, device="cpu")


def test_legacy_engine_not_ported():
    _, ts = _specs("mlp_teacher", {"hidden": HIDDEN})
    with pytest.raises(NotImplementedError, match="item 7"):
        t_run(ts.replace(engine="legacy"), device="cpu")


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("problem,args", [
    ("mlp_teacher", {"hidden": HIDDEN}), ("quadratic_whatif", {"d": 4099})])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_kernel_run_equals_plain_run_on_card(problem, args, dtype, cuda):
    """On the card every event launches its kernel once, and the run is
    bitwise the same run through the plain versions (ring_impl='fused')."""
    _, ts = _specs(problem, args, optimizer="momentum", ring_dtype=dtype)
    replay_ring.reset_launches()
    a = t_run(ts, device=cuda)
    name = "ring_apply_whatif" if problem == "quadratic_whatif" \
        else "ring_apply"
    assert replay_ring.launches[name] == STEPS
    b = t_run(ts.replace(run=ts.run.replace(ring_impl="fused")), device=cuda)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_hardsync_whatif_run_launches_kernel_on_card(dtype, cuda):
    """Hardsync (K = 1): every what-if event still launches the kernel, and
    the run is bitwise the plain versions' run."""
    _, ts = _specs("quadratic_whatif", {"d": 4099}, protocol="hardsync",
                   optimizer="adagrad", ring_dtype=dtype)
    replay_ring.reset_launches()
    a = t_run(ts, device=cuda)
    assert a.staleness["ring_buffer_K"] == 1
    assert replay_ring.launches == {"ring_apply": 0,
                                    "ring_apply_whatif": STEPS}
    b = t_run(ts.replace(run=ts.run.replace(ring_impl="fused")), device=cuda)
    assert torch.equal(a.params["w"], b.params["w"])
