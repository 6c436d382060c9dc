"""The port's legacy per-arrival oracle and its host PS against the reference.

Inputs are numpy draws from a seed, handed to both packages (jax gets
private copies).  What is compared, and within what:

* ``ps_apply`` (the plain version, on the CPU) against the reference's
  Pallas ``ps_apply`` in interpret mode, ``ps_update_flat`` /
  ``ps_update_tree`` against ``ps_update_ref``, and ``apply_update`` over
  the three backends × four optimizers × both modes against the
  reference's ``apply_update`` with the same backend: weights within
  2 ulps at scale (max |ref − port| ≤ 2 · spacing(max |ref|) in fp32),
  optimizer state within 4.  The reference contracts the combine with
  ``einsum`` in an order the CPU backend does not fix, and its jitted
  backends fuse the event with FMA contraction; the port sums in slot
  order 0…c−1 and rounds every product and sum (the order of the CUDA
  kernel).  The state carries that difference further: adagrad's
  accumulator squares the combined gradient and momentum's velocity adds
  it unscaled by the LR.  Measured: weights ≤ 1 ulp, state ≤ 3.
* ``simulate``, the baselines and ``driver.run(engine="legacy")``: vector
  clocks, update counts and ``simulated_time`` exactly equal (the arrival
  order is host-side numpy, bitwise the reference's); parameters within
  ``atol=1e-5, rtol=1e-5`` — the tolerance the reference pins its own
  replay engine to its legacy loop with (``tests/test_trace_engine.py``):
  jax's autodiff and the port's written-out gradients round differently,
  compounded over 25 updates.  Measured ≤ 2.4e-7.
* The port's legacy run against the port's compiled replay (``execute``)
  on the same inputs: the same clocks and times, parameters within the
  same tolerance (measured ≤ 3.6e-7: the replay computes the c gradients
  of an event in one batched matmul, the legacy loop one at a time).

Tests marked ``cuda`` run the kernel on a card (``ps_apply`` ≡ its plain
version, bitwise; a legacy run through the kernel) and skip without one.
"""

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.core import ParameterServerState, simulate as t_simulate
from repro_torch.core import baselines as t_base
from repro_torch.experiments import ExperimentSpec as TSpec
from repro_torch.experiments import execute as t_execute, params_from_jax
from repro_torch.experiments import run as t_run
from repro_torch.experiments.driver import per_arrival_grad
from repro_torch.kernels import ops as t_ops, ps_update as t_psu
from repro_torch.kernels import ref as t_ref
from repro_torch.optim import UpdateSpec as TUpd, apply_update as t_apply
from repro_torch.optim import init_state as t_init
from repro_torch.optim import backends as t_backends, flatten as tflatten
from repro_torch.optim.backends import apply_event_flat as t_flat

D, C = 2816, 4
OPTS = ["sgd", "momentum", "adagrad"]
ULPS = 2           # weights
STATE_ULPS = 4     # optimizer state


@pytest.fixture(scope="module")
def J():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.config import RunConfig
    from repro.core import baselines, simulate
    from repro.experiments import ExperimentSpec, run
    from repro.experiments.driver import execute
    from repro.experiments.problems import get_problem
    from repro.kernels import ps_update, ref
    from repro.optim import UpdateSpec, apply_update, init_state
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, Upd=UpdateSpec, apply=apply_update,
        init_state=init_state,
        psu=ps_update, ref=ref, Run=RunConfig, simulate=simulate,
        execute=execute, base=baselines, Spec=ExperimentSpec, run=run,
        problem=get_problem)


def close(ref, port, ulps=ULPS):
    ref = np.asarray(ref, np.float32)
    port = np.asarray(port, np.float32)
    scale = np.spacing(np.float32(np.max(np.abs(ref))))
    err = np.max(np.abs(ref - port))
    assert err <= ulps * scale, f"max |diff| {err} > {ulps} x {scale}"


def _j(x):
    """A private jax copy (jax on the CPU may alias a numpy buffer)."""
    import jax.numpy as jnp
    return None if x is None else jnp.asarray(np.array(x, copy=True))


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


def _flat_inputs(width, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"w": rng.normal(size=width).astype(f32),
            "s": np.abs(rng.normal(size=width)).astype(f32),
            "g": rng.normal(size=(C, width)).astype(f32),
            "coef": np.full(C, 1.0 / C, f32),
            "lrs": rng.uniform(0.01, 0.1, C).astype(f32)}


# ---------------------------------------------------------------------------
# the kernel's plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [D, D + 3])
@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_ps_apply_plain_vs_reference_interpret(opt, mode, width, J):
    x = _flat_inputs(width)
    s = None if opt == "sgd" else x["s"]
    jw, js = J.psu.ps_apply(_j(x["w"]), _j(s), _j(x["g"]), _j(x["coef"]),
                            _j(x["lrs"]), spec=J.Upd(opt), mode=mode,
                            interpret=True)
    t_psu.reset_launches()
    tw, ts = t_psu.ps_apply(_t(x["w"]), _t(s), _t(x["g"]), _t(x["coef"]),
                            _t(x["lrs"]), spec=TUpd(opt), mode=mode)
    assert t_psu.launches["ps_apply"] == 0       # CPU: the plain version
    close(jw, tw.numpy())
    assert (ts is None) == (js is None)
    if ts is not None:
        close(js, ts.numpy(), STATE_ULPS)


def test_ps_update_wrappers_vs_reference_oracle(J):
    x = _flat_inputs(D + 3, seed=1)
    kw = dict(momentum=0.9, lr=0.05)
    jw, jv = J.ref.ps_update_ref(_j(x["w"]), _j(x["s"]), _j(x["g"]),
                                 _j(x["coef"]), **kw)
    for fn in (t_psu.ps_update_flat, t_ops.ps_update, t_ref.ps_update_ref):
        tw, tv = fn(_t(x["w"]), _t(x["s"]), _t(x["g"]), _t(x["coef"]), **kw)
        close(jw, tw.numpy())
        close(jv, tv.numpy(), STATE_ULPS)
    rng = np.random.default_rng(2)
    shapes = {"a": (300,), "b": (17, 8)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    vel = {k: np.abs(rng.normal(size=s)).astype(np.float32)
           for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    coef = np.array([1.0, 0.5, 0.25], np.float32)
    flat = lambda tree: np.concatenate([tree[k].reshape(-1)   # noqa: E731
                                        for k in sorted(tree)])
    jw, jv = J.ref.ps_update_ref(_j(flat(params)), _j(flat(vel)),
                                 _j(np.stack([flat(g) for g in grads])),
                                 _j(coef), momentum=0.9, lr=0.1)
    tp, tv = t_psu.ps_update_tree(
        {k: _t(v) for k, v in params.items()},
        {k: _t(v) for k, v in vel.items()},
        [{k: _t(v) for k, v in g.items()} for g in grads], _t(coef),
        momentum=0.9, lr=0.1)
    assert {k: tuple(v.shape) for k, v in tp.items()} == shapes
    close(jw, flat({k: v.numpy() for k, v in tp.items()}))
    close(jv, flat({k: v.numpy() for k, v in tv.items()}), STATE_ULPS)


def test_ps_apply_wrapper_validates_inputs():
    x = _flat_inputs(64)
    w, s, g, coef, lrs = (_t(x[k]) for k in ("w", "s", "g", "coef", "lrs"))
    spec = TUpd("momentum")
    with pytest.raises(ValueError, match="state vector"):
        t_psu.ps_apply(w, None, g, coef, lrs, spec=spec)
    with pytest.raises(ValueError, match="g has dtype"):
        t_psu.ps_apply(w, s, g.double(), coef, lrs, spec=spec)
    with pytest.raises(ValueError, match="lrs has shape"):
        t_psu.ps_apply(w, s, g, coef, lrs[:2], spec=spec)
    with pytest.raises(ValueError, match="contiguous"):
        t_psu.ps_apply(w, s, g.t().contiguous().t(), coef, lrs, spec=spec)
    with pytest.raises(ValueError, match="no kernel path"):
        t_psu.ps_apply(w, s, g, coef, lrs, spec=TUpd("adamw"))
    with pytest.raises(ValueError, match="unknown mode"):
        t_psu.ps_apply(w, s, g, coef, lrs, spec=spec, mode="nope")


def test_ps_apply_writes_out_of_place():
    """The inputs stay as they were: w and s are read, new tensors come
    back (the reference's pallas_call makes new arrays too)."""
    x = _flat_inputs(D)
    ins = {k: _t(x[k]) for k in x}
    keep = {k: v.clone() for k, v in ins.items()}
    w2, s2 = t_psu.ps_apply(ins["w"], ins["s"], ins["g"], ins["coef"],
                            ins["lrs"], spec=TUpd("momentum"))
    for k in ins:
        assert torch.equal(ins[k], keep[k]), k
    assert w2.data_ptr() != ins["w"].data_ptr()
    assert s2.data_ptr() != ins["s"].data_ptr()


# ---------------------------------------------------------------------------
# apply_update: backends × optimizers × modes
# ---------------------------------------------------------------------------
TREE = {"w": (5, 7), "b": (7,)}


@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS + ["adamw"])
@pytest.mark.parametrize("backend", ["reference", "jit", "pallas"])
def test_apply_update_vs_reference(backend, opt, mode, J):
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in TREE.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in TREE.items()} for _ in range(3)]
    coef = np.full(3, 1.0 / 3, np.float32)
    lrs = rng.uniform(0.01, 0.1, 3).astype(np.float32)
    jspec = J.Upd(opt, weight_decay=0.01)
    jp = {k: _j(v) for k, v in params.items()}
    jnew, jstate = J.apply(jspec, jp, J.init_state(jspec, jp),
                           [{k: _j(v) for k, v in g.items()} for g in grads],
                           _j(coef), _j(lrs), mode=mode, backend=backend)
    tspec = TUpd(opt, weight_decay=0.01)
    tp = {k: _t(v) for k, v in params.items()}
    before = t_backends.pallas_dispatches
    tnew, tstate = t_apply(tspec, tp, t_init(tspec, tp),
                           [{k: _t(v) for k, v in g.items()} for g in grads],
                           coef, lrs, mode=mode, backend=backend)
    flat = backend == "pallas" and opt != "adamw"
    assert t_backends.pallas_dispatches - before == int(flat)
    for k in TREE:
        close(jnew[k], tnew[k].numpy())
    for key in tspec.state_keys:
        if key == "count":
            assert int(tstate[key]) == int(jstate[key]) == (
                1 if mode == "combine" else 3)
            continue
        for k in TREE:
            close(jstate[key][k], tstate[key][k].numpy(), STATE_ULPS)


def test_sgd_step_and_bare_tensor_tree():
    """A bare tensor is a one-leaf tree through every backend."""
    rng = np.random.default_rng(4)
    p = _t(rng.normal(size=(6, 3)).astype(np.float32))
    gs = [_t(rng.normal(size=(6, 3)).astype(np.float32)) for _ in range(2)]
    outs = [t_apply(TUpd("momentum"), p, {"velocity": torch.zeros(6, 3)},
                    gs, [0.5, 0.5], [0.1, 0.1], backend=b)
            for b in ("reference", "pallas")]
    for new, state in outs:
        assert new.shape == (6, 3) and state["velocity"].shape == (6, 3)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(t_backends.sgd_step(p, gs[0], 0.1), p - 0.1 * gs[0])
    layout = tflatten.layout_of(p)
    assert layout.keys is None
    assert torch.equal(tflatten.flat_to_tree(tflatten.tree_to_flat(p),
                                             layout), p)
    assert tflatten.stack_grads_flat(gs).shape == (2, 18)


# ---------------------------------------------------------------------------
# the aliasing pin: pulled snapshots stay stale
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["pallas", "reference"])
@pytest.mark.parametrize("tree", ["bare", "dict"])
def test_pulled_snapshot_is_unchanged_by_later_updates(tree, backend):
    """``tree_to_flat`` of a single fp32 leaf is a view of that leaf, and
    ``flat_to_tree`` returns views: an update written in place would move
    every learner's pulled copy to the current weights.  The PS's updates
    must leave a pulled snapshot as it was."""
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(6, 3)).astype(np.float32)
    params = _t(w0) if tree == "bare" else {"w": _t(w0), "b": torch.ones(3)}
    ps = ParameterServerState(params, c=2, optimizer="momentum",
                              backend=backend)
    pulled = ps.params
    keep = tflatten.tree_map(lambda t: t.clone(), pulled)
    for step in range(3):                      # three updates fire
        for _ in range(2):
            g = tflatten.tree_map(lambda t: torch.ones_like(t), pulled)
            ps.push_gradient(g, step, lambda ts, clocks: 0.1)
    assert ps.timestamp == 3
    assert tflatten.tree_map(torch.equal, pulled, keep) == (
        True if tree == "bare" else {"w": True, "b": True})
    moved = tflatten.tree_to_flat(ps.params) - tflatten.tree_to_flat(keep)
    assert bool((moved != 0).all())


# ---------------------------------------------------------------------------
# simulate: the legacy loop against the reference's
# ---------------------------------------------------------------------------
_RNG = np.random.default_rng(0)
W_TRUE = _RNG.normal(size=(6, 3)).astype(np.float32)
X = _RNG.normal(size=(64, 6)).astype(np.float32)
Y = (X @ W_TRUE).astype(np.float32)


def _batch_fn(l, i):
    rng = np.random.default_rng(l * 9973 + i)
    idx = rng.integers(0, 64, size=8)
    return X[idx], Y[idx]


@functools.lru_cache(maxsize=None)
def _j_grad():
    import jax
    import jax.numpy as jnp

    def loss(p, b):
        x, y = b
        return jnp.mean((x @ p - y) ** 2)
    return jax.jit(jax.grad(loss))


def _t_grad(p, batch):
    """d/dp mean((x p − y)²) for one minibatch, written out."""
    x, y = batch
    return (2.0 / y.numel()) * (x.t() @ (x @ p - y))


def _t_grad_batched(p, batch):
    """The same for c slots at once (the replay engine's grad_fn)."""
    x, y = batch
    r = torch.bmm(x, p["w"]) - y
    return {"w": (2.0 / y[0].numel()) * torch.bmm(x.transpose(1, 2), r)}


def _clocks(log):
    return np.array([r.gradient_timestamps for r in log.records])


def _same_run(ref, port, params_of=lambda p: p):
    np.testing.assert_array_equal(_clocks(port.clock_log),
                                  _clocks(ref.clock_log))
    assert port.updates == ref.updates
    assert port.minibatches == ref.minibatches
    assert port.simulated_time == ref.simulated_time
    np.testing.assert_allclose(params_of(port.params).numpy(),
                               np.asarray(ref.params), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lam", [4, 8])
@pytest.mark.parametrize("protocol,n", [("async", 1), ("softsync", 2),
                                        ("hardsync", 1)])
@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
@pytest.mark.parametrize("lr_policy", ["staleness_inverse", "per_gradient"])
def test_simulate_equals_reference_legacy(lam, protocol, n, optimizer,
                                          lr_policy, J):
    kw = dict(protocol=protocol, n_softsync=n, n_learners=lam, minibatch=8,
              base_lr=0.05, lr_policy=lr_policy, optimizer=optimizer,
              seed=7 + lam)
    run = TRun(**kw)
    ref = J.simulate(J.Run(**kw), steps=25, grad_fn=_j_grad(),
                     init_params=J.jnp.zeros((6, 3)), batch_fn=_batch_fn)
    legacy = t_simulate(run, steps=25, grad_fn=_t_grad,
                        init_params=torch.zeros(6, 3), batch_fn=_batch_fn,
                        device="cpu")
    _same_run(ref, legacy)
    compiled = t_execute(run, steps=25, grad_fn=_t_grad_batched,
                         init_params={"w": torch.zeros(6, 3)},
                         batch_fn=_batch_fn, device="cpu")
    _same_run(ref, compiled, lambda p: p["w"])
    np.testing.assert_allclose(compiled.params["w"].numpy(),
                               legacy.params.numpy(), atol=1e-5, rtol=1e-5)


def test_simulate_eval_history_and_measure_mode(J):
    """Eval histories line up (same update indices, times and metrics),
    through ``execute(engine="legacy")``; measure mode is the schedule."""
    kw = dict(protocol="softsync", n_softsync=4, n_learners=8, minibatch=8,
              base_lr=0.05, lr_policy="staleness_inverse",
              optimizer="momentum", seed=11)
    j_eval = lambda p: {"err": float(J.jnp.mean((X @ p - Y) ** 2))}  # noqa
    t_eval = lambda p: {"err": float(torch.mean(               # noqa: E731
        (torch.tensor(X) @ p - torch.tensor(Y)) ** 2))}
    ref = J.simulate(J.Run(**kw), steps=40, grad_fn=_j_grad(),
                     init_params=J.jnp.zeros((6, 3)), batch_fn=_batch_fn,
                     eval_fn=j_eval, eval_every=10)
    port = t_execute(TRun(**kw), steps=40, grad_fn=_t_grad,
                     init_params=torch.zeros(6, 3), batch_fn=_batch_fn,
                     eval_fn=t_eval, eval_every=10, engine="legacy",
                     device="cpu")
    _same_run(ref, port)
    assert len(port.history) == len(ref.history) == 4
    for a, b in zip(port.history, ref.history):
        assert a["update"] == b["update"] and a["time"] == b["time"]
        assert a["err"] == pytest.approx(b["err"], rel=1e-4, abs=1e-6)
    tm = t_simulate(TRun(**kw), steps=40, device="cpu")
    jm = J.simulate(J.Run(**kw), steps=40)
    np.testing.assert_array_equal(_clocks(tm.clock_log), _clocks(jm.clock_log))
    assert tm.simulated_time == jm.simulated_time and tm.params is None


def test_simulate_rejects_what_the_oracle_does_not_model():
    grad = dict(grad_fn=_t_grad, init_params=torch.zeros(6, 3),
                batch_fn=_batch_fn, device="cpu")
    with pytest.raises(ValueError, match="flat Rudra-base server"):
        t_simulate(TRun(protocol="softsync", n_learners=8, shards=2),
                   steps=2, **grad)
    from repro_torch.config import FleetConfig
    with pytest.raises(ValueError, match="no serving lane"):
        t_simulate(TRun(protocol="softsync", n_learners=4,
                        serving=FleetConfig()), steps=2, **grad)


# ---------------------------------------------------------------------------
# baselines: SSP, EASGD, accrual
# ---------------------------------------------------------------------------
_RNG2 = np.random.default_rng(1)
W8 = _RNG2.normal(size=(8, 4)).astype(np.float32)
X8 = _RNG2.normal(size=(256, 8)).astype(np.float32)
Y8 = (X8 @ W8).astype(np.float32)


def _batch8(l, i):
    rng = np.random.default_rng(l * 7919 + i)
    idx = rng.integers(0, 256, size=8)
    return X8[idx], Y8[idx]


def _straggler(rng, m):
    from repro_torch.core.simulator import _default_duration_sampler
    return _default_duration_sampler(rng, m) * (
        20.0 if rng.integers(0, 8) == 0 else 1.0)


def test_ssp_equals_reference(J):
    kw = dict(protocol="async", n_learners=8, minibatch=8, base_lr=0.4,
              lr_policy="staleness_inverse", optimizer="sgd", seed=3)
    common = dict(steps=80, slack=2, batch_fn=_batch8,
                  duration_sampler=_straggler)
    ref = J.base.simulate_ssp(J.Run(**kw), grad_fn=_j_grad(),
                              init_params=J.jnp.zeros((8, 4)), **common)
    port = t_base.simulate_ssp(TRun(**kw), grad_fn=_t_grad,
                               init_params=torch.zeros(8, 4), device="cpu",
                               **common)
    assert port.stalls == ref.stalls > 0
    _same_run(ref, port)


def test_easgd_equals_reference(J):
    kw = dict(protocol="async", n_learners=8, minibatch=8, base_lr=0.1,
              optimizer="sgd", seed=5)
    common = dict(steps=60, rho=0.3, comm_every=2, batch_fn=_batch8)
    ref = J.base.simulate_easgd(J.Run(**kw), grad_fn=_j_grad(),
                                init_params=J.jnp.zeros((8, 4)), **common)
    port = t_base.simulate_easgd(TRun(**kw), grad_fn=_t_grad,
                                 init_params=torch.zeros(8, 4),
                                 device="cpu", **common)
    _same_run(ref, port)


def test_accrual_equals_reference_and_npush1_is_softsync(J):
    kw = dict(protocol="softsync", n_softsync=1, n_learners=4, minibatch=8,
              base_lr=0.05, lr_policy="staleness_inverse", optimizer="sgd",
              seed=7)
    common = dict(grad_fn=_t_grad, init_params=torch.zeros(8, 4),
                  batch_fn=_batch8, device="cpu")
    ref = J.base.simulate_accrual(J.Run(**kw), steps=30, npush=2,
                                  grad_fn=_j_grad(),
                                  init_params=J.jnp.zeros((8, 4)),
                                  batch_fn=_batch8)
    _same_run(ref, t_base.simulate_accrual(TRun(**kw), steps=30, npush=2,
                                           **common))
    a = t_base.simulate_accrual(TRun(**kw), steps=50, npush=1, **common)
    b = t_simulate(TRun(**kw), steps=50, **common)
    np.testing.assert_allclose(a.params.numpy(), b.params.numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# driver.run(engine="legacy") end to end
# ---------------------------------------------------------------------------
def test_driver_run_legacy_vs_reference(J):
    kw = dict(protocol="softsync", n_softsync=2, n_learners=8, minibatch=4,
              base_lr=0.05, optimizer="momentum",
              lr_policy="staleness_inverse")
    common = dict(problem="mlp_teacher", problem_args={"hidden": 16},
                  steps=24, eval_every=8, engine="legacy")
    ref = J.run(J.Spec(run=J.Run(**kw), **common))
    init = J.problem("mlp_teacher", (("hidden", 16),)).init
    init = params_from_jax({k: np.asarray(v) for k, v in init.items()},
                           "cpu")
    spec = TSpec(run=TRun(**kw), **common)
    port = t_run(spec, device="cpu", init=init)
    assert port.runtime == ref.runtime
    assert port.runtime["replay_path"] == "legacy"
    assert port.staleness == ref.staleness
    for k in ref.params:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]),
                                   atol=2e-6, rtol=1e-5)
    assert [c["update"] for c in port.curve] == [8, 16, 24]
    for a, b in zip(port.curve, ref.curve):
        assert a["time"] == b["time"]
        assert abs(a["test_error"] - b["test_error"]) <= 2 / 2048
    compiled = t_run(spec.replace(engine="compiled"), device="cpu",
                     init=init)
    for k in ref.params:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   compiled.params[k].numpy(),
                                   atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [D, D + 3])
@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_ps_apply_kernel_bitwise_on_card(opt, mode, width, cuda):
    x = _flat_inputs(width, seed=6)
    ins = {k: torch.tensor(v, device=cuda) for k, v in x.items()}
    s = None if opt == "sgd" else ins["s"]
    keep = ins["w"].clone()
    plain = t_flat(TUpd(opt), ins["w"], s, ins["g"], ins["coef"], ins["lrs"],
                   mode)
    t_psu.reset_launches()
    kern = t_psu.ps_apply(ins["w"], s, ins["g"], ins["coef"], ins["lrs"],
                          spec=TUpd(opt), mode=mode)
    torch.cuda.synchronize()
    assert t_psu.launches["ps_apply"] == 1
    assert torch.equal(ins["w"], keep)
    for a, b in zip(kern, plain):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_legacy_run_through_the_kernel_on_card(cuda):
    """A legacy run on the card launches ps_apply once per update and equals
    the same run through the pytree backend bit for bit."""
    spec = TSpec(run=TRun(protocol="softsync", n_softsync=1, n_learners=8,
                          minibatch=4, base_lr=0.05, optimizer="momentum"),
                 problem="mlp_teacher", problem_args={"hidden": 16},
                 steps=12, engine="legacy")
    t_psu.reset_launches()
    res = t_run(spec, device=cuda)
    assert t_psu.launches["ps_apply"] == 12
    prob = spec.resolve_problem()
    ref = t_simulate(spec.run, steps=12,
                     grad_fn=per_arrival_grad(prob.grad_fn),
                     init_params=prob.init(cuda),
                     batch_fn=prob.batch_fn_for(4), ps_backend="reference",
                     device=cuda)
    assert t_psu.launches["ps_apply"] == 12
    for k in ref.params:
        assert torch.equal(res.params[k], ref.params[k]), k
