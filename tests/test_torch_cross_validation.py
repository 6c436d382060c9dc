"""The port's counterparts of ``tests/test_cross_validation.py``: its two
implementations of the paper's protocols — the event-driven simulator
(host PS, per-arrival semantics: ``core/simulator.py``) and the round
engines (``core/distributed.py``) — agree wherever their semantics
coincide (hardsync exactly up to rounding; round-based softsync per the
documented round structure), and each agrees with the reference's.

The problem is the reference's: W and X are ``jax.random.normal`` draws,
rebuilt bitwise by ``data/threefry.py`` (held here), so the port needs no
weights carried across.  Tolerances as in the reference's tests: 1e-6
(sgd), 1e-5 (momentum, three rounds); against the reference's own result
1e-6 absolute.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRunConfig
from repro.core import simulate as jsimulate
from repro_torch.config import RunConfig
from repro_torch.core import (init_opt_state, make_train_step,
                              round_event_lrs, simulate)
from repro_torch.data import threefry


def _problem():
    W = threefry.normal(threefry.prng_key(0), (6, 3))
    X = threefry.normal(threefry.prng_key(1), (32, 6))
    return W, X, X @ W


def test_problem_is_the_reference_draw():
    W, X, _ = _problem()
    np.testing.assert_array_equal(
        W, np.asarray(jax.random.normal(jax.random.PRNGKey(0), (6, 3))))
    np.testing.assert_array_equal(
        X, np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 6))))


def _loss(p, b):
    x, y = b
    return torch.mean((x @ p - y) ** 2)


def _grad_fn(p, b):
    p = p.detach().requires_grad_(True)
    return torch.autograd.grad(_loss(p, b), p)[0]


def _eng_loss(p, b, sample_weights=None):
    per = torch.mean((b["x"] @ p - b["y"]) ** 2, dim=-1)
    if sample_weights is not None:
        per = per * sample_weights
    return torch.mean(per), {"loss": torch.mean(per)}


def _reference_sim(run_kw, steps, mu):
    _, X, Y = _problem()

    def loss(p, b):
        x, y = b
        return jnp.mean((x @ p - y) ** 2)

    def batch_fn(l, step):
        return X[l * mu:(l + 1) * mu], Y[l * mu:(l + 1) * mu]
    return np.asarray(jsimulate(JRunConfig(**run_kw), steps=steps,
                                grad_fn=jax.jit(jax.grad(loss)),
                                init_params=jnp.zeros((6, 3)),
                                batch_fn=batch_fn).params)


@pytest.mark.parametrize("optimizer,steps,atol", [("sgd", 1, 1e-6),
                                                  ("momentum", 3, 1e-5)])
def test_hardsync_simulator_equals_engine(optimizer, steps, atol):
    """``steps`` hardsync updates with λ learners == ``steps`` engine steps
    on the same global batch (Eq. 3 is a mean either way); the simulator
    through the host PS's ``ps_apply`` path (its plain version here)."""
    _, X, Y = _problem()
    lam, mu = 4, 8
    run_kw = dict(protocol="hardsync", n_learners=lam, minibatch=mu,
                  base_lr=0.1 if optimizer == "sgd" else 0.05,
                  lr_policy="const", optimizer=optimizer, momentum=0.9,
                  seed=0)
    run = RunConfig(**run_kw)
    x, y = torch.from_numpy(X), torch.from_numpy(Y)

    def batch_fn(l, step):
        return X[l * mu:(l + 1) * mu], Y[l * mu:(l + 1) * mu]

    sim = simulate(run, steps=steps, grad_fn=_grad_fn,
                   init_params=torch.zeros((6, 3)), batch_fn=batch_fn,
                   device="cpu")
    step = make_train_step(run, _eng_loss)
    p = torch.zeros((6, 3))
    opt = init_opt_state(run, p)
    for _ in range(steps):
        p, opt, _ = step(p, opt, {"x": x, "y": y})
    np.testing.assert_allclose(sim.params.numpy(), p.numpy(), atol=atol)
    np.testing.assert_allclose(sim.params.numpy(),
                               _reference_sim(run_kw, steps, mu), atol=1e-6)


def test_round_softsync_staleness_differs_from_pipelined_as_documented():
    """DESIGN.md §2: the round engine has ⟨σ⟩ = (n−1)/2; the pipelined
    simulator has ⟨σ⟩ ≈ n.  Both are staleness-bounded; the LR policy uses
    each engine's own measurement."""
    n, lam = 8, 16
    kw = dict(protocol="softsync", n_softsync=n, n_learners=lam,
              minibatch=4, base_lr=1.0, lr_policy="staleness_inverse",
              seed=2)
    sim = simulate(RunConfig(**kw), steps=600, device="cpu")
    sim_sigma = sim.clock_log.mean_staleness()
    assert abs(sim_sigma - n) < 0.25 * n + 1          # pipelined: ≈ n
    assert sim_sigma == jsimulate(JRunConfig(**kw),
                                  steps=600).clock_log.mean_staleness()
    lrs = round_event_lrs(RunConfig(**kw), n)
    assert np.allclose(lrs, 1.0 / ((n - 1) / 2))      # round: ⟨σ⟩=(n−1)/2
