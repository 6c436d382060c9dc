"""The port's ``cnn`` cell (``experiments/cells/cnn_fig5.py``) against the
reference's: the paper's CIFAR CNN (§4.2), its initial weights, its loss
and gradient, the image-teacher task and the cell at a tiny budget.

* ``init_cnn`` is the reference's ``jax.random`` draw, rebuilt bitwise by
  ``data/threefry.py``; the task's images, labels and minibatches are the
  reference's numpy draws, bitwise.
* The loss within 1e-6 relative and each gradient leaf within 1e-5 of its
  largest magnitude (measured 9.2e-7: convolution summation orders
  differ).
* The cell at 8 updates a policy on the CPU: both test errors within 2 of
  the 512 test samples of the reference's ``compute`` (the same weights,
  batches and schedule; only rounding differs).

``python tests/test_torch_cnn.py [updates]`` prints how far one-ulp
changes of every initial weight move the cell's two test errors on the
CPU at ``updates`` (default 40) — the basis of ``chip_smoke.py``'s
``CNN_SPREAD``, which holds the card's run against the CPU's.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments.cells import cnn_fig5 as R
from repro_torch.experiments import campaign, registry
from repro_torch.experiments.cells import cnn_fig5 as P


def _batch(seed=0, b=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def test_init_cnn_is_the_reference_draw():
    ref = R.init_cnn(jax.random.PRNGKey(0))
    got = P.init_cnn(0, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    # paper §4.2: "~90K trainable parameters"
    assert 85_000 <= sum(v.numel() for v in got.values()) <= 95_000


def test_forward_shape_finite_and_cool():
    p = P.init_cnn(0, device="cpu")
    logits = P.cnn_forward(p, torch.from_numpy(_batch(1, 4)[0]))
    assert logits.shape == (4, 10)
    assert torch.isfinite(logits).all()
    assert float(torch.std(logits)) < 3.0      # the 0.5×He init's point


def test_loss_and_gradient_match_reference():
    jp = R.init_cnn(jax.random.PRNGKey(0))
    tp = P.init_cnn(0, device="cpu")
    x, y = _batch(2)
    jl, jg = jax.value_and_grad(R.cnn_loss)(jp, (jnp.asarray(x),
                                                 jnp.asarray(y)))
    tb = (torch.from_numpy(x), torch.from_numpy(y))
    assert float(P.cnn_loss(tp, tb)) == pytest.approx(float(jl), rel=1e-6)
    g = P.cnn_grad(tp, tb)
    assert not any(v.requires_grad for v in tp.values())
    for k in jg:
        ref = np.asarray(jg[k])
        err = float(np.max(np.abs(g[k].numpy() - ref)))
        assert err <= 1e-5 * float(np.max(np.abs(ref))), k


def test_image_teacher_is_the_reference_task():
    ref, got = R.ImageTeacher(), P.ImageTeacher()
    for name in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    for l, step in ((0, 0), (5, 17)):
        jx, jy = ref.batch_fn_for(16)(l, step)
        x, y = got.batch_fn_for(16)(l, step)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


def test_cell_at_a_tiny_budget_matches_reference(tmp_path):
    params = {"updates": 8, "base_lr": 0.15}
    _, ref = R.compute(**params)
    derived = campaign.run_cell("cnn", params, results_dir=str(tmp_path),
                                device="cpu")
    assert derived["n_params"] == ref["n_params"]
    for policy in P.POLICIES:
        assert abs(derived[policy] - ref[policy]) * 512 <= 2, policy
    env = registry.load_envelope("cnn", str(tmp_path))
    assert set(env["campaign"]["claims"]) == {
        "modulation_helps_on_paper_cnn"}
    assert "cnn" in [c.name for c in registry.cells_in("extended")]
    assert "cnn" not in [c.name for c in registry.cells_in("paper")]


def cnn_sensitivity(updates: int = 40, draws: int = 16) -> dict:
    """The cell's two test errors at ``updates`` on the CPU, from the
    reference's weights and again from ``draws`` copies with every initial
    weight moved by one ulp up or down at random (seeded) — a stand-in for
    a device whose every operation rounds differently.  Returns (and
    prints) each policy's largest change, in test samples of 512."""
    from repro_torch.config import RunConfig
    from repro_torch.core.simulator import simulate

    task = P.ImageTeacher()
    base = P.init_cnn(0, device="cpu")

    def errors(params):
        out = {}
        for policy in P.POLICIES:
            run = RunConfig(protocol="softsync", n_softsync=P.N,
                            n_learners=P.LAM, minibatch=P.MU, base_lr=0.15,
                            lr_policy=policy, optimizer="sgd", seed=1)
            res = simulate(run, steps=updates, grad_fn=P.cnn_grad,
                           init_params=params,
                           batch_fn=task.batch_fn_for(P.MU), device="cpu")
            out[policy] = round(P.test_error(res.params, task) * 512)
        return out

    ref = errors(base)
    moved = {p: [] for p in P.POLICIES}
    rng = np.random.default_rng(0)
    for _ in range(draws):
        params = {}
        for k, v in base.items():
            a = v.numpy()
            up = rng.integers(0, 2, a.shape).astype(bool)
            params[k] = torch.from_numpy(np.where(
                up, np.nextafter(a, np.float32(np.inf)),
                np.nextafter(a, np.float32(-np.inf))).astype(np.float32))
        for p, e in errors(params).items():
            moved[p].append(e)
    spread = {p: max(abs(e - ref[p]) for e in moved[p]) for p in moved}
    for p in P.POLICIES:
        print(f"cnn at {updates} updates, {p}: {ref[p]} of 512 test samples "
              f"wrong; from {draws} draws of one-ulp changes of every "
              f"weight {moved[p]}; largest change {spread[p]} samples")
    return spread


if __name__ == "__main__":
    import sys
    cnn_sensitivity(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
