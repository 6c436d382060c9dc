"""The port's training path (``core/distributed.py``, ``models.model_loss``,
``train/loop.py``, the round fold of ``optim``) against the reference on
the same inputs: weights carried across (``experiments/carry.py``),
batches from numpy.

Tolerances (fp32):

* ``model_loss`` and its gradient on the ``SMOKE`` configs with the naive
  attention: the loss within 1e-5 relative, every gradient leaf within
  2e-5 of its largest magnitude (measured ≤ 8.3e-6: matmul and reduction
  orders differ).  With the chunked attention (the training default) the
  P·V product rounds probabilities and values to bf16 in both packages, so
  a probability that lands on the other side of a bf16 rounding in one
  framework moves its gradient by a bf16 ulp (2⁻⁸ relative): held within
  1e-2 of the leaf's largest magnitude (measured 2.8e-3).
* One round of each engine: parameters and optimizer state within 1e-5 of
  the leaf's largest magnitude on ``SMOKE`` qwen2, within 1e-6 absolute
  plus 1e-5 relative on the reference's quadratic.
* ``sequential_fold``, ``round_event_lrs``, ``fused_coefficients``:
  bitwise (host float64 numpy in both).
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import RunConfig as JRunConfig
from repro.configs import get_smoke as jget_smoke
from repro.core import distributed as jdist
from repro.models import init_model as jinit_model
from repro.models import model_loss as jmodel_loss
from repro.optim import sequential_fold as jsequential_fold
from repro.train.loop import train as jtrain
from repro_torch.checkpoint.io import _paths
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.configs import get_smoke
from repro_torch.core import distributed as dist
from repro_torch.experiments.carry import model_params_from_jax, tree_from_jax
from repro_torch.kernels import ops as kops
from repro_torch.models import model_loss
from repro_torch.optim import sequential_fold
from repro_torch.train.loop import train

ARCHS = ["qwen2_1_5b", "zamba2_7b", "rwkv6_7b"]
OPTIMIZERS = ["sgd", "momentum", "adagrad", "adamw"]
POLICIES = ["const", "staleness_inverse", "sqrt_scale", "per_gradient"]
B, S = 8, 8


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _leaves(tree):
    """{path: fp32 numpy array} of a port or reference tree."""
    out = {}
    for key, leaf in _paths(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().to(torch.float32).numpy()
        out[key] = np.asarray(leaf, np.float32)
    return out


def held(ref_tree, port_tree, rel, atol=0.0, what=""):
    """Every leaf within ``rel`` of its largest magnitude (+ ``atol``);
    returns the worst share of that bound."""
    ref, got = _leaves(_np(ref_tree)), _leaves(port_tree)
    assert sorted(ref) == sorted(got), what
    worst = 0.0
    for k in ref:
        bound = rel * float(np.max(np.abs(ref[k]))) + atol
        err = float(np.max(np.abs(ref[k] - got[k]))) if ref[k].size else 0.0
        assert err <= bound, f"{what} {k}: |diff| {err} > {bound}"
        worst = max(worst, err / bound if bound else 0.0)
    return worst


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "loss_mask": (rng.uniform(size=(b, s)) < 0.9).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke(arch), dtype=dtype, **kw))


@pytest.fixture(scope="module")
def carried():
    """Per arch: (reference cfg, reference params, port cfg, port params),
    fp32, the reference's draw carried across."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jp = jinit_model(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, cfg, model_params_from_jax(_np(jp), cfg,
                                                          "cpu"))
    return out


# ---------------------------------------------------------------------------
# model_loss and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,impl", [(a, "naive") for a in ARCHS]
                         + [("qwen2_1_5b", "chunked")])
def test_model_loss_and_grad_match_reference(carried, arch, impl):
    jcfg, jp, cfg, tp = carried[arch]
    kw = dict(attn_impl=impl, attn_q_chunk=4, attn_kv_chunk=4)
    batch = _batch(cfg)
    w = np.random.default_rng(1).uniform(0.5, 1.5, B).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel_loss(jcfg, JRunConfig(**kw), p, _jb(batch),
                              sample_weights=jnp.asarray(w)),
        has_aux=True)(jp)
    loss, metrics, g = dist.grad_with_accum(
        lambda p, b, sample_weights=None: model_loss(
            cfg, RunConfig(**kw), p, b, sample_weights=sample_weights),
        tp, _tb(batch), 1, sample_weights=torch.from_numpy(w))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert sorted(metrics) == sorted(jm)
    assert float(metrics["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    held(jg, g, 2e-5 if impl == "naive" else 1e-2, what=f"{arch} {impl}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_vocab_columns_get_zero_gradient(dtype):
    """qwen2's vocab 151 936 pads to 152 064, so ``_mask_padded`` writes
    the logits in place: autograd takes the write, the padded head columns
    get exactly zero gradient (the reference's ``where`` does the same),
    and the live columns agree with the reference's."""
    jcfg, cfg = _cfgs("qwen2_1_5b", dtype, vocab_size=500)
    assert cfg.padded_vocab == 512
    jp = jinit_model(jcfg, jax.random.PRNGKey(3))
    tp = model_params_from_jax(_np(jp), cfg, "cpu")
    batch = _batch(cfg, seed=2)
    run = dict(attn_impl="naive")
    jg = jax.grad(lambda p: jmodel_loss(jcfg, JRunConfig(**run), p,
                                        _jb(batch))[0])(jp)
    _, _, g = dist.grad_with_accum(
        lambda p, b: model_loss(cfg, RunConfig(**run), p, b), tp,
        _tb(batch), 1)
    assert g["head"].dtype == tp["head"].dtype     # bf16 leaf, bf16 grad
    assert torch.count_nonzero(g["head"][:, cfg.vocab_size:]) == 0
    assert not np.asarray(jg["head"], np.float32)[:, cfg.vocab_size:].any()
    if dtype == "float32":
        held(jg, g, 2e-5, what="padded vocab")


# ---------------------------------------------------------------------------
# the engines against make_train_step
# ---------------------------------------------------------------------------
def _quad_problem():
    W = jax.random.normal(jax.random.PRNGKey(0), (8, 4))
    X = jax.random.normal(jax.random.PRNGKey(1), (64, 8))
    return {"x": np.asarray(X), "y": np.asarray(X @ W)}


def _jquad_loss(p, batch, sample_weights=None):
    per = jnp.mean((batch["x"] @ p - batch["y"]) ** 2, axis=-1)
    if sample_weights is not None:
        per = per * sample_weights
    return jnp.mean(per), {"loss": jnp.mean(per), "ce": jnp.mean(per)}


def _quad_loss(p, batch, sample_weights=None):
    per = torch.mean((batch["x"] @ p - batch["y"]) ** 2, dim=-1)
    if sample_weights is not None:
        per = per * sample_weights
    return torch.mean(per), {"loss": torch.mean(per), "ce": torch.mean(per)}


def _run_both(run_kw, jloss, tloss, jp0, tp0, jbatch, tbatch, engine,
              rounds=2):
    jrun, run = JRunConfig(**run_kw), RunConfig(**run_kw)
    jstep = jax.jit(jdist.make_train_step(jrun, jloss, engine=engine))
    step = dist.make_train_step(run, tloss, engine=engine)
    jp, jo = jp0, jdist.init_opt_state(jrun, jp0)
    tp, to = tp0, dist.init_opt_state(run, tp0)
    for _ in range(rounds):
        jp, jo, jm = jstep(jp, jo, jbatch)
        tp, to, tm = step(tp, to, tbatch)
    return (jp, jo, jm), (tp, to, tm)


QUAD_CASES = ([(e, o, "staleness_inverse") for e in ("hardsync", "sequential",
                                                      "fused")
               for o in OPTIMIZERS]
              + [(e, "momentum", p) for e in ("sequential", "fused")
                 for p in POLICIES if p != "staleness_inverse"]
              + [("fused", "sgd", p) for p in ("const", "per_gradient")])


@pytest.mark.parametrize("engine,optimizer,policy", QUAD_CASES)
def test_engines_match_reference_on_quadratic(engine, optimizer, policy):
    prob = _quad_problem()
    protocol = "hardsync" if engine == "hardsync" else "softsync"
    run_kw = dict(protocol=protocol, n_softsync=4, n_learners=8,
                  minibatch=8, base_lr=0.05, lr_policy=policy,
                  optimizer=optimizer)
    p0 = np.zeros((8, 4), np.float32)
    (jp, jo, jm), (tp, to, tm) = _run_both(
        run_kw, _jquad_loss, _quad_loss, jnp.asarray(p0),
        torch.from_numpy(p0), _jb(prob), _tb(prob),
        "sequential" if engine == "hardsync" else engine)
    held(jp, tp, 1e-5, 1e-6, "params")
    held(jo, to, 1e-5, 1e-6, "opt state")
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    if engine == "sequential":
        assert float(tm["loss_round_mean"]) == pytest.approx(
            float(jm["loss_round_mean"]), rel=1e-5)


@pytest.mark.parametrize("engine", ["hardsync", "sequential", "fused"])
def test_engines_match_reference_on_smoke_qwen2(carried, engine):
    """A round of each engine on ``SMOKE`` qwen2 in fp32 (momentum,
    staleness_inverse, n = 4 groups of 2 sequences: the chip's setting at
    a reduced width), from the state the reference reached after one round
    (weights and a nonzero velocity carried across)."""
    jcfg, jp, cfg, _ = carried["qwen2_1_5b"]
    run_kw = dict(protocol="hardsync" if engine == "hardsync" else
                  "softsync", n_softsync=4, n_learners=8, minibatch=1,
                  base_lr=0.05, lr_policy="staleness_inverse",
                  optimizer="momentum", attn_impl="naive")
    jrun, run = JRunConfig(**run_kw), RunConfig(**run_kw)
    eng = "sequential" if engine == "hardsync" else engine
    jstep = jax.jit(jdist.make_train_step(
        jrun, lambda p, b, sample_weights=None: jmodel_loss(
            jcfg, jrun, p, b, sample_weights=sample_weights), engine=eng))
    step = dist.make_train_step(
        run, lambda p, b, sample_weights=None: model_loss(
            cfg, run, p, b, sample_weights=sample_weights), engine=eng)
    jp1, jo1, _ = jstep(jp, jdist.init_opt_state(jrun, jp),
                        _jb(_batch(cfg, seed=4)))
    tp1 = model_params_from_jax(_np(jp1), cfg, "cpu")
    to1 = tree_from_jax(_np(jo1), "cpu")
    batch = _batch(cfg, seed=5)
    jp2, jo2, _ = jstep(jp1, jo1, _jb(batch))
    tp2, to2, _ = step(tp1, to1, _tb(batch))
    held(jp2, tp2, 1e-5, what=f"{engine} params")
    held(jo2, to2, 1e-5, what=f"{engine} velocity")
    # θ(i) stays the round-start weights: the step wrote nothing in place
    held(jp1, tp1, 0.0, what="round-start weights")
    held(jo1, to1, 0.0, what="round-start velocity")


@pytest.mark.parametrize("m", [1, 4])
def test_microbatch_accumulation(m):
    """Micro-batches sum their gradients in fp32: the port against the
    reference at the same count, and 4 against 1 (the reference's own
    check, within 1e-5)."""
    prob = _quad_problem()
    p0 = np.zeros((8, 4), np.float32)
    outs = []
    for mm in sorted({1, m}):
        run_kw = dict(protocol="hardsync", n_learners=4, minibatch=16,
                      base_lr=0.1, optimizer="sgd", num_microbatches=mm)
        (jp, _, _), (tp, _, _) = _run_both(
            run_kw, _jquad_loss, _quad_loss, jnp.asarray(p0),
            torch.from_numpy(p0), _jb(prob), _tb(prob), "sequential",
            rounds=1)
        held(jp, tp, 1e-5, 1e-6, f"microbatches {mm}")
        outs.append(tp)
    np.testing.assert_allclose(outs[0].numpy(), outs[-1].numpy(), atol=1e-5)


def test_fused_equals_sequential_sgd():
    """The reference's own check on the port: fused ≡ sequential for sgd
    within 1e-6 (tests/test_system.py)."""
    prob = _tb(_quad_problem())
    p0 = torch.zeros((8, 4))
    for policy in ("staleness_inverse", "per_gradient", "const"):
        run = RunConfig(protocol="softsync", n_softsync=4, n_learners=8,
                        minibatch=8, base_lr=0.05, lr_policy=policy,
                        optimizer="sgd")
        p1, _, _ = dist.make_train_step(run, _quad_loss, "sequential")(
            p0, dist.init_opt_state(run, p0), prob)
        p2, _, _ = dist.make_train_step(run, _quad_loss, "fused")(
            p0, dist.init_opt_state(run, p0), prob)
        np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=1e-6,
                                   err_msg=policy)


@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_sequential_fold_and_round_lrs_bitwise(momentum):
    for n in (1, 2, 4, 7):
        for policy in POLICIES:
            kw = dict(protocol="softsync", n_softsync=n, n_learners=8,
                      minibatch=4, base_lr=0.3, lr_policy=policy,
                      optimizer="momentum", momentum=momentum)
            ref = jdist.round_event_lrs(JRunConfig(**kw), n)
            got = dist.round_event_lrs(RunConfig(**kw), n)
            np.testing.assert_array_equal(got, ref)
            a, b = jsequential_fold(ref, momentum), sequential_fold(got,
                                                                    momentum)
            np.testing.assert_array_equal(b.theta_coef, a.theta_coef)
            assert (b.v0_coef, b.v_decay, b.v_gain) == (
                a.v0_coef, a.v_decay, a.v_gain)
            rc, rv = jdist.fused_coefficients(JRunConfig(**kw), n)
            gc, gv = dist.fused_coefficients(RunConfig(**kw), n)
            np.testing.assert_array_equal(gc, rc)
            assert gv == rv


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=64)


def test_warmstart_matches_reference():
    """§5.5: two hardsync (sqrt_scale) rounds, then two softsync rounds,
    from the reference's weights, in both packages (fp32)."""
    tiny = dict(TINY, dtype="float32")
    jcfg, cfg = JModelConfig(**tiny), ModelConfig(**tiny)
    run_kw = dict(protocol="softsync", n_softsync=4, n_learners=4,
                  minibatch=2, base_lr=0.02, lr_policy="staleness_inverse",
                  optimizer="momentum", attn_impl="naive")
    jp = jinit_model(jcfg, jax.random.PRNGKey(0))
    tp = model_params_from_jax(_np(jp), cfg, "cpu")
    ref = jtrain(jcfg, JRunConfig(**run_kw), steps=2, batch=8, seq=16,
                 params=jp, warmstart_steps=2)
    got = train(cfg, RunConfig(**run_kw), steps=2, batch=8, seq=16,
                params=tp, warmstart_steps=2, device="cpu")
    held(ref.params, got.params, 1e-5, what="warm-started params")
    held(ref.opt_state, got.opt_state, 1e-5, what="velocity")


def test_train_learns():
    """The reference's own check (bf16, the config's default dtype)."""
    cfg = ModelConfig(**TINY)
    run = RunConfig(protocol="softsync", n_softsync=2, n_learners=4,
                    minibatch=2, base_lr=0.02, lr_policy="staleness_inverse",
                    optimizer="momentum", attn_q_chunk=32, attn_kv_chunk=32)
    res = train(cfg, run, steps=60, batch=8, seq=32, eval_every=30,
                engine="fused", device="cpu")
    assert res.history[-1]["ce"] < res.history[0]["ce"]
    assert np.isfinite(res.history[-1]["ce"])


# ---------------------------------------------------------------------------
# the forward-only kernels refuse a graph
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(attn_impl="pallas"),
                                dict(use_pallas=True)],
                         ids=["attn_impl=pallas", "use_pallas"])
def test_kernel_paths_refuse_training(carried, kw):
    _, _, cfg, tp = carried["qwen2_1_5b"]
    run = RunConfig(**kw)
    batch = _tb(_batch(cfg))
    for call in (lambda: model_loss(cfg, run, tp, batch),
                 lambda: dist.make_train_step(run, _quad_loss),
                 lambda: dist.make_hardsync_step(run, _quad_loss),
                 lambda: dist.make_softsync_step(run, _quad_loss, "fused"),
                 lambda: train(ModelConfig(**TINY), run, steps=1, batch=2,
                               seq=8, device="cpu")):
        with pytest.raises(ValueError, match="no backward"):
            call()


def test_kernel_wrappers_refuse_a_graph():
    """On either device the flash / ssm_scan / wkv6 wrappers raise when
    autograd records and an operand needs a gradient (their outputs would
    carry none); without a graph they run (here: the plain versions)."""
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    kv = torch.randn(1, 8, 2, 16)
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    a = -torch.rand(1, 8, 2)
    bc = torch.randn(1, 8, 16)
    r = torch.randn(1, 8, 2, 16, requires_grad=True)
    u = torch.randn(2, 16)
    calls = {"flash_attention": lambda: kops.flash_attention(q, kv, kv),
             "ssm_scan": lambda: kops.ssm_scan(x, a, bc, bc, chunk=4),
             "wkv6": lambda: kops.wkv6(r, r.detach(), r.detach(),
                                       -torch.rand(1, 8, 2, 16), u,
                                       chunk=4)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        with torch.no_grad():
            out = call()
        assert torch.isfinite(out[0] if isinstance(out, tuple)
                              else out).all()
