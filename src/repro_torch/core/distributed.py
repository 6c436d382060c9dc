"""Rudra's protocols as round-based training engines (counterpart of
``repro/core/distributed.py``; DESIGN.md §2).

One process holds every learner, so the n-softsync protocol is realised as
**round-based softsync**: one training round = n sequential PS update
events.  All λ learners (shard groups of the batch axis) compute gradients
against the round-start weights θ(i); event j folds the mean gradient of
group j with staleness σ_j = j, so σ ∈ {0..n−1} and ⟨σ⟩ = (n−1)/2.  The LR
policy sees that measured ⟨σ⟩.

Two engines, the reference's:

* ``sequential`` — faithful semantics.  A loop over the n groups (the
  reference's ``lax.scan``): each event takes that group's gradient
  (backward over B/n samples) at θ(i) and applies the update at once.  The
  port keeps θ(i) apart from the weights it updates: every optimizer event
  makes new tensors (``optim.apply_single``), so θ(i) stays the round-start
  tree the whole round.
* ``fused`` — the n events folded into ONE staleness-weighted gradient
  combination, one backward over a per-sample-weighted loss.  Exact for
  sgd; for momentum the round applies the affine fold
  (``optim.sequential_fold``, ``optim.apply_round_folded``).

Gradients come from autograd (``torch.autograd.grad``) on the plain layers:
no Pallas kernel of the reference has a backward, so the reference trains
through its jnp layers too, and :func:`check_trainable` refuses the
forward-only kernel paths (``attn_impl="pallas"``, ``use_pallas``).  A
bf16 leaf gets a bf16 gradient, as under ``jax.grad``; micro-batch
accumulation sums in fp32.  Every applyUpdate routes through
``repro_torch.optim``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch.config import RunConfig
from repro_torch.core.lr_policies import hardsync_lr
from repro_torch.optim.flatten import tree_map


def check_trainable(run: RunConfig) -> None:
    """Raise when ``run`` selects a forward-only kernel path.  The flash,
    ssm and wkv6 kernels (and the reference's Pallas kernels) have no
    backward: a graph through them would leave the attention, mamba and
    rwkv weights without a gradient."""
    if run.attn_impl == "pallas" or run.use_pallas:
        raise ValueError(
            f"training needs a differentiable forward: attn_impl="
            f"{run.attn_impl!r}, use_pallas={run.use_pallas} select the "
            f"flash / ssm_scan / wkv6 kernels, which have no backward (nor "
            f"do the reference's Pallas kernels); train with "
            f"attn_impl='chunked' (or 'naive') and use_pallas=False")


# ---------------------------------------------------------------------------
# per-event learning rates for one round
# ---------------------------------------------------------------------------
def round_event_lrs(run: RunConfig, n: int) -> np.ndarray:
    """LR for each of the n update events in a round.

    staleness_inverse: uniform α₀/⟨σ⟩ with the engine's measured ⟨σ⟩=(n−1)/2.
    per_gradient (footnote 3): event j gets α₀/max(1, σ_j) with σ_j = j.
    """
    if run.lr_policy == "per_gradient":
        return np.array([run.base_lr / max(1.0, float(j)) for j in range(n)])
    if run.lr_policy == "staleness_inverse":
        sigma = max(1.0, (n - 1) / 2.0)
        return np.full((n,), run.base_lr / sigma)
    if run.lr_policy == "sqrt_scale":
        return np.full((n,), hardsync_lr(run))
    return np.full((n,), run.base_lr)


def fused_coefficients(run: RunConfig, n: int) -> Tuple[np.ndarray, float]:
    """Fold n sequential momentum updates into one combination: (per-group
    gradient coefficients c_i of the θ update, velocity-carry coefficient
    Σ_j lr_j m^{j+1}).  For plain SGD (m = 0) the coefficients are exactly
    the per-event LRs."""
    fold = _round_fold(run, n)
    return np.asarray(fold.theta_coef), fold.v0_coef


def _round_fold(run: RunConfig, n: int) -> optim.RoundFold:
    lrs = round_event_lrs(run, n)
    m = run.momentum if run.optimizer == "momentum" else 0.0
    return optim.sequential_fold(lrs, m)


# ---------------------------------------------------------------------------
# optimizer state (all applyUpdate math lives in repro_torch.optim)
# ---------------------------------------------------------------------------
def init_opt_state(run: RunConfig, params) -> dict:
    return optim.init_state(optim.spec_from_run(run), params)


# ---------------------------------------------------------------------------
# gradient computation with optional micro-batch accumulation
# ---------------------------------------------------------------------------
def _rows(tree, lo: int, hi: int):
    """Rows [lo, hi) of every leaf of a batch (views)."""
    return tree_map(lambda x: x[lo:hi], tree)


def _value_and_grad(loss_fn: Callable, params, batch, sample_weights):
    """(loss, metrics, grads) of one backward at ``params``; the
    parameters' own tensors are not marked (detached leaves are)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = []
    tree_map(flat.append, leaves)
    if sample_weights is None:
        loss, metrics = loss_fn(leaves, batch)
    else:
        loss, metrics = loss_fn(leaves, batch, sample_weights=sample_weights)
    # a leaf the loss does not read (an audio model's token embedding)
    # gets a zero gradient, as under jax.grad
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), tree_map(lambda m: m.detach(), metrics),
            tree_map(lambda _: next(grads), leaves))


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def grad_with_accum(loss_fn: Callable, params, batch, num_microbatches: int,
                    sample_weights=None):
    """value_and_grad with gradient accumulation over micro-batches (the
    batch's leading axis split in ``num_microbatches`` equal slices, in
    order).  Returns (loss, metrics, grads); accumulated gradients are fp32,
    and the metrics are the last micro-batch's."""
    if num_microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch, sample_weights)
    per = _first_leaf(batch).shape[0] // num_microbatches
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss_sum = 0.0
    for i in range(num_microbatches):
        w = (None if sample_weights is None
             else sample_weights[i * per:(i + 1) * per])
        loss, metrics, g = _value_and_grad(
            loss_fn, params, _rows(batch, i * per, (i + 1) * per), w)
        g_acc = tree_map(lambda a, x: a + x.to(torch.float32), g_acc, g)
        loss_sum = loss_sum + loss
    grads = tree_map(lambda g: g / num_microbatches, g_acc)
    return loss_sum / num_microbatches, metrics, grads


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def make_hardsync_step(run: RunConfig, loss_fn: Callable):
    """Standard data-parallel step: Δθ = mean over the global batch ≡ Eq. 3.
    LR follows the paper's hardsync scaling when lr_policy = sqrt_scale."""
    check_trainable(run)
    lr = hardsync_lr(run) if run.lr_policy == "sqrt_scale" else run.base_lr
    spec = optim.spec_from_run(run)

    def step(params, opt, batch):
        loss, metrics, grads = grad_with_accum(
            loss_fn, params, batch, run.num_microbatches)
        params_new, opt_new = optim.apply_single(spec, params, opt, grads, lr)
        return params_new, opt_new, metrics

    return step


def make_softsync_step(run: RunConfig, loss_fn: Callable,
                       engine: str = "sequential"):
    """Round-based n-softsync (DESIGN.md §2).  One call = one round = n
    update events.  The global batch is split into n logical learner groups
    along the batch axis."""
    check_trainable(run)
    n = max(1, run.n_softsync)
    if run.protocol == "async":
        n = run.n_learners

    if engine == "fused":
        return _make_fused_softsync_step(run, loss_fn, n)
    if engine != "sequential":
        raise ValueError(f"unknown engine {engine!r}")

    # the reference's fp32 per-event LRs
    lrs = [float(x) for x in round_event_lrs(run, n).astype(np.float32)]
    spec = optim.spec_from_run(run)

    def step(params, opt, batch):
        per = _first_leaf(batch).shape[0] // n
        theta0 = params      # round-start weights: all groups' grads use θ(i)
        loss_sum = 0.0
        for j in range(n):
            loss, metrics, grads = grad_with_accum(
                loss_fn, theta0, _rows(batch, j * per, (j + 1) * per),
                run.num_microbatches)
            params, opt = optim.apply_single(spec, params, opt, grads,
                                             lrs[j])
            loss_sum = loss_sum + loss
        metrics = dict(metrics)
        metrics["loss_round_mean"] = loss_sum / n
        return params, opt, metrics

    return step


def _make_fused_softsync_step(run: RunConfig, loss_fn: Callable, n: int):
    """Fused engine: one backward pass over a per-sample-weighted loss.

    The per-group θ-update coefficients c_i (fused_coefficients) become
    per-sample loss weights w_s = n·c_{g(s)} / Σc, so the single mean
    gradient equals Σ_i c_i · mean_{s∈i}(g_s) / (Σ_i c_i).  SGD / adagrad /
    adamw then do one apply with lr = Σ_i c_i; momentum applies the exact
    affine round fold (θ gets the v0_coef velocity carry, v advances by
    (m^n, Σ m^{n−1−i}))."""
    fold = _round_fold(run, n)
    coef = np.asarray(fold.theta_coef)
    total = float(coef.sum())
    group_w = torch.from_numpy((coef / coef.mean()).astype(np.float32))
    spec = optim.spec_from_run(run)

    def step(params, opt, batch):
        first = _first_leaf(batch)
        per_sample_w = torch.repeat_interleave(
            group_w.to(first.device), first.shape[0] // n)       # (B,)
        loss, metrics, grads = grad_with_accum(
            loss_fn, params, batch, run.num_microbatches,
            sample_weights=per_sample_w)
        # grads is the weighted MEAN (1/n)Σ_i (c_i/c̄)·mean_i = Σ_i c_i·mean_i/Σc,
        # so applying with total weight Σ_i c_i reproduces θ₀ − Σ_i c_i·mean_i.
        if run.optimizer == "momentum":
            params, opt = optim.apply_round_folded(spec, params, opt, grads,
                                                   fold)
        else:
            params, opt = optim.apply_single(spec, params, opt, grads, total)
        return params, opt, metrics

    return step


def make_train_step(run: RunConfig, loss_fn: Callable,
                    engine: str = "sequential"):
    """``step(params, opt, batch) -> (params, opt, metrics)``: one hardsync
    step or one softsync round.  ``params`` and ``opt`` are never written:
    each step returns new trees."""
    if run.protocol == "hardsync":
        return make_hardsync_step(run, loss_fn)
    return make_softsync_step(run, loss_fn, engine=engine)
