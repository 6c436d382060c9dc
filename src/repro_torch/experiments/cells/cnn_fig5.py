"""Cell ``cnn`` of the port (counterpart of
``repro/experiments/cells/cnn_fig5.py``, ported as written) — the paper's
CIFAR10 CNN (§4.2: caffe cifar10_full — 3×(conv+pool) + fc, ~90K params)
trained with the protocol stack on a synthetic 32×32×3 image-teacher
task.  This is the architecture-fidelity check for the MLP stand-in of the
fast cells: the Fig-5 LR-modulation claim must reproduce on the *paper's
own network shape* too.

At the defaults (1600 updates, α₀ = 0.15, λ = n = 8) α₀ unmodulated sticks
at ~90 % error (the paper's "constant high error rate of 90%"); α₀/⟨σ⟩
reaches a few %.  In the ``extended`` campaign (not ``paper``) and
``skip_quick``:
    PYTHONPATH=src python -m repro_torch.experiments.campaign extended \
        --only cnn

The initial weights are the reference's ``jax.random`` draw, rebuilt
bitwise by ``data/threefry.py``.  ``torch.nn.functional.conv2d`` (padding
2: "SAME" for a 5×5 kernel) and ``max_pool2d`` are the counterparts of
``lax.conv_general_dilated`` and ``reduce_window``; no Pallas kernel
computes either.  Training runs the legacy per-arrival ``simulate`` with
the gradient from autograd, so on the card every update of the host PS is
one ``ps_apply`` launch (c = λ/n = 1 gradient each: ``updates`` launches
per policy).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device
from repro_torch.data import threefry
from repro_torch.experiments.registry import Cell, Claim, emit, register_cell


# ---------------------------------------------------------------------------
# the paper's CNN (caffe cifar10_full shape): conv32-pool-conv32-pool-
# conv64-pool-fc10, ~90K trainable parameters
# ---------------------------------------------------------------------------
def init_cnn(seed: int = 0, n_classes: int = 10, *, device="cuda"):
    """``init_cnn(jax.random.PRNGKey(seed))`` of the reference, bitwise, on
    ``device`` (default the card; raises without one unless "cpu")."""
    dev = resolve_device(device)
    ks = threefry.split(threefry.prng_key(seed), 4)

    def conv(k, cin, cout, hw=5):
        # 0.5×He: keeps initial logit std ~O(1); full He on this 3-stage
        # conv+pool stack kills the network in its first SGD steps
        return threefry.normal(k, (cout, cin, hw, hw)) * np.float32(
            0.5 * np.sqrt(2.0 / (cin * hw * hw)))

    arrays = {
        "c1": conv(ks[0], 3, 32), "b1": np.zeros((32,), np.float32),
        "c2": conv(ks[1], 32, 32), "b2": np.zeros((32,), np.float32),
        "c3": conv(ks[2], 32, 64), "b3": np.zeros((64,), np.float32),
        "fc": threefry.normal(ks[3], (64 * 4 * 4, n_classes))
        * np.float32(0.02),
        "fb": np.zeros((n_classes,), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def _conv_pool(x, w, b):
    y = F.conv2d(x, w, padding=w.shape[-1] // 2)
    y = torch.relu(y + b[None, :, None, None])
    return F.max_pool2d(y, 2, 2)


def cnn_forward(p, x):
    """x: (B, 3, 32, 32) -> logits (B, 10)."""
    h = _conv_pool(x, p["c1"], p["b1"])
    h = _conv_pool(h, p["c2"], p["b2"])
    h = _conv_pool(h, p["c3"], p["b3"])
    return h.reshape(h.shape[0], -1) @ p["fc"] + p["fb"]


def cnn_loss(p, batch):
    x, y = batch
    logits = cnn_forward(p, x)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(logz - ll)


def cnn_grad(p, batch):
    """The gradient of :func:`cnn_loss` at ``p`` (a new dict; ``p``'s own
    tensors are not marked)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = torch.autograd.grad(cnn_loss(leaves, batch), list(leaves.values()))
    return dict(zip(leaves, grads))


def test_error(p, task: "ImageTeacher") -> float:
    dev = p["fc"].device
    with torch.no_grad():
        logits = cnn_forward(p, torch.from_numpy(task.x_test).to(dev))
        pred = torch.argmax(logits, -1).cpu().numpy()
    return float(1.0 - np.mean((pred == task.y_test).astype(np.float32)))


# ---------------------------------------------------------------------------
# synthetic image teacher task (fixed random prototypes)
# ---------------------------------------------------------------------------
class ImageTeacher:
    """Prototype-based 10-class images: x = 0.6·prototype[y] + noise.
    Learnable by a small CNN with a real margin (Bayes error ≈ 0), which is
    what the Fig-5 divergence-vs-convergence contrast requires.  numpy,
    bitwise the reference's."""

    def __init__(self, n_train: int = 2048, n_test: int = 512, seed: int = 3):
        rng = np.random.default_rng(seed)
        protos = rng.normal(0, 1, (10, 3, 32, 32)).astype(np.float32)

        def make(n):
            y = rng.integers(0, 10, size=n).astype(np.int32)
            x = 0.6 * protos[y] + rng.normal(0, 1, (n, 3, 32, 32)
                                             ).astype(np.float32)
            return x.astype(np.float32), y
        self.x_train, self.y_train = make(n_train)
        self.x_test, self.y_test = make(n_test)
        self.n_train = n_train

    def batch_fn_for(self, mu):
        def fn(l, step):
            rng = np.random.default_rng(l * 99991 + step)
            idx = rng.integers(0, self.n_train, size=mu)
            return self.x_train[idx], self.y_train[idx]
        return fn


LAM, MU, N = 8, 16, 8
POLICIES = ("const", "staleness_inverse")


def compute(updates: int = 1600, base_lr: float = 0.15, device="cuda"):
    from repro_torch.config import RunConfig
    from repro_torch.core.simulator import simulate

    dev = resolve_device(device)
    task = ImageTeacher()
    params = init_cnn(0, device=dev)
    n_params = sum(int(v.numel()) for v in params.values())
    emit("cnn/params", n_params, "paper: ~90K")

    out = {"n_params": n_params}
    for policy in POLICIES:
        cfg = RunConfig(protocol="softsync", n_softsync=N, n_learners=LAM,
                        minibatch=MU, base_lr=base_lr, lr_policy=policy,
                        optimizer="sgd", seed=1)
        res = simulate(cfg, steps=updates, grad_fn=cnn_grad,
                       init_params=params, batch_fn=task.batch_fn_for(MU),
                       device=dev)
        err = test_error(res.params, task)
        out[policy] = err
        emit(f"cnn_fig5/{policy}/test_error", f"{err:.4f}",
             f"<sigma>={res.clock_log.mean_staleness():.1f}")
    helps = _modulation_helps(out)
    emit("cnn_fig5/modulation_helps_on_paper_cnn", helps,
         f"{out['staleness_inverse']:.3f} vs {out['const']:.3f}")
    return [], out


def _modulation_helps(d) -> bool:
    return ((not np.isfinite(d["const"]))
            or d["staleness_inverse"] <= d["const"] + 1e-6)


register_cell(Cell(
    name="cnn", result="cnn_fig5",
    title="Fig. 5 on the paper's own CNN shape",
    compute=compute, campaigns=("extended",), skip_quick=True,
    claims=(Claim("modulation_helps_on_paper_cnn", _modulation_helps),),
    params={"updates": 1600, "base_lr": 0.15}))
