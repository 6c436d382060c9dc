"""Problem registry of the port (counterpart of ``repro/experiments/problems.py``).

A problem object exposes what the replay engine needs:

* ``init(device)``        — a fresh initial parameter dict on ``device``;
* ``grad_fn(params, batch) -> grads`` — the gradients of all c slots at
  once: every leaf of ``params`` and ``batch`` carries a leading (c,) slot
  dimension (the reference vmaps a per-slot ``jax.grad`` instead);
* ``batch_fn_for(mu, seed)`` / ``stage_minibatches`` — host (numpy)
  batches, deterministic per (seed, learner, step), bitwise the
  reference's (same splitmix64 hash, ``data/synthetic.py``);
* ``eval_fn(params) -> dict`` and ``dataset_size``;
* ``stage_requests`` / ``request_metric`` — the serving lane's hooks
  (``MLPProblem``): the request draw, bitwise the reference's, and the
  metric of a chunk of requests in one call.

``MLPProblem.init`` draws the reference's initial weights: the same
``jax.random.normal`` stream, reproduced in numpy (``data/threefry.py``;
within 3 ulps of the reference's values, most of them bitwise).  To start
from the reference's exact weights, carry them across with
``experiments/carry.py`` and pass them as ``driver.run(spec, init=...)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.data import threefry
from repro_torch.data.synthetic import TeacherClassification


def updates_for_epochs(epochs: float, mu: int, c: int, dataset: int,
                       group_size: int = 1) -> int:
    """Weight updates s.t. total samples == epochs·dataset (every update
    consumes c·μ·gs samples)."""
    return max(1, int(epochs * dataset / (mu * c * group_size)))


# ---------------------------------------------------------------------------
# MLP learner on the teacher-classification task (the paper's CNN stand-in)
# ---------------------------------------------------------------------------
class MLPProblem:
    """2-layer tanh MLP trained on TeacherClassification — the accuracy-axis
    vehicle of the paper's figures and tables."""

    def __init__(self, hidden: int = 64, task: TeacherClassification = None,
                 seed: int = 0):
        self.task = task or TeacherClassification()
        self.hidden = hidden
        self.seed = seed
        self._test_sets: Dict[torch.device, Tuple] = {}
        self._init = None

    @property
    def dataset_size(self) -> int:
        return self.task.n_train

    def init(self, device) -> Dict[str, torch.Tensor]:
        """w ~ N(0, 1/fan_in), zero biases: the reference's draw
        (``PRNGKey(seed)`` split in two, one ``normal`` per weight, divided
        by √fan_in in fp32), made once on the host and copied to
        ``device`` on each call."""
        if self._init is None:
            nf, nc, h = self.task.n_features, self.task.n_classes, self.hidden
            k1, k2 = threefry.split(threefry.prng_key(self.seed))
            self._init = {
                "w1": threefry.normal(k1, (nf, h)) / np.float32(np.sqrt(nf)),
                "w2": threefry.normal(k2, (h, nc)) / np.float32(np.sqrt(h))}
        h, nc = self.hidden, self.task.n_classes
        return {"w1": torch.tensor(self._init["w1"], device=device),
                "b1": torch.zeros(h, device=device),
                "w2": torch.tensor(self._init["w2"], device=device),
                "b2": torch.zeros(nc, device=device)}

    @staticmethod
    def _logits(p, x):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def grad_fn(self, p, batch):
        """Gradients of the mean cross-entropy for c slots at once: ``p``
        leaves (c, …), ``batch`` = (x (c, μ, F), y (c, μ) int64).  The
        backward pass is written out (two batched matmuls per layer); the
        tanh derivative keeps jax's form (g + g·h)·(1 − h)."""
        x, y = batch
        mu = x.shape[1]
        h = torch.tanh(torch.bmm(x, p["w1"]) + p["b1"][:, None, :])
        logits = torch.bmm(h, p["w2"]) + p["b2"][:, None, :]
        dlogits = torch.softmax(logits, dim=-1)
        dlogits.scatter_add_(-1, y[..., None],
                             torch.full(y.shape + (1,), -1.0,
                                        dtype=dlogits.dtype,
                                        device=dlogits.device))
        dlogits = dlogits / mu
        dh = torch.bmm(dlogits, p["w2"].transpose(1, 2))
        dpre = (dh + dh * h) * (1 - h)
        return {"w1": torch.bmm(x.transpose(1, 2), dpre),
                "b1": dpre.sum(dim=1),
                "w2": torch.bmm(h.transpose(1, 2), dlogits),
                "b2": dlogits.sum(dim=1)}

    def loss(self, p, batch) -> torch.Tensor:
        """Mean cross-entropy of one (unbatched) minibatch."""
        x, y = batch
        logits = self._logits(p, x)
        ll = logits.gather(-1, y[:, None].long())[:, 0]
        return torch.mean(torch.logsumexp(logits, dim=-1) - ll)

    def batch_fn_for(self, mu: int, seed: int = 0) -> Callable:
        def fn(learner: int, step: int):
            x, y = self.task.minibatch(learner, step, mu, seed=seed)
            return x, y.astype(np.int64)
        return fn

    def stage_minibatches(self, learner, mb_index, mu: int, seed: int = 0):
        """(steps, c) counter matrices → (x (steps, c, μ, F), y (steps, c,
        μ) int64), element-identical to the reference's staging."""
        x, y = self.task.minibatch_array(learner, mb_index, mu, seed=seed)
        return x, y.astype(np.int64)

    def _test_set(self, device):
        dev = torch.device(device)
        if dev not in self._test_sets:
            self._test_sets[dev] = (
                torch.as_tensor(self.task.x_test, device=dev),
                torch.as_tensor(self.task.y_test, device=dev).long())
        return self._test_sets[dev]

    def test_error(self, p) -> float:
        x, y = self._test_set(p["w1"].device)
        pred = torch.argmax(self._logits(p, x), dim=-1)
        return float(1.0 - torch.mean((pred == y).to(torch.float32)))

    def eval_fn(self, p) -> Dict[str, float]:
        return {"test_error": self.test_error(p)}

    # -- serving hooks (train-while-serve) -----------------------------------
    _REQUEST_RNG_TAG = 0x53525645

    def stage_requests(self, serving, fleet, seed: int = 0):
        """One batch of held-out samples per inference request, with a
        leading (R,) request axis, drawn host-side in one call — bitwise
        the reference's draw (its rng stream is tagged apart from the
        training batches and depends only on R, the request size and
        ``seed``)."""
        rng = np.random.default_rng([seed, self._REQUEST_RNG_TAG])
        idx = rng.integers(0, self.task.n_test,
                           (serving.n_requests, fleet.request_samples))
        return (np.asarray(self.task.x_test)[idx],
                np.asarray(self.task.y_test)[idx])

    def request_metric(self, p, batch):
        """Accuracy of n request batches at once: ``p`` leaves (n, …) (each
        request's published weights), ``batch`` = (x (n, s, F), y (n, s)).
        Returns (n,) fp32."""
        x, y = batch
        h = torch.tanh(torch.bmm(x, p["w1"]) + p["b1"][:, None, :])
        logits = torch.bmm(h, p["w2"]) + p["b2"][:, None, :]
        pred = torch.argmax(logits, dim=-1)
        return torch.mean((pred == y).to(torch.float32), dim=-1)


# ---------------------------------------------------------------------------
# diagonal quadratic: the what-if replay vehicle
# ---------------------------------------------------------------------------
class QuadraticProblem:
    """Diagonal quadratic loss ``0.5·mean(a·(w − w*)²)`` with closed-form
    gradients ``g = a ⊙ (w − w*)`` — the trace-driven what-if vehicle.

    ``a`` and ``w*`` follow the reference's iota formulas, in fp32 exactly
    as written there (``arange`` rounds above 2²⁴ in both), generated on the
    device in chunks so no int64 or float64 (D,) temporary ever exists.
    ``arch=`` sizes D to a registered architecture's parameter count
    (``qwen2_1_5b`` → D = 1 777 086 464).
    """

    CHUNK = 1 << 24

    def __init__(self, d: int = 4096, arch: str = None, seed: int = 0):
        if arch is not None:
            from repro_torch.configs import get_config
            d = int(get_config(arch).param_count())
        self.d = int(d)
        self._seed = seed

    def _coeffs(self, lo: int, hi: int, device):
        """a and w* over columns [lo, hi)."""
        s = self._seed
        i = torch.arange(lo, hi, dtype=torch.int64,
                         device=device).to(torch.float32)
        thousand = torch.full((), 1000.0, device=device)
        # curvatures in [0.5, 1.5): positive definite, non-isotropic; the
        # division is by a tensor, so it is a true fp32 division on every
        # device (a scalar divisor may become a reciprocal multiply)
        a = 0.5 + torch.remainder(i + 37.0 * s, 1000.0) / thousand
        wstar = torch.sin(1e-3 * i + s)
        return a, wstar

    def flat_grad(self, device) -> Tuple[str, torch.Tensor, torch.Tensor]:
        """("quadratic", a, w*) as (D,) fp32 tensors on ``device``."""
        dev = torch.device(device)
        a = torch.empty(self.d, dtype=torch.float32, device=dev)
        wstar = torch.empty(self.d, dtype=torch.float32, device=dev)
        for lo in range(0, self.d, self.CHUNK):
            hi = min(lo + self.CHUNK, self.d)
            a[lo:hi], wstar[lo:hi] = self._coeffs(lo, hi, dev)
        return "quadratic", a, wstar

    def init(self, device) -> Dict[str, torch.Tensor]:
        return {"w": torch.zeros(self.d, dtype=torch.float32, device=device)}

    @property
    def dataset_size(self) -> int:
        return 1 << 16          # synthetic: epochs-maths placeholder

    def grad_fn(self, p, batch):
        """Staged-path gradients for c slots: ``p["w"]`` is (c, D)."""
        _, a, wstar = self.flat_grad(p["w"].device)
        return {"w": a * (p["w"] - wstar)}

    def batch_fn_for(self, mu: int, seed: int = 0) -> Callable:
        def fn(learner: int, step: int):
            return np.zeros((1,), np.float32)
        return fn

    def stage_minibatches(self, learner, mb_index, mu: int, seed: int = 0):
        return np.zeros(np.shape(learner) + (1,), np.float32)

    def eval_fn(self, p) -> Dict[str, float]:
        """The loss, accumulated in float64 over fp32 chunks."""
        w = p["w"]
        total = 0.0
        for lo in range(0, self.d, self.CHUNK):
            hi = min(lo + self.CHUNK, self.d)
            a, wstar = self._coeffs(lo, hi, w.device)
            total += float(torch.sum(a * (w[lo:hi] - wstar) ** 2,
                                     dtype=torch.float64))
        return {"loss": 0.5 * total / self.d}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable] = {}
_CACHE: Dict[Tuple, object] = {}


def register_problem(name: str, factory: Callable, version: int = 1) -> None:
    """Register ``factory(**kwargs) -> problem`` under ``name``;
    ``version`` is its content identity for spec hashing."""
    from repro_torch.experiments.spec_hash import register_problem_version
    register_problem_version(name, version)
    _REGISTRY[name] = factory


def problem_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_problem(name: str, args: Tuple[Tuple[str, object], ...] = ()):
    """Resolve (and cache) a registered problem.  ``args`` is the spec's
    hashable ``problem_args`` tuple-of-pairs."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown problem {name!r}; registered: "
                       f"{problem_names()}")
    key = (name, tuple(args))
    if key not in _CACHE:
        _CACHE[key] = _REGISTRY[name](**dict(args))
    return _CACHE[key]


register_problem("mlp_teacher", MLPProblem)
register_problem("quadratic_whatif", QuadraticProblem)
