"""The single applyUpdate rule of the port (counterpart of ``repro/optim/spec.py``).

* :class:`UpdateSpec`  — which optimizer + its hyperparameters.
* :func:`update_event` — one optimizer event on fp32 tensors.  This is the
  plain version the CUDA kernels (``kernels/csrc/update_event.cuh``, shared
  by ``replay_ring.cu`` and ``ps_update.cu``) repeat element for element:
  each line below is one rounded fp32 operation, in the same order as the
  kernels' ``__fmul_rn``/``__fadd_rn`` chain, so kernel ≡ plain version
  bitwise on the card.
* :func:`init_state`   — fp32 optimizer state, trees shaped like the
  parameters (adamw: two moments and a step counter).
* :func:`sequential_fold` — the algebra that folds c *sequential* momentum
  events (per-event LRs) into one affine update (:class:`RoundFold`), used
  by the fused softsync engine (``core/distributed.py``).  Host float64
  numpy, as in the reference, so bitwise the reference's.

Two update modes (``combine`` / ``sequential``) are applied by
``backends.py``; the meaning is the reference's (DESIGN.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.flatten import tree_device, tree_map

OPTIMIZERS = ("sgd", "momentum", "adagrad", "adamw")

# optimizers whose update is one elementwise pass over the flat buffer (the
# replay kernels' optimizers; adamw needs a scalar step counter)
KERNEL_OPTIMIZERS = ("sgd", "momentum", "adagrad")


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    """Optimizer kind + hyperparameters (hashable)."""

    optimizer: str = "sgd"
    momentum: float = 0.9
    eps: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0

    def __post_init__(self):
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}")

    @property
    def state_keys(self) -> Tuple[str, ...]:
        return {"sgd": (), "momentum": ("velocity",), "adagrad": ("accum",),
                "adamw": ("mu", "nu", "count")}[self.optimizer]

    @property
    def kernel_supported(self) -> bool:
        return self.optimizer in KERNEL_OPTIMIZERS


def spec_from_run(run) -> UpdateSpec:
    """Build an UpdateSpec from a RunConfig (the repo-wide convention)."""
    return UpdateSpec(optimizer=run.optimizer, momentum=run.momentum,
                      weight_decay=run.weight_decay)


def init_state(spec: UpdateSpec, params) -> dict:
    """Optimizer state: fp32 zeros shaped like each parameter, on its
    device (``params`` a dict of tensors or a bare tensor).  adamw adds its
    int32 step counter ``count``, on the parameters' device."""
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if spec.optimizer == "momentum":
        return {"velocity": tree_map(f32, params)}
    if spec.optimizer == "adagrad":
        return {"accum": tree_map(f32, params)}
    if spec.optimizer == "adamw":
        return {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_device(params))}
    return {}


def update_event(spec: UpdateSpec, w, s, g, lr):
    """θ' = θ − α·step(g) with the optimizer state folded in.

    ``w``/``g``: fp32 tensors; ``s``: fp32 state (None for sgd); ``lr``: an
    fp32 0-dim tensor or a float.  Returns ``(w', s')``.  Python scalars
    (momentum, eps) round to fp32 before the product, as in the reference
    and in the kernel."""
    if spec.optimizer == "sgd":
        return w - lr * g, s
    if spec.optimizer == "momentum":
        v = spec.momentum * s + g
        return w - lr * v, v
    if spec.optimizer == "adagrad":
        a = s + g * g
        return w - lr * g / (torch.sqrt(a) + spec.eps), a
    raise ValueError(f"update_event does not support {spec.optimizer!r}")


# ---------------------------------------------------------------------------
# Folding algebra: c sequential momentum events → one affine update.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundFold:
    """One-shot equivalent of c sequential momentum events.

    Sequential:  v_j = m·v_{j-1} + g_j ;  θ ← θ − lr_j·v_j   (j = 0..c−1)
    folds exactly into

        θ' = θ − Σ_i theta_coef_i·g_i − v0_coef·v
        v' = v_decay·v + Σ_i m^{c−1−i}·g_i

    ``v_gain`` = Σ_i m^{c−1−i} is the velocity gain when all g_i coincide
    (the fused engine's single weighted-mean gradient); with distinct g_i
    the velocity carry is a round-level approximation while the θ update
    stays exact for round 1.
    """

    theta_coef: np.ndarray     # (c,) per-gradient θ coefficients
    v0_coef: float             # θ's carry from the incoming velocity
    v_decay: float             # m^c
    v_gain: float              # Σ_i m^{c−1−i}


def sequential_fold(lrs: Sequence[float], momentum: float) -> RoundFold:
    """Fold per-event LRs + momentum into the affine round update."""
    lrs = np.asarray(lrs, np.float64)
    c = len(lrs)
    m = float(momentum)
    coef = np.zeros((c,))
    for i in range(c):
        for j in range(i, c):
            coef[i] += lrs[j] * (m ** (j - i))
    v0 = float(sum(lrs[j] * (m ** (j + 1)) for j in range(c)))
    gain = float(sum(m ** (c - 1 - i) for i in range(c)))
    return RoundFold(theta_coef=coef.astype(np.float64), v0_coef=v0,
                     v_decay=m ** c, v_gain=gain)
