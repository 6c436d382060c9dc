"""The single applyUpdate rule of the port (counterpart of ``repro/optim/spec.py``).

* :class:`UpdateSpec`  — which optimizer + its hyperparameters.
* :func:`update_event` — one optimizer event on fp32 tensors.  This is the
  plain version the CUDA replay kernels (``kernels/csrc/replay_ring.cu``)
  repeat element for element: each line below is one rounded fp32 operation,
  in the same order as the kernel's ``__fmul_rn``/``__fadd_rn`` chain, so
  kernel ≡ plain version bitwise on the card.
* :func:`init_state`   — fp32 optimizer state, a dict of tensors.

Two update modes (``combine`` / ``sequential``) are applied by
``backends.py``; the meaning is the reference's (DESIGN.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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


def init_state(spec: UpdateSpec, params: dict) -> dict:
    """Optimizer state: fp32 zeros shaped like each parameter, on its
    device.  adamw is not ported (ROADMAP.md queue 1 item 4.2)."""
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if spec.optimizer == "momentum":
        return {"velocity": {k: f32(v) for k, v in params.items()}}
    if spec.optimizer == "adagrad":
        return {"accum": {k: f32(v) for k, v in params.items()}}
    if spec.optimizer == "adamw":
        raise NotImplementedError(
            "adamw is not ported yet (ROADMAP.md queue 1 item 4.2)")
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
