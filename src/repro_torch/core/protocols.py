"""Synchronization-protocol update rules (paper §3.1, Eqs. 3–5; counterpart
of ``repro/core/protocols.py``).

* hardsync  — Δθ = (1/λ) Σ_{l=1..λ} Δθ_l          (Eq. 3)
* n-softsync — Δθ = (1/c) Σ_{l=1..c} Δθ_l, c=⌊λ/n⌋ (Eq. 5)
* async     — Δθ = Δθ_l                            (Eq. 4; c = 1)

All three reduce to "combine c gradients, apply one optimizer step" — the
unified staleness-aware update in ``repro_torch.optim``.  This module keeps
the protocol bookkeeping (arrival batching, timestamps, the scalar-vs-
per-gradient LR contract) and routes every applyUpdate through that
subsystem; by default the PS fires the CUDA ``ps_apply`` kernel
(``kernels/ps_update.py``) over the whole flattened model, so the legacy
simulator's hot path IS the kernel.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.optim.flatten import tree_device, tree_map


def tree_mean(grads: Sequence) -> object:
    """Average a list of gradient trees (the PS's sumGradients ÷ c)."""
    n = float(len(grads))
    return tree_map(lambda *g: sum(g) / n, *grads)


def init_ps_state(run, params):
    """PS-side optimizer init shared by the host PS and the replay engine:
    the run's UpdateSpec plus fresh fp32 optimizer state for ``params``."""
    spec = optim.spec_from_run(run)
    return spec, optim.init_state(spec, params)


class ParameterServerState:
    """Host-side PS used by the event-driven simulator (Rudra-base logic).

    Holds the master weights + scalar timestamp, accumulates pushed
    gradients and fires an update every ``c`` arrivals, exactly like the
    paper's PS.  The update itself is one call into
    ``repro_torch.optim.apply_update``:

    * scalar LR from the policy  → ``combine`` mode (Eq. 3/5: average the c
      gradients, one optimizer event);
    * per-gradient LR list (footnote 3) → ``sequential`` mode: c optimizer
      events, event i applying G_i/c with its own α_i.

    ``backend`` picks the optim backend; the default "pallas" (the
    reference's name) runs ONE ``ps_apply`` launch over the whole
    concatenated model per update.  Every update makes new weight tensors:
    a learner keeps the (stale) weights it pulled.  coef and the LRs go to
    the device once per update; the PS never reads a device value back.
    """

    def __init__(self, params, c: int, optimizer: str = "sgd",
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 backend: str = "pallas",
                 spec: "optim.UpdateSpec" = None):
        self.params = params
        self.timestamp = 0
        self.c = c
        self.backend = backend
        self.spec = spec if spec is not None else optim.UpdateSpec(
            optimizer=optimizer, momentum=momentum,
            weight_decay=weight_decay)
        self.optimizer = self.spec.optimizer
        self.momentum = self.spec.momentum
        self.opt_state = optim.init_state(self.spec, params)
        self._pending: List = []            # (grad, grad_timestamp)

    @classmethod
    def from_run(cls, params, run, backend: str = "pallas"
                 ) -> "ParameterServerState":
        """Build the host PS for a RunConfig — the spec comes from the same
        ``spec_from_run`` mapping the replay engine uses
        (:func:`init_ps_state`), so the two stay field-for-field aligned.

        The host PS models the *flat, static* Rudra-base server only;
        sharded/grouped topologies and elastic membership / backup learners
        have no per-arrival oracle and replay on ``core.engine`` only."""
        from repro_torch.core.topology import Topology   # lazy: flat layers
        topo = Topology.from_run(run)
        if not topo.is_trivial(run.n_learners):
            raise ValueError(
                f"the host PS (legacy per-arrival loop) models the flat "
                f"Rudra-base server; topology {topo} replays on "
                f"core.engine only")
        if run.elastic or run.backup:
            raise ValueError(
                f"the host PS (legacy per-arrival loop) models a static "
                f"cluster; elastic membership ({run.membership}) / "
                f"backup={run.backup} resolve at schedule time and replay "
                f"on core.engine only")
        return cls(params, run.gradients_per_update, backend=backend,
                   spec=optim.spec_from_run(run))

    @property
    def velocity(self):
        return self.opt_state.get("velocity")

    @property
    def accum(self):
        return self.opt_state.get("accum")

    def push_gradient(self, grad, grad_timestamp: int, lr_for_update):
        """Receive one gradient.  Returns the StalenessRecord-compatible
        vector clock if an update fired, else None.

        ``lr_for_update`` is a callable (gradient_timestamps -> α) so the
        LR policy can see the vector clock (per-gradient modulation)."""
        self._pending.append((grad, grad_timestamp))
        if len(self._pending) < self.c:
            return None
        grads = [g for g, _ in self._pending]
        clocks = [t for _, t in self._pending]
        self._pending = []
        c = len(grads)
        dev = tree_device(self.params)
        lr = lr_for_update(self.timestamp, clocks)
        if (lr.dim() if isinstance(lr, torch.Tensor) else np.ndim(lr)) > 0:
            # footnote 3: per-gradient α_i ⇒ c sequential optimizer events
            # (any length-c sequence, array or tensor counts)
            mode = "sequential"
            lrs = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        else:
            mode = "combine"
            lrs = torch.full((c,), float(lr), dtype=torch.float32,
                             device=dev)
        coef = torch.full((c,), 1.0 / c, dtype=torch.float32, device=dev)
        self.params, self.opt_state = optim.apply_update(
            self.spec, self.params, self.opt_state, grads, coef, lrs,
            mode=mode, backend=self.backend)
        self.timestamp += 1
        return clocks
