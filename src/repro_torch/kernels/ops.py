"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``; the parameter-server update and flash attention
are ported — the SSM and WKV kernels wait for the zamba2 and rwkv6 slices,
ROADMAP.md queue 2 items 5–6).

The reference jit-compiles each wrapper and derives Pallas' interpret mode
from the backend.  Here the device of the operands decides: a CUDA tensor
launches the CUDA kernel, a CPU tensor runs its plain PyTorch version.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ps_update as _ps


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) → (B, Sq, H, D) (see
    ``flash_attention.flash_attention``)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def ps_update(w_flat, v_flat, g_flat, coef, *, momentum: float = 0.9,
              lr: float = 1.0):
    """Momentum combine-mode PS update (see ``ps_update.ps_update_flat``)."""
    return _ps.ps_update_flat(w_flat, v_flat, g_flat, coef,
                              momentum=momentum, lr=lr)


def ps_apply(w_flat, s_flat, g_flat, coef, lrs, *, spec,
             mode: str = "combine"):
    """General fused applyUpdate (sgd/momentum/adagrad; see
    ``repro_torch.optim``)."""
    return _ps.ps_apply(w_flat, s_flat, g_flat, coef, lrs, spec=spec,
                        mode=mode)
