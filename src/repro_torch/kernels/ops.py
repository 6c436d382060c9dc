"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``: the parameter-server update, flash attention, the
Mamba2 SSD scan and the RWKV6 WKV recurrence).

The reference jit-compiles each wrapper and derives Pallas' interpret mode
from the backend.  Here the device of the operands decides: a CUDA tensor
launches the CUDA kernel, a CPU tensor runs its plain PyTorch version.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ps_update as _ps
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import wkv6 as _wkv


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


def ssm_scan(x, a, Bm, Cm, *, chunk: int = _ssm.DEFAULT_CHUNK):
    """Mamba2 SSD chunked scan from a zero state (see
    ``ssm_scan.ssm_scan``)."""
    return _ssm.ssm_scan(x, a, Bm, Cm, chunk=chunk)


def wkv6(r, k, v, w, u, *, chunk: int = _wkv.DEFAULT_CHUNK,
         init_state=None):
    """RWKV6 WKV recurrence from a zero state (see ``wkv6.wkv6``, which
    refuses an ``init_state`` other than None: the reference's wrapper
    drops it silently)."""
    return _wkv.wkv6(r, k, v, w, u, chunk=chunk, init_state=init_state)
