"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``: the parameter-server update, flash attention, the
Mamba2 SSD scan and the RWKV6 WKV recurrence; and the port's own Mamba2
glue, RMSNorm and the dropless MoE's dispatch and combine).

The reference jit-compiles each wrapper and derives Pallas' interpret mode
from the backend.  Here the device of the operands decides: a CUDA tensor
launches the CUDA kernel, a CPU tensor runs its plain PyTorch version.

The flash, ssm, Mamba2 glue, RMSNorm, MoE and wkv6 kernels have no backward
(neither have the reference's Pallas kernels: ``jax.grad`` through them
fails).  Their outputs are written by a foreign launch into fresh buffers,
so autograd would see them as constants and the attention, mamba, norm and
rwkv weights would silently get no gradient.  So these wrappers raise when
autograd is recording and an operand requires a gradient, on either
device: training runs ``attn_impl="chunked"`` / ``"naive"`` and
``use_pallas=False``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_glue as _mg
from repro_torch.kernels import moe_route as _moe
from repro_torch.kernels import ps_update as _ps
from repro_torch.kernels import rms_norm as _rn
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import wkv6 as _wkv


def _no_graph(name: str, *operands) -> None:
    """Refuse to run a forward-only kernel inside an autograd graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name} has no backward: its outputs would carry no gradient "
            f"to the weights.  Train with attn_impl='chunked' (or 'naive') "
            f"and use_pallas=False, or call it under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) → (B, Sq, H, D) (see
    ``flash_attention.flash_attention``; ``scale`` 1/√D when None)."""
    _no_graph("flash_attention", q, k, v)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


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
    _no_graph("ssm_scan", x, a, Bm, Cm)
    return _ssm.ssm_scan(x, a, Bm, Cm, chunk=chunk)


def mamba_in(xbc, dt, conv_w, conv_b, dt_bias, A_log, *, head_dim: int):
    """The Mamba2 layer's prologue: convolved x B C, xdt and a for
    ``ssm_scan`` (see ``mamba_glue.mamba_in``)."""
    _no_graph("mamba_in", xbc, dt, conv_w, conv_b, dt_bias, A_log)
    return _mg.mamba_in(xbc, dt, conv_w, conv_b, dt_bias, A_log,
                        head_dim=head_dim)


def mamba_out(y, xs, z, D, gate_norm, *, groups: int, eps: float):
    """The Mamba2 layer's epilogue: the skip, the gate and the grouped
    RMSNorm (see ``mamba_glue.mamba_out``)."""
    _no_graph("mamba_out", y, xs, z, D, gate_norm)
    return _mg.mamba_out(y, xs, z, D, gate_norm, groups=groups, eps=eps)


def rms_norm(x, scale, eps: float = 1e-5, *, tail=None):
    """RMSNorm of each row of x, or of concat(x, tail), in one pass (see
    ``rms_norm.rms_norm``)."""
    _no_graph("rms_norm", x, scale, tail)
    return _rn.rms_norm(x, scale, eps, tail=tail)


def moe_dispatch(logits, x, k: int):
    """Each row of x to the top ``k`` experts of its fp32 router
    ``logits``, gathered into expert order (see
    ``moe_route.moe_dispatch``)."""
    _no_graph("moe_dispatch", logits, x)
    return _moe.moe_dispatch(logits, x, k)


def moe_combine(rows, gates, pos, shared, residual, mult: float):
    """``residual + mult · (Σ gates · rows + shared)`` per token, rounded
    once (see ``moe_route.moe_combine``)."""
    _no_graph("moe_combine", rows, gates, shared, residual)
    return _moe.moe_combine(rows, gates, pos, shared, residual, mult)


def wkv6(r, k, v, w, u, *, chunk: int = _wkv.DEFAULT_CHUNK,
         init_state=None):
    """RWKV6 WKV recurrence from a zero state (see ``wkv6.wkv6``, which
    refuses an ``init_state`` other than None: the reference's wrapper
    drops it silently)."""
    _no_graph("wkv6", r, k, v, w, u, init_state)
    return _wkv.wkv6(r, k, v, w, u, chunk=chunk, init_state=init_state)
