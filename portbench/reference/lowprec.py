"""Roundings for the controls: the reference computed one precision below
what the configuration states.  Plain bit arithmetic, so a control reads
the same on the CPU and on the card."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (10 mantissa bits, ties to even),
    kept in fp32.  Infinities and NaNs are not expected here."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Operand(torch.autograd.Function):
    """Rounds a matrix product's operand to TF32 going forward and the
    gradient that flows back through it going backward, as a TF32 matrix
    unit rounds the operands of both passes."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def tf32_operand(x: torch.Tensor) -> torch.Tensor:
    return _TF32Operand.apply(x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest bf16 value, kept in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)
