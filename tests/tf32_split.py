"""TF32 rounding and split-TF32 products, emulated in fp32 on the CPU.

A tensor core reads 19 of an fp32 operand's 32 bits (TF32: 10 mantissa
bits).  The port's fp32 tensor-core kernels (``csrc/flash_attention.cu``,
``csrc/ssm_scan.cu``) split each fp32 operand into a TF32 big part and the
TF32 rounding of its remainder and take a product as small·big + big·small
+ big·big; an operand that is already exact in TF32 (born in bf16) is not
split.  The tests run the kernels' tile loops with these products in place
of plain fp32 ones.
"""

import torch


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero as ``cvt.rna.tf32.f32``: by bit masks on the fp32 pattern.  A
    tensor core reads only these 19 bits of an fp32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def matmul_split(a, b, split_a=True, split_b=True):
    """a @ b as a split-TF32 kernel forms it: each operand marked split
    taken as its TF32 big part and the TF32 rounding of its remainder, the
    others exact in TF32 already (asserted); small·big + big·small +
    big·big for the terms that exist (the small·small term dropped), every
    product of two TF32 values exact in fp32 and summed in fp32."""
    ab, as_ = split(a) if split_a else (a, None)
    bb, bs = split(b) if split_b else (b, None)
    for t, s in ((a, split_a), (b, split_b)):
        assert s or torch.equal(t, tf32(t)), "an unsplit operand must be TF32"
    terms = ([torch.matmul(as_, bb)] if split_a else []) \
        + ([torch.matmul(ab, bs)] if split_b else []) \
        + [torch.matmul(ab, bb)]
    return sum(terms[1:], terms[0])


def matmul_tf32x3(a, b):
    """a @ b with both operands split: three TF32 products."""
    return matmul_split(a, b)


def matmul_tf32(a, b):
    """a @ b with only the big·big product: one TF32 pass."""
    return torch.matmul(tf32(a), tf32(b))
