"""The yardstick of the prefill cells: a published Zamba2's forward FLOPs,
and the least bytes and operations of its two kernels at their shapes.

Written from the configuration's published keys alone, so a change to the
program cannot move it; the peaks are ``cost.py``'s.  Each kernel's least
time is the larger of its bytes (each input read once, each output written
once) over the HBM rate and its operations over the rate of the units that
run them, whatever implements it.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.reference.cost import (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S,
                                      PEAK_FP32_FLOPS)


def matmul_params_applied(cfg: Dict) -> int:
    """Parameters that enter a matrix product per token, counting each
    application: every Mamba2 layer's in and out projections; at every
    hybrid layer its shared block's q, k, v, o, gate/up and down, the
    layer's adapter and linear map; the tied output head.  Gathers, norms,
    the convolution and the scan are not products of parameters."""
    M, F = cfg["hidden_size"], cfg["intermediate_size"]
    Din = cfg["mamba_expand"] * M
    H, G, N = cfg["n_mamba_heads"], cfg["mamba_ngroups"], \
        cfg["mamba_d_state"]
    HD = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    r, A = cfg["adapter_rank"], 2 * M
    mamba = M * (2 * Din + 2 * G * N + H) + Din * M
    shared = 3 * A * HD + HD * M + M * 2 * F + F * M
    hybrid = shared + M * r + r * 2 * F + M * M
    return (cfg["num_hidden_layers"] * mamba
            + len(cfg["hybrid_layer_ids"]) * hybrid
            + M * cfg["vocab_size"])


def attention_pairs(seq: int) -> int:
    """Live (query, key) pairs of one causal sequence."""
    return seq * (seq + 1) // 2


def prefill_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` × ``seq`` tokens: 2 per
    applied matmul parameter and token, plus causal attention's two
    products (QKᵀ and PV, 2 · heads · head dim each per live pair) at
    every hybrid layer."""
    dense = 2.0 * matmul_params_applied(cfg) * batch * seq
    HD = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    attn = (len(cfg["hybrid_layer_ids"]) * batch * 2 * 2.0 * HD
            * attention_pairs(seq))
    return dense + attn


def flash_cost(cfg: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(bytes, bf16 flops) of one causal attention call of a hybrid
    layer: q, k, v read and the output written once in bf16; 4 · D flops
    per head and live pair."""
    H, D = cfg["num_attention_heads"], cfg["attention_head_dim"]
    nbytes = 2 * 4 * batch * seq * H * D
    return float(nbytes), 4.0 * D * batch * H * attention_pairs(seq)


def ssm_scan_cost(cfg: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(bytes, fp32 flops) of one chunked SSD scan from a zero state
    (``kernels.ops.ssm_scan``'s operands): x (fp32), a (fp32) and B, C
    (the model dtype) read once, y (fp32) and the final state written
    once.  Flops, a multiply-add as two: per (b, group, chunk) the lower
    triangle of C·Bᵀ; per (b, head, chunk) the decayed lower-triangular
    product with x, the entering state's term C·S and the chunk's state
    contribution Bᵀ·x; per (b, head) the pass over the chunks' states."""
    H, P, N = cfg["n_mamba_heads"], cfg["mamba_headdim"], \
        cfg["mamba_d_state"]
    G, Q = cfg["mamba_ngroups"], min(cfg["chunk_size"], seq)
    nc = -(-seq // Q)
    bc = 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4
    nbytes = batch * (seq * H * (4 * P + 4 + 4 * P) + 2 * seq * G * N * bc
                      + 4 * H * N * P)
    tri = Q * (Q + 1) / 2
    flops = batch * nc * (G * 2 * tri * N
                          + H * (2 * tri * P + 2 * Q * N * P * 2)) \
        + batch * H * nc * 2 * N * P
    return float(nbytes), float(flops)


def least_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def flash_least_s(cfg: Dict, batch: int, seq: int) -> float:
    return least_s(*flash_cost(cfg, batch, seq), PEAK_BF16_FLOPS)


def ssm_scan_least_s(cfg: Dict, batch: int, seq: int) -> float:
    return least_s(*ssm_scan_cost(cfg, batch, seq), PEAK_FP32_FLOPS)
