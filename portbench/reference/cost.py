"""The yardstick's arithmetic: the card's peaks, a what-if event's least
bytes and operations, and a language model's training FLOPs.

Frozen here so that a change to the program cannot move it.  The peaks and
the event count are copies of ``chip_smoke.py``'s ``PEAK_*``, ``OPT_OPS``,
``event_cost`` and ``bound_ms`` (the what-if branch, rewritten over the
event's shapes instead of its operand tensors); the FLOP count is written
from the model's shapes alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12          # HBM3
PEAK_FP32_FLOPS = 67e12             # fp32 outside the tensor cores, FMA = 2
# the update kernels build with -fmad=false, so each add and each multiply
# is issued on its own: half the FMA rate in operations per second
PEAK_FP32_OPS_PER_S = PEAK_FP32_FLOPS / 2
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# the peak a model's matrix products run at, by the dtype they run in
PEAK_FLOPS_BY_DTYPE = {"float32": PEAK_FP32_FLOPS,
                       "bfloat16": PEAK_BF16_FLOPS,
                       "float16": PEAK_BF16_FLOPS}

OPT_OPS = {"sgd": 2, "momentum": 4, "adagrad": 7}   # fp32 ops per element


def whatif_event_cost(D: int, c: int, ring_bytes: int, pulled_rows: int,
                      ts_rows: int, optimizer: str,
                      residue: bool) -> Tuple[float, float]:
    """(bytes, fp32 operations) one what-if event needs, each input read
    once and each output written once: ``pulled_rows`` distinct ring rows
    read (the previous row and the distinct rows the slots pulled),
    ``ts_rows`` of them pulled by slots (gⱼ = a·(r − w*) once per distinct
    row), a and w* read, the new row written, the optimizer state and the
    bf16 ring's fp32 residue read and written; the slot-order sum is a
    multiply and an add per slot."""
    stateful = optimizer != "sgd"
    per = 8 * stateful + 8 * residue + ring_bytes
    per += ring_bytes * pulled_rows + 8
    ops = 2 * c + 2 * ts_rows + OPT_OPS[optimizer] + 2 * residue
    return float(per) * D, float(ops) * D


def bound_s(nbytes: float, nops: float) -> Tuple[float, str]:
    """The least time for the work, the larger of bytes over the HBM rate
    and fp32 operations over the fp32 issue rate, and which one bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = nops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def lm_matmul_params(cfg: Dict) -> int:
    """Parameters of a dense decoder that enter a matrix product per
    token: the attention and MLP projections and the output head (tied or
    not, the head is a product).  The embedding gather, norms and biases
    are not products."""
    M, F, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = M // H
    attn = M * H * Dh + 2 * M * KV * Dh + H * Dh * M
    mlp = 3 * M * F
    return L * (attn + mlp) + M * cfg["vocab_size"]


def lm_train_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training pass (forward and backward) over
    ``batch`` sequences of ``seq`` tokens: 6 per matmul parameter and
    token, plus causal attention's two products (QKᵀ and PV, each
    2·H·Dh per query and visible key, S(S+1)/2 pairs per sequence), times
    three for the backward.  Recompute under activation checkpointing is
    not counted."""
    M, L, H = cfg["hidden_size"], cfg["num_hidden_layers"], \
        cfg["num_attention_heads"]
    Dh = M // H
    tokens = batch * seq
    dense = 6.0 * lm_matmul_params(cfg) * tokens
    pairs = seq * (seq + 1) / 2
    attn = 3.0 * L * batch * 2 * (2.0 * H * Dh * pairs)
    return dense + attn
