"""The yardstick of the Granite prefill cell: a published Granite 4.0-H's
forward FLOPs, its expert products' FLOPs, and the least bytes of its
dispatch and combine kernels at their shapes.

Written from the configuration's published keys alone, so a change to the
program cannot move it; the peaks are ``cost.py``'s.  A kernel's least
time is its bytes (each input read once, each output written once) over
the HBM rate, whatever implements it.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.cost import PEAK_BYTES_PER_S


def _attention_layers(cfg: Dict) -> int:
    return sum(t == "attention" for t in cfg["layer_types"])


def expert_params_applied(cfg: Dict) -> int:
    """Routed-expert matmul parameters a token applies in one layer: its
    ``num_experts_per_tok`` experts' gate, up and down."""
    return cfg["num_experts_per_tok"] * 3 * cfg["hidden_size"] \
        * cfg["intermediate_size"]


def matmul_params_applied(cfg: Dict) -> int:
    """Parameters that enter a matrix product per token, counting each
    application: every Mamba2 mixer's in and out projections, every
    attention mixer's q, k, v and o, every layer's router, its chosen
    experts and its shared MLP, and the tied output head.  Gathers, norms,
    the convolution and the scan are not products of parameters."""
    M, V = cfg["hidden_size"], cfg["vocab_size"]
    Din = cfg["mamba_expand"] * M
    H, G, N = cfg["mamba_n_heads"], cfg["mamba_n_groups"], \
        cfg["mamba_d_state"]
    D = M // cfg["num_attention_heads"]
    mamba = M * (2 * Din + 2 * G * N + H) + Din * M
    attn = 2 * M * cfg["num_attention_heads"] * D \
        + 2 * M * cfg["num_key_value_heads"] * D
    ffn = M * cfg["num_local_experts"] + expert_params_applied(cfg) \
        + 3 * M * cfg["shared_intermediate_size"]
    L, n_attn = cfg["num_hidden_layers"], _attention_layers(cfg)
    return (L - n_attn) * mamba + n_attn * attn + L * ffn + M * V


def attention_pairs(seq: int) -> int:
    """Live (query, key) pairs of one causal sequence."""
    return seq * (seq + 1) // 2


def prefill_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` × ``seq`` tokens: 2 per
    applied matmul parameter and token, plus causal attention's two
    products (QKᵀ and PV, 2 · hidden each per live pair) at every
    attention layer."""
    dense = 2.0 * matmul_params_applied(cfg) * batch * seq
    attn = (_attention_layers(cfg) * batch * 2 * 2.0 * cfg["hidden_size"]
            * attention_pairs(seq))
    return dense + attn


def expert_flops(cfg: Dict, batch: int, seq: int) -> float:
    """FLOPs of one prefill's routed-expert products, every layer: 2 per
    applied expert parameter and token."""
    return 2.0 * expert_params_applied(cfg) * batch * seq \
        * cfg["num_hidden_layers"]


def _itemsize(cfg: Dict) -> int:
    return 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4


def dispatch_bytes(cfg: Dict, batch: int, seq: int) -> float:
    """One layer's dispatch: the fp32 router logits (T, E) and the normed
    rows (T, M) read once; the rows gathered into expert order (T·k, M),
    each pair's expert, gate and row (T, k, 4 bytes each), and the experts'
    counts and ends written once."""
    T, E, k, M = batch * seq, cfg["num_local_experts"], \
        cfg["num_experts_per_tok"], cfg["hidden_size"]
    b = _itemsize(cfg)
    return float(4 * T * E + b * T * M + b * T * k * M + 3 * 4 * T * k
                 + 2 * 4 * E)


def combine_bytes(cfg: Dict, batch: int, seq: int) -> float:
    """One layer's combine: the experts' T·k rows, the gates and rows of
    each pair, the shared MLP's output and the residual read once; the
    new residual written once."""
    T, k, M = batch * seq, cfg["num_experts_per_tok"], cfg["hidden_size"]
    b = _itemsize(cfg)
    return float(b * T * k * M + 2 * 4 * T * k + 3 * b * T * M)


def dispatch_least_s(cfg: Dict, batch: int, seq: int) -> float:
    return dispatch_bytes(cfg, batch, seq) / PEAK_BYTES_PER_S


def combine_least_s(cfg: Dict, batch: int, seq: int) -> float:
    return combine_bytes(cfg, batch, seq) / PEAK_BYTES_PER_S
