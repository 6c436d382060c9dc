"""Llama-4 Maverick 400B-A17B — MoE with interleaved dense layers.

Assigned: [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128 experts top-1 [hf:meta-llama/Llama-4-Scout-17B-16E].  Alternating
dense/MoE layers (unit = [attn, moe] × 24); early fusion heritage noted —
the text-only decoder is what the shapes exercise.
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn", "moe"),
    n_units=24,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    rope_theta=5e5,
    source="Llama-4 Maverick [hf:meta-llama/Llama-4-Scout-17B-16E]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=1, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, n_experts=4, top_k=1, moe_d_ff=512)
