"""Snowflake Arctic 480B — dense-MoE hybrid (dense residual ∥ 128-expert MoE).

Assigned: [moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].
Every layer: attention + (dense SwiGLU d_ff=4864 in parallel with top-2 MoE).
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=("moe_dense",),
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    source="Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, n_experts=4, top_k=2, moe_d_ff=256)
