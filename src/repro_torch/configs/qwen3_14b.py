"""Qwen3-14B — dense decoder with qk-norm and GQA.

Assigned: [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
[hf:Qwen/Qwen3-8B].
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    block_pattern=("attn",),
    qk_norm=True,
    rope_theta=1e6,
    source="Qwen3 [hf:Qwen/Qwen3-8B]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512)
