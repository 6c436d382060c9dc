"""Qwen2-1.5B — dense decoder with QKV bias.

Assigned: [dense] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2407.10671].
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    source="Qwen2 [arXiv:2407.10671]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512)
