"""Llama-3 405B — the largest dense assigned architecture.

Assigned: [dense] 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783].  Requires FSDP-style 2-D parameter sharding
(data × model) to fit v5e HBM (DESIGN.md §9).
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    block_pattern=("attn",),
    rope_theta=5e5,
    source="Llama 3 [arXiv:2407.21783]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=512, n_heads=8, n_kv_heads=2,
    d_ff=1024, vocab_size=512)
