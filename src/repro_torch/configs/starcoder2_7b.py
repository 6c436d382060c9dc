"""StarCoder2-7B — dense code model, GQA + RoPE.

Assigned: [dense] 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173].
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=("attn",),
    rope_theta=1e5,
    source="StarCoder2 [arXiv:2402.19173]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=288, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512)
