"""RWKV6 (Finch) 7B — attention-free with data-dependent decay.

Assigned: [ssm] 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
[arXiv:2404.05892].  Constant-size recurrent state ⇒ native long_500k.
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    source="RWKV-6 Finch [arXiv:2404.05892]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=256, d_ff=512, vocab_size=512,
    rwkv_head_dim=32)
