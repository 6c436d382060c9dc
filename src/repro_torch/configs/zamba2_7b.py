"""Zamba2-7B — hybrid: Mamba2 blocks + weight-shared attention blocks.

The JAX reference's assigned preset of this name, kept field for field
(``tests/test_torch_configs.py``), not the published model: the published
Zamba2-7B-Instruct (heads of 224 over concat(x, embedding), 2 shared
blocks at 13 irregular layers with per-layer adapters and linear maps, 2
B / C groups, a gated GELU MLP) is ``configs/zamba2_7b_instruct.py``.

Assigned: [hybrid] 81L d_model=3584 32H (GQA kv=32 = MHA) d_ff=14336
vocab=32000, ssm_state=64 [arXiv:2411.15242].  Repeating unit
[shared-attn, mamba2, mamba2] × 27 = 81 layers; the attention (+MLP) weights
are shared across all 27 units (Zamba2's shared transformer block).
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("shared_attn", "mamba", "mamba"),
    n_units=27,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    source="Zamba2 [arXiv:2411.15242]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, n_units=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, ssm_state=16, ssm_head_dim=32)
