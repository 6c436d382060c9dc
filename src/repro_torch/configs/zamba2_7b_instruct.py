"""Zamba2-7B-Instruct as published: the model's public ``config.json``
(huggingface.co/Zyphra/Zamba2-7B-Instruct) and the layer equations of
``transformers``' ``modeling_zamba2.py``.

81 Mamba2 layers (d_model 3 584, 112 heads of 64, d_state 64, 2 B / C
groups, conv 4, chunk 256); at the 13 ``hybrid_layer_ids`` one of 2
weight-shared transformer blocks (in turn) first reads concat(x, token
embedding), 7 168 wide: attention of 32 heads of 224 with RoPE θ 1e4 over
all 224 and the scale (224/2)^-½, then a gated exact-erf GELU MLP
3 584 → 2 × 14 336 → 3 584 with a rank-128 adapter per hybrid layer on its
gate/up projection.  Its output T enters that layer's Mamba2 input through a
per-layer 3 584² linear map, x ← x + Mamba(RMSNorm(x + W·T)), and not the
residual.  Vocabulary 32 000, 4 096 positions, output head tied to the
embedding: 7 356 749 648 parameters (``HybridConfig.param_count``).

Not in ``ARCH_IDS``, which must equal the reference's: ``configs/
zamba2_7b.py`` is the reference's assigned preset of the same name.
``SMOKE`` keeps two hybrid layers, so both shared blocks and two adapters
run, at widths the CPU tests can take.
"""

import dataclasses

from repro_torch.config import HybridConfig

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = HybridConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("mamba",),
    n_units=81,
    d_head=224,
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    norm_eps=1e-5,
    tie_embeddings=True,
    hybrid_layer_ids=HYBRID_LAYER_IDS,
    num_mem_blocks=2,
    adapter_rank=128,
    ssm_groups=2,
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/"
           "config.json",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, n_units=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=32, d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, hybrid_layer_ids=(1, 3), adapter_rank=8)
