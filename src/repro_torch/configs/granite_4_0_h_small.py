"""Granite-4.0-H-Small as published: the model's public ``config.json``
(huggingface.co/ibm-granite/granite-4.0-h-small) and the layer equations
of ``transformers``' ``modeling_granitemoehybrid.py``.

40 layers of width 4 096.  Each has one mixer: 36 Mamba2 mixers (128
heads of 64, d_state 128, 1 B / C group, conv 4, chunk 256) and attention
at layers 5, 15, 25 and 35 (32 query and 8 K/V heads of 128, no position
encoding, q·k scaled by ``attention_multiplier`` = 1/128).  After every
mixer comes a dropless MoE of 72 SwiGLU experts of width 768, top-10 with
a softmax over the 10 chosen logits, beside a shared SwiGLU MLP of width
1 536.  μP multipliers: the embedding × 12, every residual branch × 0.22,
the logits ÷ 16.  Vocabulary 100 352, head tied to the embedding:
32 207 337 984 parameters (``GraniteConfig.param_count``).

Not in ``ARCH_IDS``, which must equal the reference's.  ``SMOKE`` keeps
both mixer kinds, 8 experts with top-3 and the shared MLP, at widths the
CPU tests can take.
"""

import dataclasses

from repro_torch.config import GraniteConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = GraniteConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab_size=100352,
    block_pattern=("mamba",),
    n_units=40,
    d_head=128,
    n_experts=72,
    top_k=10,
    moe_d_ff=768,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    norm_eps=1e-5,
    tie_embeddings=True,
    layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                      for i in range(40)),
    shared_d_ff=1536,
    ssm_groups=1,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/"
           "main/config.json",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, n_units=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=32, moe_d_ff=32, shared_d_ff=48, n_experts=8, top_k=3,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    layer_types=("mamba", "attention", "mamba", "mamba"))
