"""InternVL2-2B — VLM: InternViT frontend (stub) + InternLM2-1.8B decoder.

Assigned: [vlm] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821].  The vision frontend supplies 256 precomputed patch
embeddings per image (stub per assignment); the decoder is InternLM2-style:
GQA, RoPE, SwiGLU.
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    block_pattern=("attn",),
    rope_theta=1e6,
    frontend="vision",
    n_prefix_embeds=256,
    source="InternVL2 [arXiv:2404.16821]; InternLM2 decoder",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, n_prefix_embeds=16)
