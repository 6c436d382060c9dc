"""HuBERT X-Large — audio: encoder-only transformer (wav2vec2 arch).

Assigned: [audio] 48L d_model=1280 16H (GQA kv=16 = MHA) d_ff=5120 vocab=504
[arXiv:2106.07447].  The conv feature extractor is a stub (precomputed frame
embeddings per the assignment); the model is the 48-layer bidirectional
encoder with a 504-way masked-prediction head.  Encoder-only ⇒ no decode
shapes (DESIGN.md §8).
"""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn",),
    causal=False,
    frontend="audio",
    source="HuBERT X-Large [arXiv:2106.07447]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_units=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=64)
