"""Architecture registry of the port: one module per architecture.

Every module exports ``CONFIG`` (the exact assigned full-scale config, cited)
and ``SMOKE`` (a reduced same-family variant: ≤2–3 units, d_model ≤ 512,
≤ 4 experts) used by the CPU smoke tests.  ``get_config(name)`` /
``get_smoke(name)`` resolve by CLI ``--arch`` id.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# Only the architectures the port uses so far; the rest of the reference's
# registry (repro/configs) ports with the model stack (ROADMAP.md queue 1
# item 10).  qwen2_1_5b sizes the what-if problem (QuadraticProblem(arch=)).
ARCH_IDS: List[str] = [
    "qwen2_1_5b",
]

# CLI aliases with dashes/dots
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES["qwen2-1.5b"] = "qwen2_1_5b"


def _resolve(name: str) -> str:
    name = name.strip()
    if name in ARCH_IDS:
        return name
    if name in ALIASES:
        return ALIASES[name]
    norm = name.replace("-", "_").replace(".", "_")
    if norm in ARCH_IDS:
        return norm
    raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_resolve(name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_resolve(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """Sliding-window variant for long_500k on full-attention archs
    (DESIGN.md §8).  No-op for attention-free models."""
    if cfg.attention_free or cfg.sliding_window:
        return cfg
    return dataclasses.replace(cfg, sliding_window=window)
