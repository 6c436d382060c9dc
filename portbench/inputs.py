"""The benchmark's inputs, made from ``--seed`` and handed alike to the
program and to the reference: a dense decoder's weights, drawn on the
device leaf by leaf in the type they are trained in.

The weights are laid out as the program's parameter tree (``embed``,
``units`` with every leaf stacked over the layers, ``final_norm``, and
``head`` when the head is not tied).  Each random leaf has a generator of
its own, seeded from the run's seed and the leaf's place, so one leaf can
be drawn again alone.  Random leaves are normal with the configuration's
``initializer_range`` as their standard deviation; norms start at 1,
biases at 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]


def dense_layout(cfg: Dict) -> List[Leaf]:
    """(name, shape, kind, scale) of every leaf, kind normal/ones/zeros."""
    M, F, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    H, KV, V = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["vocab_size"]
    Dh, s = M // H, float(cfg["initializer_range"])
    u = "units.block_0."
    leaves = [
        ("embed", (V, M), "normal", s),
        (u + "norm1.scale", (L, M), "ones", 0.0),
        (u + "attn.w_q", (L, M, H, Dh), "normal", s),
        (u + "attn.w_k", (L, M, KV, Dh), "normal", s),
        (u + "attn.w_v", (L, M, KV, Dh), "normal", s),
        (u + "attn.w_o", (L, H, Dh, M), "normal", s),
        (u + "attn.b_q", (L, H, Dh), "zeros", 0.0),
        (u + "attn.b_k", (L, KV, Dh), "zeros", 0.0),
        (u + "attn.b_v", (L, KV, Dh), "zeros", 0.0),
        (u + "norm2.scale", (L, M), "ones", 0.0),
        (u + "mlp.w_gate", (L, M, F), "normal", s),
        (u + "mlp.w_up", (L, M, F), "normal", s),
        (u + "mlp.w_down", (L, F, M), "normal", s),
        ("final_norm.scale", (M,), "ones", 0.0),
    ]
    if not cfg["tie_word_embeddings"]:
        leaves.append(("head", (M, V), "normal", s))
    return leaves


def draw_leaf(layout: List[Leaf], name: str, seed: int, device,
              dtype=torch.float32) -> torch.Tensor:
    i = [leaf[0] for leaf in layout].index(name)
    _, shape, kind, scale = layout[i]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + i) % (1 << 63))
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def draw_flat(layout: List[Leaf], seed: int, device,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every leaf, by its dotted name."""
    return {leaf[0]: draw_leaf(layout, leaf[0], seed, device, dtype)
            for leaf in layout}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """Dotted names → the nested tree the program takes."""
    tree: Dict = {}
    for name, x in flat.items():
        *path, last = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = x
    return tree


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def is_stacked(name: str) -> bool:
    return name.startswith("units.")

