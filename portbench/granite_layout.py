"""The weights of a published Granite 4.0-H configuration, drawn from
``--seed`` leaf by leaf and handed alike to the program and to the
reference, and the program's ``GraniteConfig`` of the configuration file.

Leaves are named as the program's parameter tree
(``repro_torch/models/granite.py``): ``embed``, ``layers.<i>.<leaf>``
(``input_norm``, ``post_norm``, ``mamba.*`` or ``attn.*``, ``moe.router``,
``moe.w_in``, ``moe.w_out``, ``shared.w_in``, ``shared.w_out``),
``final_norm.scale``, one leaf per layer (nothing stacked), so the
reference can draw one layer's weights again while it runs.  A leaf's
generator is seeded from the run's seed and the leaf's place in
:func:`layout` (``inputs.draw_leaf``'s rule).  Kinds: ``normal`` (the
configuration's ``initializer_range``, or the scale its ``assumed``
gives), ``ones``, ``zeros`` and ``a_log`` = log(1 … heads).  ``A_log``,
``D`` and ``dt_bias`` are fp32 whatever the model's dtype.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import inputs

Leaf = Tuple[str, Tuple[int, ...], str, float]
FP32_LEAVES = ("A_log", "D", "dt_bias")


def widths(cfg: Dict) -> Dict[str, int]:
    M = cfg["hidden_size"]
    Din = cfg["mamba_expand"] * M
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    D = M // cfg["num_attention_heads"]
    return dict(M=M, Din=Din, H=cfg["mamba_n_heads"], conv=Din + 2 * G * N,
                K=cfg["mamba_d_conv"], HD=cfg["num_attention_heads"] * D,
                KD=cfg["num_key_value_heads"] * D,
                E=cfg["num_local_experts"], F=cfg["intermediate_size"],
                S=cfg["shared_intermediate_size"], V=cfg["vocab_size"])


def layout(cfg: Dict) -> List[Leaf]:
    """(name, shape, kind, scale) of every leaf."""
    w, s = widths(cfg), float(cfg["initializer_range"])
    conv_s = float(cfg["assumed_scales"]["conv_w"])
    M, H, E = w["M"], w["H"], w["E"]
    leaves: List[Leaf] = [("embed", (w["V"], M), "normal", s)]
    for i, kind in enumerate(cfg["layer_types"]):
        u = f"layers.{i}."
        leaves.append((u + "input_norm", (M,), "ones", 0.0))
        if kind == "mamba":
            m = u + "mamba."
            leaves += [
                (m + "w_in", (M, w["Din"] + w["conv"] + H), "normal", s),
                (m + "conv_w", (w["K"], w["conv"]), "normal", conv_s),
                (m + "conv_b", (w["conv"],), "zeros", 0.0),
                (m + "dt_bias", (H,), "ones", 0.0),
                (m + "A_log", (H,), "a_log", 0.0),
                (m + "D", (H,), "ones", 0.0),
                (m + "gate_norm", (w["Din"],), "ones", 0.0),
                (m + "w_out", (w["Din"], M), "normal", s),
            ]
        else:
            a = u + "attn."
            leaves += [(a + "w_q", (M, w["HD"]), "normal", s),
                       (a + "w_k", (M, w["KD"]), "normal", s),
                       (a + "w_v", (M, w["KD"]), "normal", s),
                       (a + "w_o", (w["HD"], M), "normal", s)]
        leaves += [
            (u + "post_norm", (M,), "ones", 0.0),
            (u + "moe.router", (M, E), "normal", s),
            (u + "moe.w_in", (E, M, 2 * w["F"]), "normal", s),
            (u + "moe.w_out", (E, w["F"], M), "normal", s),
            (u + "shared.w_in", (M, 2 * w["S"]), "normal", s),
            (u + "shared.w_out", (w["S"], M), "normal", s),
        ]
    leaves.append(("final_norm.scale", (M,), "ones", 0.0))
    if not cfg["tie_word_embeddings"]:
        leaves.append(("head", (M, w["V"]), "normal", s))
    return leaves


def draw(cfg: Dict, leaves: List[Leaf], name: str, seed: int, device,
         dtype) -> torch.Tensor:
    """One leaf, in ``dtype`` (fp32 for ``FP32_LEAVES``)."""
    if name.rsplit(".", 1)[-1] in FP32_LEAVES:
        dtype = torch.float32
    i = [leaf[0] for leaf in leaves].index(name)
    _, shape, kind, _ = leaves[i]
    if kind == "a_log":
        return torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                      device=device))
    return inputs.draw_leaf(leaves, name, seed, device, dtype)


def draw_all(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    leaves = layout(cfg)
    return {leaf[0]: draw(cfg, leaves, leaf[0], seed, device, dtype)
            for leaf in leaves}


def port_config(cfg: Dict):
    """The program's ``GraniteConfig`` of a configuration file; raises
    where the file states a variant the program does not compute."""
    from repro_torch.config import GraniteConfig
    need = {"hidden_act": "silu", "attention_bias": False,
            "mamba_conv_bias": True, "mamba_proj_bias": False,
            "position_embedding_type": "nope",
            "normalization_function": "rmsnorm", "mamba_d_conv": 4}
    bad = {k: cfg[k] for k, v in need.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the program computes none of {bad}")
    M, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["mamba_d_head"] * cfg["mamba_n_heads"] \
            != cfg["mamba_expand"] * M or M % H:
        raise ValueError("head widths disagree with the hidden size")
    if len(cfg["layer_types"]) != cfg["num_hidden_layers"]:
        raise ValueError("layer_types disagree with num_hidden_layers")
    L = cfg["num_hidden_layers"]
    return GraniteConfig(
        name=cfg["name"], family="hybrid", n_layers=L, d_model=M,
        n_heads=H, n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        block_pattern=("mamba",), n_units=L, d_head=M // H,
        n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["intermediate_size"],
        ssm_state=cfg["mamba_d_state"], ssm_expand=cfg["mamba_expand"],
        ssm_head_dim=cfg["mamba_d_head"], ssm_chunk=cfg["mamba_chunk_size"],
        ssm_conv=cfg["mamba_d_conv"], dtype=cfg["torch_dtype"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        layer_types=tuple(cfg["layer_types"]),
        shared_d_ff=cfg["shared_intermediate_size"],
        ssm_groups=cfg["mamba_n_groups"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        source=cfg["source"])
