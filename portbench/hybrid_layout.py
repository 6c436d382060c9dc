"""The weights of a published Zamba2 configuration, drawn from ``--seed``
leaf by leaf and handed alike to the program and to the reference.

Leaves are named as the program's parameter tree
(``repro_torch/models/hybrid.py``): ``embed``, ``layers.<i>.<leaf>``,
``shared.<k>.<leaf>``, ``final_norm.scale``, one leaf per layer (nothing
stacked), so the reference can draw one layer's weights again while it
runs.  A leaf's generator is seeded from the run's seed and the leaf's place
in :func:`layout` (``inputs.draw_leaf``'s rule), so one leaf can be drawn
again alone.  Kinds: ``normal`` (the configuration's
``initializer_range``, or the scale the configuration's ``assumed`` gives),
``ones``, ``zeros`` (``inputs.draw_leaf``), and two of Mamba2's own:
``a_log`` = log(1 … heads) and ``dt_bias`` = softplus⁻¹(dt), dt
log-uniform on [``time_step_min``, ``time_step_max``] floored at
``time_step_floor``.  ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever
the model's dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench import inputs

Leaf = Tuple[str, Tuple[int, ...], str, float]
FP32_LEAVES = ("A_log", "D", "dt_bias")


def widths(cfg: Dict) -> Dict[str, int]:
    M = cfg["hidden_size"]
    Din = cfg["mamba_expand"] * M
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    return dict(M=M, Din=Din, H=cfg["n_mamba_heads"], conv=Din + 2 * G * N,
                K=cfg["mamba_d_conv"], F=cfg["intermediate_size"],
                A=2 * M, HD=cfg["num_attention_heads"]
                * cfg["attention_head_dim"], r=cfg["adapter_rank"],
                V=cfg["vocab_size"])


def layout(cfg: Dict) -> List[Leaf]:
    """(name, shape, kind, scale) of every leaf."""
    w, s = widths(cfg), float(cfg["initializer_range"])
    conv_s = float(cfg["assumed_scales"]["conv_w"])
    M, H = w["M"], w["H"]
    leaves: List[Leaf] = [("embed", (w["V"], M), "normal", s)]
    hybrid = set(cfg["hybrid_layer_ids"])
    for i in range(cfg["num_hidden_layers"]):
        u = f"layers.{i}."
        leaves += [
            (u + "norm", (M,), "ones", 0.0),
            (u + "w_in", (M, w["Din"] + w["conv"] + H), "normal", s),
            (u + "conv_w", (w["K"], w["conv"]), "normal", conv_s),
            (u + "conv_b", (w["conv"],), "zeros", 0.0),
            (u + "dt_bias", (H,), "dt_bias", 0.0),
            (u + "A_log", (H,), "a_log", 0.0),
            (u + "D", (H,), "ones", 0.0),
            (u + "gate_norm", (w["Din"],), "ones", 0.0),
            (u + "w_out", (w["Din"], M), "normal", s),
        ]
        if i in hybrid:
            leaves += [(u + "linear", (M, M), "normal", s),
                       (u + "adapter_down", (M, w["r"]), "normal", s),
                       (u + "adapter_up", (w["r"], 2 * w["F"]), "normal", s)]
    for k in range(cfg["num_mem_blocks"]):
        b = f"shared.{k}."
        leaves += [
            (b + "input_norm", (w["A"],), "ones", 0.0),
            (b + "w_q", (w["A"], w["HD"]), "normal", s),
            (b + "w_k", (w["A"], w["HD"]), "normal", s),
            (b + "w_v", (w["A"], w["HD"]), "normal", s),
            (b + "w_o", (w["HD"], M), "normal", s),
            (b + "pre_ff_norm", (M,), "ones", 0.0),
            (b + "w_gate_up", (M, 2 * w["F"]), "normal", s),
            (b + "w_down", (w["F"], M), "normal", s),
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
    if kind == "dt_bias":
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 1_000_003 + i) % (1 << 63))
        lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg["time_step_floor"])
        return dt + torch.log(-torch.expm1(-dt))
    return inputs.draw_leaf(leaves, name, seed, device, dtype)


def draw_all(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    leaves = layout(cfg)
    return {leaf[0]: draw(cfg, leaves, leaf[0], seed, device, dtype)
            for leaf in leaves}


def port_config(cfg: Dict):
    """The program's ``HybridConfig`` of a configuration file; raises where
    the file states a variant the program does not compute."""
    from repro_torch.config import HybridConfig
    need = {"hidden_act": "gelu", "add_bias_linear": False,
            "use_shared_attention_adapter": False,
            "use_shared_mlp_adapter": True, "use_mem_rope": True,
            "use_long_context": False, "time_step_limit": None,
            "use_conv_bias": True}
    bad = {k: cfg[k] for k, v in need.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the program computes none of {bad}")
    M, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["num_key_value_heads"] != H:
        raise ValueError("the shared attention has as many K/V heads as "
                         "query heads")
    if cfg["attention_head_dim"] != 2 * M // H \
            or cfg["mamba_headdim"] * cfg["n_mamba_heads"] \
            != cfg["mamba_expand"] * M:
        raise ValueError("head widths disagree with the hidden size")
    hybrid = [i for i, t in enumerate(cfg["layers_block_type"])
              if t == "hybrid"]
    if hybrid != list(cfg["hybrid_layer_ids"]):
        raise ValueError("hybrid_layer_ids disagree with layers_block_type")
    L = cfg["num_hidden_layers"]
    return HybridConfig(
        name=cfg["name"], family="hybrid", n_layers=L, d_model=M,
        n_heads=H, n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        block_pattern=("mamba",), n_units=L,
        d_head=cfg["attention_head_dim"], rope_theta=float(cfg["rope_theta"]),
        ssm_state=cfg["mamba_d_state"], ssm_expand=cfg["mamba_expand"],
        ssm_head_dim=cfg["mamba_headdim"], ssm_chunk=cfg["chunk_size"],
        ssm_conv=cfg["mamba_d_conv"], dtype=cfg["torch_dtype"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        hybrid_layer_ids=tuple(hybrid),
        num_mem_blocks=cfg["num_mem_blocks"],
        adapter_rank=cfg["adapter_rank"], ssm_groups=cfg["mamba_ngroups"],
        source=cfg["source"])
