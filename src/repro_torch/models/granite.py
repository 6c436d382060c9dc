"""Granite 4.0-H as published (``config.GraniteConfig``; ``configs/
granite_4_0_h_small.py``): a list of layers, each one mixer (Mamba2 or
attention, as ``cfg.layer_types`` says) and one expert layer.

With x the residual stream, e the token embedding and r the residual
multiplier::

    x = e · embedding_multiplier
    per layer:
        x = x + r · Mixer(RMSNorm(x))
        n = RMSNorm(x)
        x = x + r · (MoE(n) + SharedMLP(n))
    logits = Head(RMSNorm(x)) / logits_scaling        (head tied to e)

The Mamba2 mixer is ``hybrid.mamba_forward`` (one fused input projection
[z | x B C | dt], the causal convolution with SiLU, dt = softplus(dt +
dt_bias), the SSD scan with B / C in ``ssm_groups`` groups, + D·x, the
gated RMSNorm, the out projection).  Attention has no position encoding:
q·k scaled by ``attention_multiplier``, ``n_kv_heads`` K/V heads, causal.
The MoE is dropless: the router's product accumulates in fp32 and is not
rounded before the top-``top_k`` (ties to the lower expert), the gates
are the softmax over the chosen logits, each expert is a SwiGLU
(silu(x W_gate) · x W_up) W_down of width ``moe_d_ff`` over the rows
routed to it, and the shared MLP is the same at ``shared_d_ff``.

Parameters are a nested dict: ``embed``, ``final_norm`` and ``layers.<i>``
with ``input_norm``, ``post_norm``, the mixer (``mamba``: the Mamba2
leaves of ``models/hybrid.py``; or ``attn``: ``w_q`` (M, H·D), ``w_k`` /
``w_v`` (M, KV·D), ``w_o`` (H·D, M)), ``moe`` (``router`` (M, E),
``w_in`` (E, M, 2F) [gate | up], ``w_out`` (E, F, M)) and ``shared``
(``w_in`` (M, 2S), ``w_out`` (S, M)).

The prefill runs ``kernels.ops.flash_attention`` (``attn_impl="pallas"``)
and, under ``use_pallas``, the Mamba2 kernels, every RMSNorm through
``kernels.ops.rms_norm``, and ``kernels.ops.moe_dispatch`` /
``moe_combine`` around the experts; their plain versions elsewhere.  The
expert products are one grouped product each (``torch._grouped_mm``,
reading the experts' row ends on the device) for bf16 rows on the card,
else one product per expert after one read of the counts.  Decoding
runs the plain paths; no test trains the model.
Spans: ``moe`` around each expert layer, shared MLP included (counting
``moe.tokens`` and ``moe.pairs``), and ``moe_experts`` around its expert
products alone, both on the device's clock too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.config import GraniteConfig, RunConfig
from repro_torch.kernels import moe_route
from repro_torch.models import attention as attn
from repro_torch.models import hybrid
from repro_torch.models.layers import (dtype_of, embed, init_embedding,
                                       init_lm_head, lm_head, normal)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_attn(gen, cfg: GraniteConfig, dtype, device) -> dict:
    M, HD, KD = cfg.d_model, cfg.n_heads * cfg.d_head, \
        cfg.n_kv_heads * cfg.d_head
    s = float(1.0 / np.sqrt(M))
    return {"w_q": normal(gen, (M, HD), dtype, device, s),
            "w_k": normal(gen, (M, KD), dtype, device, s),
            "w_v": normal(gen, (M, KD), dtype, device, s),
            "w_o": normal(gen, (HD, M), dtype, device,
                          float(1.0 / np.sqrt(HD)))}


def _init_ffn(gen, cfg: GraniteConfig, dtype, device) -> Tuple[dict, dict]:
    M, E, Fe, Fs = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, \
        cfg.shared_d_ff
    s = float(1.0 / np.sqrt(M))
    moe = {"router": normal(gen, (M, E), dtype, device, s),
           "w_in": normal(gen, (E, M, 2 * Fe), dtype, device, s),
           "w_out": normal(gen, (E, Fe, M), dtype, device,
                           float(1.0 / np.sqrt(Fe)))}
    shared = {"w_in": normal(gen, (M, 2 * Fs), dtype, device, s),
              "w_out": normal(gen, (Fs, M), dtype, device,
                              float(1.0 / np.sqrt(Fs)))}
    return moe, shared


def init_params(cfg: GraniteConfig, gen: Optional[torch.Generator],
                device) -> dict:
    """The parameter tree drawn from ``gen`` on ``device``."""
    dtype = dtype_of(cfg.dtype)
    M = cfg.d_model
    layers = {}
    for i, kind in enumerate(cfg.layer_types):
        p = {"input_norm": torch.ones((M,), dtype=dtype, device=device)}
        if kind == "mamba":
            p["mamba"] = hybrid.init_mamba(gen, cfg, dtype, device)
            p["mamba"]["dt_bias"] = torch.ones(
                (cfg.ssm_n_heads,), dtype=torch.float32, device=device)
        else:
            p["attn"] = _init_attn(gen, cfg, dtype, device)
        p["post_norm"] = torch.ones((M,), dtype=dtype, device=device)
        p["moe"], p["shared"] = _init_ffn(gen, cfg, dtype, device)
        layers[str(i)] = p
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, M, dtype, device),
        "layers": layers,
        "final_norm": {"scale": torch.ones((M,), dtype=dtype,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, M, cfg.padded_vocab, dtype,
                                      device)
    return params


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------
def _qkv(cfg: GraniteConfig, w: dict, h: torch.Tensor):
    return (torch.matmul(h, w["w_q"]).unflatten(-1, (cfg.n_heads, -1)),
            torch.matmul(h, w["w_k"]).unflatten(-1, (cfg.n_kv_heads, -1)),
            torch.matmul(h, w["w_v"]).unflatten(-1, (cfg.n_kv_heads, -1)))


def attention_forward(cfg: GraniteConfig, run: RunConfig, w: dict,
                      h: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of a full sequence, no position encoding."""
    q, k, v = _qkv(cfg, w, h)
    scale = cfg.attn_scale
    if run.attn_impl == "pallas":
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q, k, v, causal=True, scale=scale)
    elif run.attn_impl == "naive":
        o = attn.naive_attention(q, k, v, causal=True, scale=scale)
    else:
        o = attn.chunked_attention(q, k, v, causal=True,
                                   q_chunk=run.attn_q_chunk,
                                   kv_chunk=run.attn_kv_chunk,
                                   unroll=run.unroll, scale=scale)
    return torch.matmul(o.flatten(-2), w["w_o"])


def attention_step(cfg: GraniteConfig, w: dict, h: torch.Tensor,
                   position: torch.Tensor, cache: dict) -> torch.Tensor:
    """One token against the layer's K/V cache (written in place)."""
    q, k, v = _qkv(cfg, w, h)
    attn.cache_insert(cache, k, v, position)
    C = cache["k"].shape[1]
    o = attn.decode_attention(q, cache["k"], cache["v"],
                              torch.clamp(position + 1, max=C),
                              scale=cfg.attn_scale)
    return torch.matmul(o.flatten(-2), w["w_o"])


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------
def _swiglu(gu: torch.Tensor) -> torch.Tensor:
    g, u = gu.chunk(2, dim=-1)
    return F.silu(g) * u


def _grouped(a: torch.Tensor, w: torch.Tensor, ends: torch.Tensor,
             counts: torch.Tensor) -> torch.Tensor:
    """Each expert's rows of a (rows in expert order) times its matrix of
    w (E, K, N): one grouped product reading ``ends`` on the device for
    bf16 rows on the card, else one product per expert after one read of
    the counts."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w, offs=ends)
    out = torch.empty((a.shape[0], w.shape[-1]), dtype=a.dtype,
                      device=a.device)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            torch.matmul(a[start:start + n], w[e], out=out[start:start + n])
        start += n
    return out


def _route(logits: torch.Tensor, n: torch.Tensor, k: int,
           use_pallas: bool) -> moe_route.Routed:
    """The dispatch: the kernel under ``use_pallas``, else its plain
    version."""
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.moe_dispatch(logits, n, k)
    return moe_route.moe_dispatch_plain(logits, n, k)


def moe_forward(cfg: GraniteConfig, run: RunConfig, p: dict,
                n: torch.Tensor, x: torch.Tensor,
                routes: Optional[list] = None) -> torch.Tensor:
    """x + r · (MoE(n) + SharedMLP(n)) for rows n (normed) and x (the
    residual), both (T, M); appends each token's experts to ``routes``
    when given."""
    if run.use_pallas:
        from repro_torch.kernels import ops as kops
        combine = kops.moe_combine
    else:
        combine = moe_route.moe_combine_plain
    T = n.shape[0]
    w = p["moe"]
    with obs.span("moe"):
        obs.count("moe.tokens", T)
        obs.count("moe.pairs", T * cfg.top_k)
        logits = torch.matmul(n.to(torch.float32),
                              w["router"].to(torch.float32))
        r = _route(logits, n, cfg.top_k, run.use_pallas)
        if routes is not None:
            routes.append(r.experts)
        with obs.span("moe_experts"):
            h = _swiglu(_grouped(r.xs, w["w_in"], r.ends, r.counts))
            rows = _grouped(h, w["w_out"], r.ends, r.counts)
        sh = p["shared"]
        shared = torch.matmul(_swiglu(torch.matmul(n, sh["w_in"])),
                              sh["w_out"])
        return combine(rows, r.gates, r.pos, shared, x,
                       cfg.residual_multiplier)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def embed_tokens(cfg: GraniteConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return embed(tokens, params["embed"]) * cfg.embedding_multiplier


def mixer(cfg: GraniteConfig, run: RunConfig, p: dict, kind: str,
          x: torch.Tensor) -> torch.Tensor:
    """Mixer(RMSNorm(x)) over a full sequence: the mixer's branch, which
    enters the residual stream times r."""
    h = hybrid.norm_of(run.use_pallas)(x, p["input_norm"], cfg.norm_eps)
    if kind == "mamba":
        return hybrid.mamba_forward(cfg, p["mamba"], h,
                                    use_pallas=run.use_pallas)
    return attention_forward(cfg, run, p["attn"], h)


def ffn_step(cfg: GraniteConfig, run: RunConfig, p: dict, x: torch.Tensor,
             routes: Optional[list] = None) -> torch.Tensor:
    """x + r · (MoE(n) + SharedMLP(n)), n = RMSNorm(x), over (B, S, M)."""
    B, S, M = x.shape
    n = hybrid.norm_of(run.use_pallas)(x, p["post_norm"], cfg.norm_eps)
    return moe_forward(cfg, run, p, n.reshape(B * S, M), x.reshape(B * S, M),
                       routes).reshape(B, S, M)


def head(cfg: GraniteConfig, params: dict, x: torch.Tensor,
         use_pallas: bool = False) -> torch.Tensor:
    """The final norm, the head and the division by ``logits_scaling``,
    folded into the norm's scale (exact: ``GraniteConfig`` holds it to a
    power of two, and scaling by 2^-j commutes with every rounding)."""
    scale = params["final_norm"]["scale"] / cfg.logits_scaling
    x = hybrid.norm_of(use_pallas)(x, scale, cfg.norm_eps)
    head_w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = lm_head(x, head_w)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def forward(cfg: GraniteConfig, run: RunConfig, params: dict,
            batch: Dict[str, torch.Tensor], states: Optional[list] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits fp32 (B, S, V), aux);
    ``aux["experts"]`` lists each layer's (B·S, top_k) chosen experts.
    ``states``, when given, gets host copies of the residual stream after
    the embedding, then per layer of the mixer's branch, the stream after
    the mixer and the stream after the expert layer (a check compares the
    forward with a reference step by step)."""
    keep = (lambda t: states.append(t.cpu())) if states is not None \
        else (lambda t: None)
    x = embed_tokens(cfg, params, batch["tokens"])
    keep(x)
    routes: list = []
    for i, kind in enumerate(cfg.layer_types):
        p = params["layers"][str(i)]
        y = mixer(cfg, run, p, kind, x)
        keep(y)
        x = torch.add(x, y, alpha=cfg.residual_multiplier)
        keep(x)
        x = ffn_step(cfg, run, p, x, routes)
        keep(x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return (head(cfg, params, x, run.use_pallas),
            {"lb_loss": zero, "z_loss": zero, "experts": routes})


def init_caches(cfg: GraniteConfig, batch: int, max_len: int,
                device) -> dict:
    """Per layer: the Mamba2 state (fp32) and convolution history, or the
    attention layer's K/V cache."""
    dtype = dtype_of(cfg.dtype)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    caches = {}
    for i, kind in enumerate(cfg.layer_types):
        if kind == "mamba":
            caches[str(i)] = hybrid.init_mamba_cache(cfg, batch, dtype,
                                                     device)
        else:
            caches[str(i)] = {
                "k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
    return {"layers": caches}


def decode_step(cfg: GraniteConfig, run: RunConfig, params: dict,
                token: torch.Tensor, position: torch.Tensor,
                caches: dict) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence on the plain paths; writes ``caches``
    in place."""
    plain = RunConfig(attn_impl=run.attn_impl)
    x = embed_tokens(cfg, params, token)
    norm = hybrid.norm_of(False)
    for i, kind in enumerate(cfg.layer_types):
        p, cache = params["layers"][str(i)], caches["layers"][str(i)]
        h = norm(x, p["input_norm"], cfg.norm_eps)
        if kind == "mamba":
            y = hybrid.mamba_step(cfg, p["mamba"], h, cache)
        else:
            y = attention_step(cfg, p["attn"], h, position, cache)
        x = ffn_step(cfg, plain, p, torch.add(x, y,
                                              alpha=cfg.residual_multiplier))
    return head(cfg, params, x), caches
