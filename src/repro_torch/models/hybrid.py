"""Zamba2 as published (``config.HybridConfig``; ``configs/
zamba2_7b_instruct.py``): a list of Mamba2 layers, some of which first run
a weight-shared transformer block.

Per layer i, with e the token embedding and x the residual stream::

    T  = Shared_k(concat(x, e))        only at i in cfg.hybrid_layer_ids,
                                       k = the blocks in turn (0, 1, 0, …)
    x  = x + Mamba_i(RMSNorm(x + W_i · T))      (T enters the input only)

``Shared_k`` has no residual inside: RMSNorm over the 2·d_model input →
attention of ``n_heads`` heads of ``d_head`` = 2·d_model / n_heads with
RoPE over all of ``d_head`` and q·k scaled by (d_head/2)^-½ → out
projection → RMSNorm → a gated exact-erf GELU MLP whose gate/up projection
carries layer i's own rank-``adapter_rank`` adapter.  The Mamba2 layer is
one fused input projection [z | x B C | dt], a depthwise causal convolution
over x B C with SiLU, dt = softplus(dt + dt_bias) (no clamp: the published
``time_step_limit`` is null), the SSD scan with B / C in ``ssm_groups``
groups (head h reads group h // (H / G)), + D·x, a gated RMSNorm over
groups of d_inner / G (y · silu(z), normalised per group) and the out
projection.  A final RMSNorm and the head tied to the embedding give the
logits.

Parameters are a nested dict: ``embed``, ``final_norm``, ``shared.<k>``
(each block's norms and projections) and ``layers.<i>`` (the Mamba2
layer's leaves, and at a hybrid layer its ``linear`` W_i and adapter
``adapter_down`` / ``adapter_up``).  ``A_log``, ``D`` and ``dt_bias`` are
fp32 whatever the model dtype.  Caches: ``layers.<i>`` the SSM state
(fp32) and the convolution's last K−1 inputs, ``kv.<i>`` one K/V cache per
hybrid layer (the shared blocks share weights, never caches).

The prefill runs ``kernels.ops.flash_attention`` (``attn_impl="pallas"``)
and, under ``use_pallas``, each Mamba2 layer's ``kernels.ops.mamba_in``,
``ssm_scan`` and ``mamba_out`` (the convolution, gates and norm around the
scan) and every RMSNorm of the residual stream and the shared blocks
through ``kernels.ops.rms_norm`` (the shared block's input norm reads x
and e as two pieces, no concatenation) on the card, their plain versions
otherwise; decoding runs the plain norms; training goes through
autograd on the plain path, each layer a ``torch.utils.checkpoint`` region
under ``RunConfig.remat``.
Spans: ``shared_block`` around each shared-block call (on the device's
clock too), counting ``shared_block.<k>``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.config import HybridConfig, RunConfig
from repro_torch.kernels import mamba_glue
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_rope, dtype_of, embed,
                                       init_embedding, init_lm_head,
                                       lm_head, normal, rms_norm)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _mamba_widths(cfg) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, heads, head dim, state, groups, convolved width)."""
    Din, N, G = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_groups
    return Din, cfg.ssm_n_heads, cfg.ssm_head_dim, N, G, Din + 2 * G * N


def init_mamba(gen, cfg, dtype, device) -> dict:
    """One Mamba2 mixer's leaves drawn from ``gen`` (``cfg`` a
    ``HybridConfig`` or a ``GraniteConfig``)."""
    M, K = cfg.d_model, cfg.ssm_conv
    Din, H, P, N, G, conv = _mamba_widths(cfg)
    dt = np.exp(np.random.RandomState(0).uniform(
        np.log(1e-3), np.log(1e-1), size=(H,))).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": normal(gen, (M, Din + conv + H), dtype, device,
                       float(1.0 / np.sqrt(M))),
        "conv_w": normal(gen, (K, conv), dtype, device,
                         float(1.0 / np.sqrt(K))),
        "conv_b": torch.zeros((conv,), dtype=dtype, device=device),
        "dt_bias": torch.from_numpy(dt + np.log(-np.expm1(-dt))).to(device),
        "A_log": torch.log(torch.arange(1, H + 1, **f32)),
        "D": torch.ones((H,), **f32),
        "gate_norm": torch.ones((Din,), dtype=dtype, device=device),
        "w_out": normal(gen, (Din, M), dtype, device,
                        float(1.0 / np.sqrt(Din))),
    }


def _init_layer(gen, cfg: HybridConfig, hybrid: bool, dtype,
                device) -> dict:
    M = cfg.d_model
    p = {"norm": torch.ones((M,), dtype=dtype, device=device),
         **init_mamba(gen, cfg, dtype, device)}
    if hybrid:
        r, F2 = cfg.adapter_rank, 2 * cfg.d_ff
        p["linear"] = normal(gen, (M, M), dtype, device,
                             float(1.0 / np.sqrt(M)))
        p["adapter_down"] = normal(gen, (M, r), dtype, device,
                                   float(1.0 / np.sqrt(M)))
        p["adapter_up"] = normal(gen, (r, F2), dtype, device,
                                 float(1.0 / np.sqrt(r)))
    return p


def _init_shared(gen, cfg: HybridConfig, dtype, device) -> dict:
    M, F_, HD = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.d_head
    A = 2 * M
    s = float(1.0 / np.sqrt(A))
    return {
        "input_norm": torch.ones((A,), dtype=dtype, device=device),
        "w_q": normal(gen, (A, HD), dtype, device, s),
        "w_k": normal(gen, (A, HD), dtype, device, s),
        "w_v": normal(gen, (A, HD), dtype, device, s),
        "w_o": normal(gen, (HD, M), dtype, device, float(1.0 / np.sqrt(HD))),
        "pre_ff_norm": torch.ones((M,), dtype=dtype, device=device),
        "w_gate_up": normal(gen, (M, 2 * F_), dtype, device,
                            float(1.0 / np.sqrt(M))),
        "w_down": normal(gen, (F_, M), dtype, device,
                         float(1.0 / np.sqrt(F_))),
    }


def init_params(cfg: HybridConfig, gen: Optional[torch.Generator],
                device) -> dict:
    """The parameter tree drawn from ``gen`` on ``device``."""
    dtype = dtype_of(cfg.dtype)
    hybrid = set(cfg.hybrid_layer_ids)
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                device),
        "layers": {str(i): _init_layer(gen, cfg, i in hybrid, dtype, device)
                   for i in range(cfg.n_layers)},
        "shared": {str(k): _init_shared(gen, cfg, dtype, device)
                   for k in range(cfg.num_mem_blocks)},
        "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, cfg.d_model, cfg.padded_vocab,
                                      dtype, device)
    return params


# ---------------------------------------------------------------------------
# Mamba2 layer
# ---------------------------------------------------------------------------
def _gated_out(cfg: HybridConfig, p: dict, y: torch.Tensor,
               z: torch.Tensor, dtype) -> torch.Tensor:
    """RMSNorm(y · silu(z)) over groups of d_inner / G, then the out
    projection; y fp32 (…, Din)."""
    h = mamba_glue.gated_norm_plain(y, z, p["gate_norm"], cfg.ssm_groups,
                                    cfg.norm_eps, dtype)
    return torch.matmul(h, p["w_out"])


def _split_bc(cfg: HybridConfig, bc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B and C of the convolved (…, 2·G·N) columns as (…, G, N) views."""
    G, N = cfg.ssm_groups, cfg.ssm_state
    return (bc[..., :G * N].unflatten(-1, (G, N)),
            bc[..., G * N:].unflatten(-1, (G, N)))


def _project(cfg: HybridConfig, p: dict, x: torch.Tensor):
    """x → z, the convolution's input x B C, dt (views of one product)."""
    Din, H, _, _, _, conv = _mamba_widths(cfg)
    zxbcdt = torch.matmul(x, p["w_in"])
    return (zxbcdt[..., :Din], zxbcdt[..., Din:Din + conv],
            zxbcdt[..., Din + conv:])


def mamba_forward(cfg: HybridConfig, p: dict, x: torch.Tensor,
                  use_pallas: bool = False) -> torch.Tensor:
    """One Mamba2 layer over a full sequence.  x: (B, S, M) normed."""
    Din, H, P, _, G, _ = _mamba_widths(cfg)
    z, xbc, dt = _project(cfg, p, x)
    if use_pallas:
        from repro_torch.kernels import ops as kops
        glue_in, scan, glue_out = kops.mamba_in, kops.ssm_scan, \
            kops.mamba_out
    else:
        glue_in, scan, glue_out = mamba_glue.mamba_in_plain, \
            ssm_scan_plain, mamba_glue.mamba_out_plain
    xbc, xdt, a = glue_in(xbc, dt, p["conv_w"], p["conv_b"], p["dt_bias"],
                          p["A_log"], head_dim=P)
    Bm, Cm = _split_bc(cfg, xbc[..., Din:])
    y, _ = scan(xdt, a, Bm, Cm, chunk=cfg.ssm_chunk)
    h = glue_out(y, xbc[..., :Din].unflatten(-1, (H, P)), z, p["D"],
                 p["gate_norm"], groups=G, eps=cfg.norm_eps)
    return torch.matmul(h, p["w_out"])


def mamba_step(cfg: HybridConfig, p: dict, x: torch.Tensor,
               cache: dict) -> torch.Tensor:
    """One token through one Mamba2 layer; writes ``cache`` in place.
    x: (B, 1, M) normed."""
    Bt = x.shape[0]
    Din, H, P, N, G, _ = _mamba_widths(cfg)
    f32 = torch.float32
    z, xbc, dt = _project(cfg, p, x)
    xbc, hist = mamba_glue.causal_conv_plain(xbc, p["conv_w"], p["conv_b"],
                                             cache["conv"])
    xs = xbc[:, 0, :Din].reshape(Bt, H, P).to(f32)
    Bm, Cm = _split_bc(cfg, xbc[:, 0, Din:])
    Bh = Bm.to(f32).repeat_interleave(H // G, dim=1)              # (B,H,N)
    Ch = Cm.to(f32).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"])              # (B,H)
    a = dt * -torch.exp(p["A_log"])
    state = (torch.exp(a)[..., None, None] * cache["state"]
             + torch.einsum("bhn,bhp->bhnp", Bh, xs * dt[..., None]))
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) + xs * p["D"][:, None]
    cache["state"].copy_(state)
    cache["conv"].copy_(hist)
    return _gated_out(cfg, p, y.reshape(Bt, 1, Din), z, x.dtype)


# ---------------------------------------------------------------------------
# the shared transformer block
# ---------------------------------------------------------------------------
def norm_of(use_pallas: bool):
    """RMSNorm(x, scale, eps, tail=None): the kernel under ``use_pallas``,
    else the plain version."""
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.rms_norm
    return rms_norm


def _qkv(cfg: HybridConfig, w: dict, x: torch.Tensor, e: torch.Tensor,
         positions: torch.Tensor, use_pallas: bool = False):
    H, Dh = cfg.n_heads, cfg.d_head
    h = norm_of(use_pallas)(x, w["input_norm"], cfg.norm_eps, tail=e)
    q, k, v = (torch.matmul(h, w[n]).unflatten(-1, (H, Dh))
               for n in ("w_q", "w_k", "w_v"))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _mlp(cfg: HybridConfig, w: dict, p: dict, o: torch.Tensor,
         use_pallas: bool = False) -> torch.Tensor:
    """Out projection, RMSNorm, the gated GELU MLP with layer p's
    adapter."""
    a = norm_of(use_pallas)(torch.matmul(o.flatten(-2), w["w_o"]),
                            w["pre_ff_norm"], cfg.norm_eps)
    gu = torch.matmul(a, w["w_gate_up"]) + torch.matmul(
        torch.matmul(a, p["adapter_down"]), p["adapter_up"])
    g, u = gu.chunk(2, dim=-1)
    h = F.gelu(g.to(torch.float32)).to(a.dtype) * u
    return torch.matmul(h, w["w_down"])


def shared_block_forward(cfg: HybridConfig, run: RunConfig, w: dict,
                         p: dict, x: torch.Tensor, e: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """T of a full sequence (causal self-attention)."""
    q, k, v = _qkv(cfg, w, x, e, positions, run.use_pallas)
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
    return _mlp(cfg, w, p, o, run.use_pallas)


def shared_block_step(cfg: HybridConfig, w: dict, p: dict, x: torch.Tensor,
                      e: torch.Tensor, position: torch.Tensor,
                      cache: dict) -> torch.Tensor:
    """T of one token against the layer's K/V cache (written in place)."""
    pos = position.reshape(1, 1) if position.dim() == 0 \
        else position[:, None]
    q, k, v = _qkv(cfg, w, x, e, pos)
    attn.cache_insert(cache, k, v, position)
    C = cache["k"].shape[1]
    o = attn.decode_attention(q, cache["k"], cache["v"],
                              torch.clamp(position + 1, max=C),
                              scale=cfg.attn_scale)
    return _mlp(cfg, w, p, o)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _layer(cfg: HybridConfig, run: RunConfig, params: dict, i: int,
           x: torch.Tensor, e: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    p = params["layers"][str(i)]
    xin = x
    if i in cfg.hybrid_layer_ids:
        k = cfg.shared_block_of(i)
        with obs.span("shared_block"):
            obs.count(f"shared_block.{k}")
            xin = x + torch.matmul(shared_block_forward(
                cfg, run, params["shared"][str(k)], p, x, e, positions),
                p["linear"])
    return x + mamba_forward(
        cfg, p, norm_of(run.use_pallas)(xin, p["norm"], cfg.norm_eps),
        use_pallas=run.use_pallas)


def _logits(cfg: HybridConfig, params: dict, x: torch.Tensor,
            use_pallas: bool = False):
    x = norm_of(use_pallas)(x, params["final_norm"]["scale"], cfg.norm_eps)
    head_w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = lm_head(x, head_w)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def forward(cfg: HybridConfig, run: RunConfig, params: dict,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits fp32 (B, S, V), aux)."""
    e = embed(batch["tokens"], params["embed"])
    x = e
    positions = torch.arange(e.shape[1], device=e.device)
    remat = run.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            x = checkpoint(_layer, cfg, run, params, i, x, e, positions,
                           use_reentrant=False)
        else:
            x = _layer(cfg, run, params, i, x, e, positions)
    zero = torch.zeros((), dtype=torch.float32, device=e.device)
    return (_logits(cfg, params, x, run.use_pallas),
            {"lb_loss": zero, "z_loss": zero})


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    """One Mamba2 mixer's decode state: the SSM state (fp32) and the
    convolution's last K−1 inputs."""
    Din, H, P, N, G, conv = _mamba_widths(cfg)
    return {"state": torch.zeros((batch, H, N, P), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv),
                                dtype=dtype, device=device)}


def init_caches(cfg: HybridConfig, batch: int, max_len: int,
                device) -> dict:
    dtype = dtype_of(cfg.dtype)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "layers": {str(i): init_mamba_cache(cfg, batch, dtype, device)
                   for i in range(cfg.n_layers)},
        "kv": {str(i): {"k": torch.zeros(kv, dtype=dtype, device=device),
                        "v": torch.zeros(kv, dtype=dtype, device=device)}
               for i in cfg.hybrid_layer_ids},
    }


def decode_step(cfg: HybridConfig, run: RunConfig, params: dict,
                token: torch.Tensor, position: torch.Tensor,
                caches: dict) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence; writes ``caches`` in place."""
    e = embed(token, params["embed"])
    x = e
    for i in range(cfg.n_layers):
        p = params["layers"][str(i)]
        xin = x
        if i in cfg.hybrid_layer_ids:
            k = cfg.shared_block_of(i)
            with obs.span("shared_block"):
                obs.count(f"shared_block.{k}")
                xin = x + torch.matmul(shared_block_step(
                    cfg, params["shared"][str(k)], p, x, e, position,
                    caches["kv"][str(i)]), p["linear"])
        x = x + mamba_step(cfg, p, rms_norm(xin, p["norm"], cfg.norm_eps),
                           caches["layers"][str(i)])
    return _logits(cfg, params, x), caches
