"""Plain fp32 reference of Granite 4.0-H's forward, written from the
published description: the model's ``config.json`` and the layer
equations of ``transformers``' ``modeling_granitemoehybrid.py``.

With e the token embedding and r = ``residual_multiplier``::

    x = e · embedding_multiplier
    per layer i (layer_types[i] is "mamba" or "attention"):
        x = x + r · Mixer_i(RMSNorm(x))
        n = RMSNorm(x)
        x = x + r · (MoE_i(n) + Shared_i(n))
    logits = RMSNorm(x) Eᵀ / logits_scaling              (head tied)

Attention: q, k, v = h Wq, h Wk, h Wv (``num_key_value_heads`` K/V heads
of hidden / heads, each read by heads / kv query heads), no position
encoding, softmax(q kᵀ · attention_multiplier + causal mask) v, then Wo;
computed in blocks of queries so one sequence of 16 384 fits.  Mamba2:
``zamba2_lm.py``'s layer equations at one B / C group and a gated RMSNorm
over the whole inner width, dt = softplus(dt + dt_bias) unclamped (the
layer's ``time_step_limit`` is (0, inf)).  MoE, dropless: logits = n W_r
in fp32, the top ``num_experts_per_tok`` (larger first, ties to the lower
expert), gates = softmax over those logits; each expert e, over the rows
routed to it, (silu(n W_gate) · n W_up) W_down with [W_gate | W_up] =
``moe.w_in[e]``, and the rows' outputs weighted by their gates and summed
per token.  Shared: the same SwiGLU at ``shared_intermediate_size``.

Everything is fp32 with no departure from the equations; the program
computes in bf16 and the comparison's limit holds that.  The program
routes on fp32 products of its bf16 rows, the reference on its own fp32
rows, so near-ties choose other experts now and then, and at random
weights each such choice moves its token's later layers and routing
further: left alone, the two drift apart at every position within a few
layers (PERF.md §6).  So the reference can be handed the
program's choices (``follow``: each layer's (T, k) experts) and then
computes those experts, gated by the softmax over its own fp32 logits
of them; ``margins`` keeps, per layer and token, how far the best
expert left out lies above the worst one chosen, in units of the
token's logits' standard deviation (0 where the choice is the
reference's top k), so a routing fault still shows.  A token whose
handed choice is not k distinct experts of the E is counted in
``invalid`` (per layer) and computed with the reference's own top k, so
the layer's output shows the fault too.  ``routes`` keeps each layer's
own top k.  ``matmul_operand`` wraps both
operands of every product the program runs in bf16 (projections,
attention, experts, shared MLP, head; not the router or the scan, which
it runs in fp32): the fp8 control passes ``zamba2_lm.fp8_operand``.

Weights come through ``weight(name)``, by the names of
``portbench/granite_layout.py``, fetched as each layer runs.  No cache, no
batching beyond the given rows.  Imports neither JAX, nor ``repro``, nor
the port.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.zamba2_lm import ssd

ATTN_BLOCK = 1024          # queries a block of the reference's attention


def _identity(x):
    return x


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


class GraniteLM:
    """``cfg`` holds the published keys; ``weight(name)`` gives a leaf in
    fp32 (see the module docstring)."""

    def __init__(self, cfg: Dict, weight: Callable[[str], torch.Tensor],
                 matmul_operand: Optional[Callable] = None,
                 follow: Optional[List[torch.Tensor]] = None):
        self.cfg, self.w = cfg, weight
        self.op = matmul_operand or _identity
        self.follow = follow
        self.M = cfg["hidden_size"]
        self.eps = cfg["rms_norm_eps"]
        self.r = cfg["residual_multiplier"]
        self.routes: List[torch.Tensor] = []
        self.margins: List[torch.Tensor] = []
        self.invalid: List[int] = []

    def _mm(self, a, b):
        return torch.matmul(self.op(a), self.op(b))

    def _swiglu(self, x, w_in, w_out):
        g, u = self._mm(x, w_in).chunk(2, dim=-1)
        return self._mm(F.silu(g) * u, w_out)

    # -- the mixers ----------------------------------------------------
    def _attention(self, i, h):
        w = lambda n: self.w(f"layers.{i}.attn.{n}")          # noqa: E731
        c = self.cfg
        b, S, _ = h.shape
        H, KV = c["num_attention_heads"], c["num_key_value_heads"]
        D = self.M // H
        q = self._mm(h, w("w_q")).reshape(b, S, H, D).transpose(1, 2)
        k, v = (self._mm(h, w(n)).reshape(b, S, KV, D).transpose(1, 2)
                .repeat_interleave(H // KV, dim=1) for n in ("w_k", "w_v"))
        o = torch.empty_like(q)
        for q0 in range(0, S, ATTN_BLOCK):
            q1 = min(S, q0 + ATTN_BLOCK)
            s = self._mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) \
                * c["attention_multiplier"]
            mask = torch.ones(q1 - q0, q1, dtype=torch.bool,
                              device=h.device).triu(q0 + 1)
            p = torch.softmax(s.masked_fill(mask, -torch.inf), dim=-1)
            o[:, :, q0:q1] = self._mm(p, v[:, :, :q1])
        return self._mm(o.transpose(1, 2).reshape(b, S, H * D), w("w_o"))

    def _mamba(self, i, x):
        w = lambda n: self.w(f"layers.{i}.mamba.{n}")         # noqa: E731
        c = self.cfg
        b, S, _ = x.shape
        Din = c["mamba_expand"] * self.M
        H, P, N, G = c["mamba_n_heads"], c["mamba_d_head"], \
            c["mamba_d_state"], c["mamba_n_groups"]
        conv = Din + 2 * G * N
        z, xbc, dt = self._mm(x, w("w_in")).split([Din, conv, H], dim=-1)
        cw = w("conv_w")                                     # (K, conv)
        K = cw.shape[0]
        xbc = F.conv1d(xbc.transpose(1, 2), cw.t()[:, None, :], w("conv_b"),
                       padding=K - 1, groups=conv)[..., :S].transpose(1, 2)
        xs, Bm, Cm = F.silu(xbc).split([Din, G * N, G * N], dim=-1)
        Bh = Bm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
        Ch = Cm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
        dt = F.softplus(dt + w("dt_bias"))
        xs = xs.reshape(b, S, H, P)
        chunk = c["mamba_chunk_size"]
        pad = -S % chunk
        args = (xs, dt, Bh, Ch)
        if pad:
            args = tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in args)
        y = ssd(args[0], args[1], -torch.exp(w("A_log")), args[2], args[3],
                chunk)[:, :S]
        y = (y + xs * w("D")[:, None]).reshape(b, S, Din) * F.silu(z)
        hg = y.reshape(b, S, G, Din // G)
        hg = hg * torch.rsqrt(hg.pow(2).mean(-1, keepdim=True) + self.eps)
        return self._mm(hg.reshape(b, S, Din) * w("gate_norm"), w("w_out"))

    # -- the expert layer ----------------------------------------------
    def _moe(self, i, n):
        """MoE(n) + Shared(n) for rows n (T, M)."""
        w = lambda name: self.w(f"layers.{i}.{name}")         # noqa: E731
        k = self.cfg["num_experts_per_tok"]
        logits = n @ w("moe.router")
        ranked = torch.sort(logits, dim=-1, descending=True, stable=True)
        experts = ranked.indices[:, :k]
        self.routes.append(experts)
        if self.follow is not None:
            handed = self.follow[i].to(logits.device, torch.long)
            bad = ~valid_routes(handed, logits.shape[1])
            self.invalid.append(int(bad.sum()))
            experts = torch.where(bad[:, None], experts, handed)
        chosen = logits.gather(1, experts)
        left_out = logits.scatter(1, experts, -torch.inf).amax(-1)
        self.margins.append(((left_out - chosen.amin(-1))
                             / logits.std(-1)).clamp_min(0))
        gates = torch.softmax(chosen, dim=-1)
        w_in, w_out = w("moe.w_in"), w("moe.w_out")
        y = self._swiglu(n, w("shared.w_in"), w("shared.w_out"))
        for e in range(w_in.shape[0]):
            tok, slot = (experts == e).nonzero(as_tuple=True)
            if tok.numel():
                out = self._swiglu(n[tok], w_in[e], w_out[e])
                y.index_add_(0, tok, out * gates[tok, slot, None])
        return y

    # -- the model -----------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w("embed")[tokens] * self.cfg["embedding_multiplier"]

    def mixer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Mixer_i(RMSNorm(x)) for x (B, S, M): the branch, before r."""
        h = _rms(x, self.w(f"layers.{i}.input_norm"), self.eps)
        return self._mamba(i, h) if self.cfg["layer_types"][i] == "mamba" \
            else self._attention(i, h)

    def ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """x + r · (MoE_i(n) + Shared_i(n)), n = RMSNorm(x)."""
        n = _rms(x, self.w(f"layers.{i}.post_norm"), self.eps)
        return x + self.r * self._moe(i, n.reshape(-1, self.M)) \
            .reshape(x.shape)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = _rms(x, self.w("final_norm.scale"), self.eps)
        head = self.w("embed").t() if c["tie_word_embeddings"] \
            else self.w("head")
        return self._mm(x, head) / c["logits_scaling"]

    def forward(self, tokens: torch.Tensor,
                states: Optional[list] = None) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, vocab) fp32; ``routes`` gets each
        layer's (B·S, k) top experts, ``margins`` each layer's (B·S,)
        margins, and ``states``, when given, what the program's forward
        keeps there (``models/granite.py``): the stream after the
        embedding, then per layer the mixer's branch, the stream after
        the mixer and after the expert layer."""
        self.routes, self.margins, self.invalid = [], [], []
        x = self.embed(tokens)
        keep = states.append if states is not None else _identity
        keep(x)
        for i in range(self.cfg["num_hidden_layers"]):
            y = self.mixer(i, x)
            keep(y)
            x = x + self.r * y
            keep(x)
            x = self.ffn(i, x)
            keep(x)
        return self.logits(x)


def position_gaps(program: torch.Tensor,
                  reference: torch.Tensor) -> torch.Tensor:
    """At each position, RMS(program − reference) over the vocabulary as a
    share of the reference logits' RMS there (``zamba2_lm.logit_rms_gap``
    before its max): (…, S, V) → (…·S,)."""
    ref = reference.to(torch.float32)
    d = program.to(torch.float32) - ref
    return (d.pow(2).mean(-1) / ref.pow(2).mean(-1)).sqrt().flatten()


def route_share_differing(program: List[torch.Tensor],
                          reference: List[torch.Tensor]) -> float:
    """The share of (token, layer) top-k sets that differ between two
    lists of per-layer (T, k) choices."""
    differ = sum(int((torch.sort(a.long(), -1).values
                      != torch.sort(b.long(), -1).values).any(-1).sum())
                 for a, b in zip(program, reference))
    return differ / sum(a.shape[0] for a in program)


def valid_routes(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Per row of (T, k) ``experts``: whether it names k distinct experts
    of ``n_experts``."""
    ranked = torch.sort(experts, dim=-1).values
    return ((ranked >= 0) & (ranked < n_experts)).all(-1) \
        & (ranked[:, 1:] != ranked[:, :-1]).all(-1)
