"""Plain fp32 reference of a dense decoder's loss and gradient (Qwen2's
layer equations), written from the published description.

A pre-norm decoder: token embedding; per layer RMSNorm → grouped-query
attention with QKV bias and rotary positions (half-split rotation, inverse
frequencies 1/θ^(2i/Dh) in fp32) → residual → RMSNorm → SwiGLU MLP →
residual; a final RMSNorm and the output head (the embedding's transpose
when tied); mean token cross-entropy over the loss mask.

One departure from a plain fp32 model, taken from the measured program's
stated numerics so that the comparison judges the rest: the attention's
P·V product takes its unnormalised probabilities and its values rounded to
bf16 (with fp32 accumulation) and divides by the fp32 row sum afterwards.
Rounding passes gradients straight through, as a dtype cast does.

``matmul_operand`` wraps both operands of every matrix product; the TF32
control passes ``lowprec.tf32_operand``.  Layers are checkpointed, which
recomputes the same operations and changes no value.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _identity(x):
    return x


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


class DenseLM:
    """``cfg`` holds the published keys (``hidden_size``,
    ``num_attention_heads``, …); ``weights`` maps the names of
    ``portbench/inputs.py``'s dense layout to fp32 tensors."""

    def __init__(self, cfg: Dict, matmul_operand: Optional[Callable] = None):
        self.cfg = cfg
        self.M = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KV = cfg["num_key_value_heads"]
        self.Dh = self.M // self.H
        self.L = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.tied = cfg["tie_word_embeddings"]
        self.op = matmul_operand or _identity

    def _mm(self, a, b):
        return torch.matmul(self.op(a), self.op(b))

    def _layer(self, x, w, cos, sin):
        B, S, M = x.shape
        H, KV, Dh = self.H, self.KV, self.Dh
        G = H // KV
        h = _rms(x, w["norm1"], self.eps)
        q = self._mm(h, w["w_q"].reshape(M, H * Dh)).view(B, S, H, Dh) \
            + w["b_q"]
        k = self._mm(h, w["w_k"].reshape(M, KV * Dh)).view(B, S, KV, Dh) \
            + w["b_k"]
        v = self._mm(h, w["w_v"].reshape(M, KV * Dh)).view(B, S, KV, Dh) \
            + w["b_v"]
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        qg = q.view(B, S, KV, G, Dh).permute(0, 2, 3, 1, 4)   # b k g q d
        kt = k.permute(0, 2, 3, 1)[:, :, None]                # b k 1 d s
        s = self._mm(qg, kt) * (1.0 / math.sqrt(Dh))          # b k g q s
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = torch.where(causal, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        vv = v.permute(0, 2, 1, 3)[:, :, None]                # b k 1 s d
        o = self._mm(_bf16(p), _bf16(vv)) / p.sum(dim=-1, keepdim=True)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * Dh)
        x = x + self._mm(o, w["w_o"].reshape(H * Dh, M))
        h = _rms(x, w["norm2"], self.eps)
        a = torch.nn.functional.silu(self._mm(h, w["w_gate"])) \
            * self._mm(h, w["w_up"])
        return x + self._mm(a, w["w_down"])

    def loss(self, wt: Dict[str, torch.Tensor], tokens, labels, mask):
        """Mean cross-entropy of one batch (B, S) of token ids."""
        S = tokens.shape[1]
        dev = tokens.device
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            np.arange(0, self.Dh, 2, dtype=np.float32) / self.Dh))
        ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] \
            * torch.from_numpy(np.asarray(inv, np.float32)).to(dev)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x = wt["embed"][tokens.long()]
        names = ("norm1", "w_q", "w_k", "w_v", "b_q", "b_k", "b_v", "w_o",
                 "norm2", "w_gate", "w_up", "w_down")
        per = {n: wt[_UNIT[n]].unbind(0) for n in names}
        for layer in range(self.L):
            w = {n: per[n][layer] for n in names}
            x = checkpoint(self._layer, x, w, cos, sin, use_reentrant=False)
        x = _rms(x, wt["final_norm.scale"], self.eps)
        head = wt["embed"].t() if self.tied else wt["head"]
        logits = self._mm(x, head)
        nll = torch.logsumexp(logits, dim=-1) \
            - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)

    def loss_and_grad(self, wt: Dict[str, torch.Tensor], batch):
        """(loss, {name: gradient}) at the fp32 weights ``wt``."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in wt.items()}
        loss = self.loss(leaves, batch["tokens"], batch["labels"],
                         batch["loss_mask"].to(torch.float32))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))


_UNIT = {"norm1": "units.block_0.norm1.scale",
         "norm2": "units.block_0.norm2.scale",
         **{n: f"units.block_0.attn.{n}"
            for n in ("w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v")},
         **{n: f"units.block_0.mlp.{n}"
            for n in ("w_gate", "w_up", "w_down")}}
