"""Plain fp32 reference of Zamba2's forward, loss and gradients, written
from the published description: the model's ``config.json`` and the layer
equations of ``transformers``' ``modeling_zamba2.py`` (its kernel path).

Per layer i of ``num_hidden_layers``, with e the token embedding::

    at i in hybrid_layer_ids, block k = its index mod num_mem_blocks:
        h  = RMSNorm(concat(x, e))                      2·hidden wide
        q, k, v = h Wq, h Wk, h Wv   (heads of attention_head_dim, RoPE θ
                  over the whole head: rotate_half, cos / sin of the
                  frequencies repeated)
        o  = softmax(q kᵀ · (head / 2)^-½ + causal mask) v
        a  = RMSNorm(o Wo)
        g | u = a W_gate_up + (a A_down) A_up      (the layer's adapter)
        T  = (gelu_erf(g) · u) W_down
        x_in = x + T W_i                           (T is not in the residual)
    else x_in = x
    x = x + Mamba(RMSNorm(x_in))

Mamba: z | xBC | dt = x W_in; xBC = silu(depthwise causal conv(xBC) + b);
x | B | C = xBC with B, C in ``mamba_ngroups`` groups (head h reads group
h // (heads / groups)); dt = softplus(dt + dt_bias) with no clamp (the
published ``time_step_limit`` is null; ``mamba_chunk_scan_combined``
takes no limit then — HF's torch-only path clamps dt below at
``time_step_min``, which the published kernel path does not); the scan
S_t = exp(dt_t A) S_{t-1} + dt_t B_t ⊗ x_t, y_t = C_t · S_t + D x_t; then
RMSNorm over groups of d_inner / groups of y · silu(z), times its weight,
and W_out.  A final RMSNorm and the embedding's transpose (tied) give the
logits.

The scan is Mamba2's minimal chunked SSD (segment sums of the log decays,
masked to −inf before any exponential; states passed between chunks by
their decays), written here from the paper's algorithm: none of the
program's code.  Everything is fp32 with no departure from the equations;
the program computes in bf16 and the comparison's limit holds that.
``matmul_operand`` wraps both operands of every product the program runs
in bf16 (projections, attention, head; not the scan, which it runs in
fp32): the fp8 control passes :func:`fp8_operand`.

Weights come through ``weight(name)``, by the names of
``portbench/hybrid_layout.py`` (``layers.<i>.w_in``, ``shared.<k>.w_q``,
…), fetched as each layer runs: one sequence at the published widths
fits beside the program on one card.  No cache, no batching beyond the
given rows.  Imports neither JAX, nor ``repro``, nor the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def _identity(x):
    return x


def round_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """fp32 → fp8 e4m3 with one scale for the tensor (its largest |x| at
    e4m3's largest finite value, 448), kept in fp32: how an fp8 matrix unit
    is fed."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _FP8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    return _FP8Operand.apply(x)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(…, T) → (…, T, T): out[i, j] = x_{j+1} + … + x_i for j ≤ i, −inf
    above the diagonal (sums, not differences of cumulative sums)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, -torch.inf)


def ssd(x, dt, A, B, C, chunk):
    """Mamba2's chunked SSD from a zero state.  x (b, l, h, p), dt (b, l,
    h), A (h,), B / C (b, l, h, n); l a multiple of ``chunk``.  Returns
    y (b, l, h, p) without the D term."""
    b, l, h, p = x.shape
    c = l // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (A * dt).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # b h c l
    Bc = B.reshape(b, c, chunk, h, -1)
    Cc = C.reshape(b, c, chunk, h, -1)
    Acum = torch.cumsum(Ad, dim=-1)
    L = torch.exp(_segsum(Ad))                                  # b h c l s
    scores = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc)
    y = torch.einsum("bhcls,bcshp->bclhp", scores * L, X)
    decay = torch.exp(Acum[..., -1:] - Acum)                    # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(Acum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(Acum))
    return y.reshape(b, l, h, p)


class Zamba2LM:
    """``cfg`` holds the published keys; ``weight(name)`` gives a leaf in
    fp32 (see the module docstring)."""

    def __init__(self, cfg: Dict, weight: Callable[[str], torch.Tensor],
                 matmul_operand: Optional[Callable] = None):
        self.cfg, self.w = cfg, weight
        self.op = matmul_operand or _identity
        self.M = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Dh = cfg["attention_head_dim"]
        self.eps = cfg["rms_norm_eps"]
        self.hybrid = list(cfg["hybrid_layer_ids"])
        self.Din = cfg["mamba_expand"] * self.M
        self.mh = cfg["n_mamba_heads"]
        self.P = cfg["mamba_headdim"]
        self.N = cfg["mamba_d_state"]
        self.G = cfg["mamba_ngroups"]

    def _mm(self, a, b):
        return torch.matmul(self.op(a), self.op(b))

    # -- the shared transformer block ---------------------------------
    def _rope(self, S, device):
        D = self.Dh
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, D, 2, dtype=torch.float32, device=device) / D))
        freqs = torch.arange(S, dtype=torch.float32, device=device)[:, None] \
            * inv[None, :]
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos(), emb.sin()

    def _shared(self, k, i, x, e, rope):
        w = lambda n: self.w(f"shared.{k}.{n}")              # noqa: E731
        b, S, _ = x.shape
        h = _rms(torch.cat([x, e], dim=-1), w("input_norm"), self.eps)
        q, kk, v = (self._mm(h, w(n)).reshape(b, S, self.H, self.Dh)
                    .transpose(1, 2) for n in ("w_q", "w_k", "w_v"))
        cos, sin = rope
        q = q * cos + _rotate_half(q) * sin
        kk = kk * cos + _rotate_half(kk) * sin
        s = self._mm(q, kk.transpose(-1, -2)) * (self.Dh / 2) ** -0.5
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
        s = s.masked_fill(mask, -torch.inf)
        o = self._mm(torch.softmax(s, dim=-1), v)
        o = o.transpose(1, 2).reshape(b, S, self.H * self.Dh)
        a = _rms(self._mm(o, w("w_o")), w("pre_ff_norm"), self.eps)
        lw = lambda n: self.w(f"layers.{i}.{n}")              # noqa: E731
        gu = self._mm(a, w("w_gate_up")) + self._mm(
            self._mm(a, lw("adapter_down")), lw("adapter_up"))
        g, u = gu.chunk(2, dim=-1)
        return self._mm(F.gelu(g) * u, w("w_down"))

    # -- the Mamba2 layer ---------------------------------------------
    def _mamba(self, i, x):
        w = lambda n: self.w(f"layers.{i}.{n}")              # noqa: E731
        b, S, _ = x.shape
        Din, H, P, N, G = self.Din, self.mh, self.P, self.N, self.G
        conv = Din + 2 * G * N
        zxbcdt = self._mm(x, w("w_in"))
        z, xbc, dt = zxbcdt.split([Din, conv, H], dim=-1)
        cw = w("conv_w")                                     # (K, conv)
        K = cw.shape[0]
        xbc = F.conv1d(xbc.transpose(1, 2), cw.t()[:, None, :], w("conv_b"),
                       padding=K - 1, groups=conv)[..., :S].transpose(1, 2)
        xbc = F.silu(xbc)
        xs, Bm, Cm = xbc.split([Din, G * N, G * N], dim=-1)
        Bm, Cm = Bm.reshape(b, S, G, N), Cm.reshape(b, S, G, N)
        Bh = Bm.repeat_interleave(H // G, dim=2)
        Ch = Cm.repeat_interleave(H // G, dim=2)
        dt = F.softplus(dt + w("dt_bias"))
        A = -torch.exp(w("A_log"))
        xs = xs.reshape(b, S, H, P)
        chunk = self.cfg["chunk_size"]
        pad = -S % chunk
        args = (xs, dt, Bh, Ch)
        if pad:
            args = tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in args)
        y = ssd(args[0], args[1], A, args[2], args[3], chunk)[:, :S]
        y = y + xs * w("D")[:, None]
        h = y.reshape(b, S, Din) * F.silu(z)
        hg = h.reshape(b, S, G, Din // G)
        hg = hg * torch.rsqrt(hg.pow(2).mean(-1, keepdim=True) + self.eps)
        h = hg.reshape(b, S, Din) * w("gate_norm")
        return self._mm(h, w("w_out"))

    # -- the model ----------------------------------------------------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, vocab) fp32."""
        table = self.w("embed")
        e = table[tokens]
        x = e
        rope = self._rope(tokens.shape[1], e.device)
        for i in range(self.cfg["num_hidden_layers"]):
            xin = x
            if i in self.hybrid:
                k = self.hybrid.index(i) % self.cfg["num_mem_blocks"]
                xin = x + self._mm(self._shared(k, i, x, e, rope),
                                   self.w(f"layers.{i}.linear"))
            x = x + self._mamba(i, _rms(xin, self.w(f"layers.{i}.norm"),
                                        self.eps))
        x = _rms(x, self.w("final_norm.scale"), self.eps)
        head = table.t() if self.cfg["tie_word_embeddings"] \
            else self.w("head")
        return self._mm(x, head)

    def loss(self, tokens, labels, mask=None) -> torch.Tensor:
        """Mean token cross-entropy over ``mask`` (all tokens when None)."""
        logits = self.forward(tokens)
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels.long()[..., None])[..., 0]
        if mask is None:
            return nll.mean()
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def logit_rms_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest, over positions, of RMS(program − reference) over the
    vocabulary as a share of the reference logits' RMS at that position:
    how far the program's logits sit from the reference's in units of the
    logits' own size.  An error spread over every logit and a fault
    confined to a few positions both show; a single outlying logit does
    not set it."""
    ref = reference.to(torch.float32)
    d = program.to(torch.float32) - ref
    return float((d.pow(2).mean(-1) / ref.pow(2).mean(-1)).sqrt().max())
