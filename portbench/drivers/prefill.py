"""Prefill driver: the port's serving prefill of a published Zamba2 at its
full widths and depth.

Set-up draws the configuration's weights from the seed on the card
(``portbench/hybrid_layout.py``), builds the program's ``HybridConfig``
and runs ``warmup_prefills`` prefills, each on a batch of its own.  The
window is a closed loop of back-to-back calls of
``repro_torch.serve.engine.prefill_step`` (the full-sequence forward to
fp32 logits, one ``flash_attention`` launch per hybrid layer and one
``ssm_scan`` per layer), each on a new batch of ``batch`` × ``seq`` token
ids uniform over the vocabulary, drawn on the card from the seed and the
batch's index; each call ends when its logits are on the card (the host
waits, as a client waits for its prefill), and the loop stops at the
first end past ``--seconds``.  A prefill fails when any of its logits is
not finite.  ``replay_events_per_s``, the benchmark's end-to-end rate,
counts each prefill call (``batch`` × ``seq`` tokens) as one event: the
window's prefills over its time on the host clock, from the first call
to the end of the last.  ``notes`` gets the same window's
``prefill_tokens_per_s`` and each prefill's time.

The check keeps the last prefill's logits of ``check_sequences`` of its
sequences, chosen by the seed, frees the program's weights and runs the
plain fp32 reference (``reference/zamba2_lm.py``, TF32 off) on those
sequences one at a time, drawing each layer's weights again as it goes.
``logit_rms_gap``: at each position, RMS(program − reference) over the
vocabulary as a share of the reference logits' RMS there; the largest
over the positions of the sequences is compared with the cell's limit.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from portbench import hybrid_layout, inputs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def batch_tokens(vocab: int, batch: int, seq: int, seed: int, index: int,
                 device) -> torch.Tensor:
    """The ``index``-th batch of a run: (batch, seq) ids uniform over
    ``vocab``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7_919 + 104_729 * (index + 1)) % (1 << 63))
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)


def checked_rows(seed: int, batch: int, n: int):
    return sorted(random.Random(int(seed)).sample(range(batch), n))


def _prefill(ctx, state):
    """One prefill on the run's next batch; returns (logits, tokens)."""
    from repro_torch.serve.engine import prefill_step
    t, cfg = ctx.traffic, ctx.config
    tokens = batch_tokens(cfg["vocab_size"], t["batch"], t["seq"], ctx.seed,
                          state["index"], ctx.device)
    state["index"] += 1
    logits = prefill_step(state["mcfg"], state["run"], state["params"],
                          {"tokens": tokens})
    return logits, tokens


def setup(ctx):
    from repro_torch.config import RunConfig
    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    mcfg = hybrid_layout.port_config(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])
    state = dict(mcfg=mcfg, index=0,
                 run=RunConfig(attn_impl=t["attn_impl"],
                               use_pallas=t["use_pallas"]),
                 params=inputs.nest(hybrid_layout.draw_all(
                     cfg, ctx.seed, dev, dtype)))
    times = []
    for _ in range(t["warmup_prefills"]):
        t0 = time.perf_counter()
        logits, _ = _prefill(ctx, state)
        del logits
        _sync(dev)
        times.append(time.perf_counter() - t0)
    ctx.notes["warmup_prefill_s"] = times
    gc.collect()
    return state


def window(ctx, state):
    t, dev = ctx.traffic, ctx.device
    V = ctx.config["vocab_size"]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    times, n = [], 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        logits, tokens = _prefill(ctx, state)
        bad += (~torch.isfinite(logits[..., :V]).all()).to(torch.int64)
        _sync(dev)
        n += 1
        b = time.perf_counter()
        times.append(b - a)
        if b - t0 >= ctx.seconds:
            break
        del logits, tokens
    t1 = time.perf_counter()
    rows = checked_rows(ctx.seed, t["batch"], t["check_sequences"])
    state["logits"] = logits[rows, :, :V].clone()
    state["tokens"] = tokens[rows].clone()
    del logits, tokens
    ctx.notes.update(window_prefills=n, prefill_s=times, checked_rows=rows,
                     prefill_tokens_per_s=n * t["batch"] * t["seq"]
                     / (t1 - t0))
    ctx.stamps.update(kind="prefill", prefills=n, batch=t["batch"],
                      seq=t["seq"])
    return {"t0": t0, "t1": t1, "work": n, "failed": int(bad),
            "metrics": {"replay_events_per_s": n / (t1 - t0)}}


def reference_logits(ctx, tokens, matmul_operand=None):
    """The plain reference's logits of each row of ``tokens``, one at a
    time, in fp32 with TF32 off."""
    from portbench.reference.zamba2_lm import Zamba2LM
    cfg, dev = ctx.config, ctx.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    leaves = hybrid_layout.layout(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])

    def weight(name):
        return hybrid_layout.draw(cfg, leaves, name, ctx.seed, dev,
                                  dtype).to(torch.float32)

    model = Zamba2LM(cfg, weight, matmul_operand=matmul_operand)
    with torch.no_grad():
        for r in range(tokens.shape[0]):
            yield model.forward(tokens[r:r + 1])[0]


def check(ctx, state):
    from portbench.reference.zamba2_lm import logit_rms_gap
    prog, tokens = state.pop("logits"), state.pop("tokens")
    state.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = [logit_rms_gap(prog[r], ref)
            for r, ref in enumerate(reference_logits(ctx, tokens))]
    ctx.notes.update(logit_rms_gap_per_sequence=gaps,
                     reference_s=time.perf_counter() - t_ref)
    return {"logit_rms_gap": (max(gaps),
                              ctx.workload["limits"]["logit_rms_gap"])}
