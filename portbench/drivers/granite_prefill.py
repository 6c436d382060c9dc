"""Prefill driver of a published Granite 4.0-H: the port's serving prefill
at its full widths and depth.

Set-up builds the program's ``GraniteConfig`` (``granite_layout.
port_config``; a program without it fails here, before anything is drawn),
draws the configuration's weights from the seed on the card
(``portbench/granite_layout.py``) and runs ``warmup_prefills`` prefills,
each on a batch of its own.  The window is a closed loop of back-to-back
calls of ``repro_torch.serve.engine.prefill_step`` (the full-sequence
forward to fp32 logits), each on a new batch of ``batch`` × ``seq`` token
ids uniform over the vocabulary, drawn on the card from the seed and the
batch's index (``drivers/prefill.py``'s rule); each call ends when its
logits are on the card (the host waits, as a client waits for its
prefill), and the loop stops at the first end past ``--seconds``.  A
prefill fails when any of its logits is not finite (their sum is not).
``replay_events_per_s``, the benchmark's end-to-end rate, counts each
prefill call as one event: the window's prefills over its time on the
host clock.  ``notes`` gets ``prefill_tokens_per_s`` and each prefill's
time.

The check keeps the last prefill's logits of ``check_sequences`` of its
sequences, chosen by the seed (held in host memory), and runs the
program's forward once more on those sequences, keeping its residual
stream and each mixer's branch after each step and each layer's chosen
experts.  It frees the program's weights and runs the plain fp32
reference (``reference/granite_lm.py``, TF32 off), drawing each layer's
weights again as it goes, step by step from the program's own run and
computing the experts the program chose (``compare``).  At random
weights the whole forward amplifies bf16's rounding: by the 40th layer
the program's residual stream sits ~65 % of its size from an fp32
forward's, so the end-to-end logits of a sound program read 0.55-0.57
and most faults no more (PERF.md §6); each step alone keeps
bf16's rounding small and a fault large.  Seven numbers are compared
with the cell's limits: ``logit_rms_gap`` (the window's logits against
the reference's head on the program's last state, the largest over
positions of the RMS gap as a share of the reference's RMS), the largest
step error of each kind (``mixer_gap``, ``add_gap``, ``ffn_gap``:
``compare``'s), ``route_margin`` (the largest margin by which an expert
the program left out beats one it chose, in the reference's logits),
``bad_routes`` (the (token, layer) choices that are not k distinct
experts) and ``rerun_gap`` (the largest difference between the window's
logits and the second run's, 0 when the readings come from a run
bitwise the timed one).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import granite_layout, inputs
from portbench.drivers.prefill import _sync, batch_tokens, checked_rows


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
    mcfg = granite_layout.port_config(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])
    state = dict(mcfg=mcfg, index=0,
                 run=RunConfig(attn_impl=t["attn_impl"],
                               use_pallas=t["use_pallas"]),
                 params=inputs.nest(granite_layout.draw_all(
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
        # one sum, not an elementwise test: that would hold ~2 more copies
        # of the 6.6 GB logits; a sum is finite exactly when every logit is
        # (short of overflow, ~1e29 a logit)
        bad += (~torch.isfinite(logits[..., :V].sum())).to(torch.int64)
        _sync(dev)
        n += 1
        b = time.perf_counter()
        times.append(b - a)
        if b - t0 >= ctx.seconds:
            break
        del logits, tokens
    t1 = time.perf_counter()
    rows = checked_rows(ctx.seed, t["batch"], t["check_sequences"])
    # every row checked (the cell's one sequence): keep the logits, no copy
    # beside them on the card
    state["logits"] = logits[..., :V] if rows == list(range(t["batch"])) \
        else logits[rows, :, :V]
    state["tokens"] = tokens[rows]
    del logits, tokens
    ctx.notes.update(window_prefills=n, prefill_s=times, checked_rows=rows,
                     prefill_tokens_per_s=n * t["batch"] * t["seq"]
                     / (t1 - t0))
    ctx.stamps.update(kind="moe_prefill", prefills=n, batch=t["batch"],
                      seq=t["seq"])
    return {"t0": t0, "t1": t1, "work": n, "failed": int(bad),
            "metrics": {"replay_events_per_s": n / (t1 - t0)}}


def program_states(ctx, state, tokens):
    """The program's forward once more on each row of ``tokens``: per row,
    what it keeps of its run (``granite.forward``'s ``states``: bf16, host
    memory), each layer's chosen experts, and the logits (fp32, host
    memory)."""
    from repro_torch.models import granite
    V = ctx.config["vocab_size"]
    out = []
    with torch.inference_mode():
        for r in range(tokens.shape[0]):
            states = []
            lg, aux = granite.forward(state["mcfg"], state["run"],
                                      state["params"],
                                      {"tokens": tokens[r:r + 1]}, states)
            out.append((states, aux["experts"], lg[0, :, :V].cpu()))
            del lg
    return out


def reference_model(ctx, matmul_operand=None, follow=None):
    """The plain reference in fp32 with TF32 off, drawing each leaf from
    the run's seed as it goes (``follow``: the program's routing)."""
    from portbench.reference.granite_lm import GraniteLM
    cfg, dev = ctx.config, ctx.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    leaves = granite_layout.layout(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])

    def weight(name):
        return granite_layout.draw(cfg, leaves, name, ctx.seed, dev,
                                   dtype).to(torch.float32)

    return GraniteLM(cfg, weight, matmul_operand=matmul_operand,
                     follow=follow)


STEPS = ("mixer", "add", "ffn")
CHECKS = ("logit_rms_gap", "mixer_gap", "add_gap", "ffn_gap", "route_margin",
          "bad_routes", "rerun_gap")


def _rms(t) -> torch.Tensor:
    return t.pow(2).mean().sqrt()


def compare(ctx, states, routes, logits, tokens, matmul_operand=None):
    """:func:`compare_with` the cell's reference, following ``routes``."""
    return compare_with(reference_model(ctx, matmul_operand, routes),
                        ctx.config, states, logits, tokens, ctx.device)


def compare_with(model, cfg, states, logits, tokens, dev):
    """The reference ``model`` (a ``GraniteLM`` following the program's
    routing), step by step from the program's own run (``states``: the
    stream after the embedding, then per layer the mixer's branch, the
    stream after the mixer and after the expert layer); ``cfg`` holds the
    published keys.  Per layer three steps: ``mixer.<i>``, the branch
    against the reference's from the same input, as a share of the
    reference's branch; ``add.<i>``, the stream after the mixer against
    input + r · the program's branch, as a share of that stream;
    ``ffn.<i>``, the stream after the expert layer against the
    reference's expert layer from the same input, as a share of the
    reference's change to the stream.  Returns ``logit_rms_gap`` (the
    largest over positions of the position gaps of ``logits`` against the
    reference's head on the program's last state), ``mixer_gap``,
    ``add_gap`` and ``ffn_gap`` (the largest step of each kind) with each
    step's, ``route_margin`` (the largest), ``bad_routes`` (the (token,
    layer) choices that are not k distinct experts) and the share of
    top-k sets the reference would have chosen otherwise."""
    from portbench.reference.granite_lm import (position_gaps,
                                                route_share_differing)
    r = cfg["residual_multiplier"]
    steps = {}

    def at(j):
        return states[j].to(dev, torch.float32)
    with torch.no_grad():
        if not torch.equal(model.embed(tokens.to(dev))
                           .to(states[0].dtype).cpu(), states[0].cpu()):
            steps["mixer.embed"] = float("inf")
        for i in range(cfg["num_hidden_layers"]):
            x, y, mid = at(3 * i), at(3 * i + 1), at(3 * i + 2)
            want = model.mixer(i, x)
            steps[f"mixer.{i}"] = float(_rms(y - want) / _rms(want))
            steps[f"add.{i}"] = float(_rms(mid - (x + r * y)) / _rms(mid))
            del x, y, want
            out = at(3 * i + 3)
            want = model.ffn(i, mid)
            steps[f"ffn.{i}"] = float(_rms(out - want) / _rms(want - mid))
            del mid, out, want
        ref = model.logits(at(len(states) - 1))
        gaps = position_gaps(logits.to(dev), ref.reshape(logits.shape))
    worst = {f"{kind}_gap": max(v for k, v in steps.items()
                                if k.startswith(kind + "."))
             for kind in STEPS}
    return {"logit_rms_gap": float(gaps.max()), **worst, "steps": steps,
            "route_margin": float(max(m.max() for m in model.margins)),
            "bad_routes": sum(model.invalid),
            "route_sets_differing": route_share_differing(model.follow,
                                                          model.routes)}


def _largest_difference(a, b) -> float:
    """max |a − b|, 0 when the two are bitwise equal (NaN where either
    has a NaN)."""
    return 0.0 if torch.equal(a, b) else float((a - b).abs().max())


def check(ctx, state):
    prog, tokens = state.pop("logits").cpu(), state.pop("tokens")
    runs = program_states(ctx, state, tokens)
    state.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows = [dict(compare(ctx, states, routes, prog[r], tokens[r:r + 1]),
                 rerun_gap=_largest_difference(prog[r], lg))
            for r, (states, routes, lg) in enumerate(runs)]
    lim = ctx.workload["limits"]
    ctx.notes.update(
        checked=[{k: v for k, v in row.items() if k != "steps"}
                 for row in rows],
        worst_steps=[sorted(row["steps"].items(), key=lambda kv: -kv[1])[:4]
                     for row in rows],
        reference_s=time.perf_counter() - t_ref)
    return {k: (max(row[k] for row in rows), lim[k]) for k in CHECKS}
