"""Training driver: Rudra's protocols as the port's round engines, on a
language model, through the port's trainer.

Every round runs inside ``repro_torch.train.loop.train``: the round step of
``repro_torch.core.distributed.make_train_step`` over
``repro_torch.models.model_loss``, fed by ``data/pipeline.make_batch_fn``'s
synthetic token batches through its ``PrefetchIterator``, with
``eval_every=1`` and an ``eval_fn`` that synchronises and stamps each
round's end, as a training run that logs its loss does.  Each call of
``train`` builds its step and starts its optimizer state from the weights
it is handed, and draws its batches from its ``RunConfig.seed``; the
benchmark gives the three calls of a run seeds of their own (3·seed,
3·seed + 1, 3·seed + 2), so that no two rounds share rows.

Set-up draws the benchmark's weights from the seed
(``portbench/inputs.py``), trains one round (its optimizer state is the
first gradients as the optimizer holds them) and then ``WARM_ROUNDS``
rounds of warm-up.  The window is one ``train`` call over a whole number
of rounds, sized from the warm-up's round time to fill ``--seconds``; the
rate counts every token of every round over the call's whole time.

The check reads the weights' change after the window, frees the program's
state and trains the plain fp32 reference (``reference/dense_lm.py``,
``reference/rounds.py``) from the same initial weights through every round
of the three calls, on the same rows (``reference/tokens.py`` draws them
again), then compares, each as a gap between the two sides:

* ``loss_gap``: every round's logged loss, set-up's and the window's, the
  widest relative gap;
* ``grad_gap``: the velocity after the first round, per leaf slice;
* ``change_gap``: the weights' change after the window's last round, per
  leaf slice.

A slice's gap is |‖program‖ − ‖reference‖| over the larger of the
reference's norm of the slice and of the median slice.  The three worst
slices of each number, with the reference's first gradient of each as a
share of the median slice's, go into the result's ``notes``, with the
slices that the reference moves and the program leaves as they were.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import inputs

WARM_ROUNDS = 2
FIRST, WARM, WINDOW = range(3)       # the trainer's calls in a run


def port_config(cfg):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.config import ModelConfig
    p = dict(cfg["port_model_config"])
    p["block_pattern"] = tuple(p["block_pattern"])
    return ModelConfig(**p)


def port_run(t, seed):
    from repro_torch.config import RunConfig
    return RunConfig(
        protocol=t["protocol"], n_softsync=t["n_softsync"],
        n_learners=t["n_learners"], minibatch=t["minibatch"],
        base_lr=t["base_lr"], optimizer=t["optimizer"],
        momentum=t["momentum"], lr_policy=t["lr_policy"], remat=t["remat"],
        attn_impl=t["attn_impl"], attn_q_chunk=t["attn_q_chunk"],
        attn_kv_chunk=t["attn_kv_chunk"], seed=seed)


def batch_seed(seed: int, call: int) -> int:
    """The ``RunConfig.seed`` of a run's ``call``-th trainer call."""
    return 3 * int(seed) + call


def _rows(t):
    return t["n_learners"] * t["minibatch"]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _change_norms(params, layout, seed, dev):
    """The program's weights less the initial ones, per leaf slice."""
    from portbench.reference.rounds import slice_norms
    flat = inputs.flatten(params)
    out = {}
    for name in list(flat):
        x = flat.pop(name)
        d = x.to(torch.float32) - inputs.draw_leaf(layout, name, seed, dev,
                                                  x.dtype).to(torch.float32)
        del x
        out.update(slice_norms({name: d}, inputs.is_stacked))
        del d
    return out


def _train(ctx, state, call, steps, stamps):
    """One call of the port's trainer over ``steps`` rounds from
    ``state["params"]``, which it takes; appends each round's end to
    ``stamps`` and its logged loss to ``state["losses"]``."""
    from repro_torch.train.loop import train
    t, dev = ctx.traffic, ctx.device

    def stamp(_params):
        _sync(dev)
        stamps.append(time.perf_counter())
        return {}

    res = train(state["mcfg"], port_run(t, batch_seed(ctx.seed, call)),
                steps=steps, batch=_rows(t), seq=t["seq"],
                engine=t["engine"], eval_every=1, eval_fn=stamp,
                params=state.pop("params"), device=dev)
    state["params"] = res.params
    state["losses"] += [e["loss"] for e in res.history]
    return res


def setup(ctx):
    from portbench.reference.rounds import slice_norms

    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    dtype = getattr(torch, cfg["torch_dtype"])
    layout = inputs.dense_layout(cfg)
    state = dict(mcfg=port_config(cfg), layout=layout, losses=[],
                 params=inputs.nest(inputs.draw_flat(layout, seed, dev,
                                                     dtype)))
    stamps = [time.perf_counter()]
    res = _train(ctx, state, FIRST, 1, stamps)
    key = next(iter(res.opt_state))
    state["first_grad"] = slice_norms(inputs.flatten(res.opt_state[key]),
                                      inputs.is_stacked)
    del res
    _train(ctx, state, WARM, WARM_ROUNDS, stamps)
    times = np.diff(stamps).tolist()
    round_s = statistics.median(times[1:])
    state["rounds"] = max(1, int(round(ctx.seconds / round_s)))
    ctx.notes.update(warmup_round_s=times, window_rounds=state["rounds"])
    gc.collect()
    return state


def window(ctx, state):
    t, n = ctx.traffic, state["rounds"]
    stamps = []
    t0 = time.perf_counter()
    _train(ctx, state, WINDOW, n, stamps)
    t1 = time.perf_counter()
    failed = sum(not np.isfinite(x) for x in state["losses"][-n:])
    tokens = n * _rows(t) * t["seq"]
    ctx.notes["window_round_s"] = np.diff([t0] + stamps).tolist()
    ctx.stamps.update(kind="train", rounds=n, batch=_rows(t), seq=t["seq"])
    return {"t0": t0, "t1": t1, "work": n, "failed": failed,
            "metrics": {"train_tokens_per_s": tokens / (t1 - t0)}}


def reference_batches(ctx, rounds, rows=None):
    """The rows of every round the program trained, by trainer call; a
    round's batch as ``rows(batch)`` gives it when given."""
    from portbench.reference.tokens import lm_batch
    t, dev = ctx.traffic, ctx.device
    vocab = ctx.config["vocab_size"]
    segments = []
    for call, steps in zip((FIRST, WARM, WINDOW), (1, WARM_ROUNDS, rounds)):
        seg = []
        for i in range(steps):
            b = lm_batch(vocab, _rows(t), t["seq"],
                         seed=batch_seed(ctx.seed, call), step=i)
            b = rows(b) if rows else b
            seg.append({k: torch.as_tensor(v, device=dev)
                        for k, v in b.items()})
        segments.append(seg)
    return segments


def reference_readings(ctx, rounds, matmul_operand=None, rows=None,
                       block_rows=None):
    """The reference's losses and readings over every round of a run whose
    window trained ``rounds`` rounds."""
    from portbench.reference.dense_lm import DenseLM
    from portbench.reference.rounds import run_rounds
    t, cfg, dev, seed = ctx.traffic, ctx.config, ctx.device, ctx.seed
    layout = inputs.dense_layout(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def initial(name):
        return inputs.draw_leaf(layout, name, seed, dev, dtype).to(
            torch.float32)

    model = DenseLM(cfg, matmul_operand=matmul_operand)
    n = 1 if t["protocol"] == "hardsync" else t["n_softsync"]
    return run_rounds(
        {leaf[0]: initial(leaf[0]) for leaf in layout},
        reference_batches(ctx, rounds, rows), model.loss_and_grad, initial,
        protocol=t["protocol"], n=n, lr_policy=t["lr_policy"],
        base_lr=t["base_lr"], momentum=t["momentum"],
        block_rows=block_rows or t["reference_block_rows"],
        stacked=inputs.is_stacked)


def _slice_gaps(prog, ref):
    """Each slice's gap, by name."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


def gaps(program, reference, worst=None):
    """The three compared numbers of one program (or control) run; the
    three slices that set each slice gap go into ``worst`` when given,
    each with its gap and the reference's first gradient as a share of
    the median slice's."""
    g_ref = reference["first_grad"]
    g_med = statistics.median(g_ref.values())
    slices = {"grad_gap": _slice_gaps(program["first_grad"], g_ref),
              "change_gap": _slice_gaps(program["change"],
                                        reference["change"])}
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                           zip(program["losses"], reference["losses"]))}
    for name, per in slices.items():
        top = sorted(per, key=per.get, reverse=True)[:3]
        out[name] = per[top[0]]
        if worst is not None:
            worst[name] = [[k, per[k], g_ref[k] / g_med] for k in top]
    return out


def check(ctx, state):
    dev = ctx.device
    state["change"] = _change_norms(state.pop("params"), state["layout"],
                                    ctx.seed, dev)
    program = {k: state[k] for k in ("losses", "first_grad", "change")}
    state.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, len(program["losses"]) - 1 - WARM_ROUNDS)
    worst = {}
    got = gaps(program, ref, worst)
    unmoved = sorted(k for k, v in ref["change"].items()
                     if v > 0 and program["change"][k] == 0)
    ctx.notes.update(worst_slices=worst, reference_s=time.perf_counter()
                     - t_ref, slices=len(ref["change"]),
                     unmoved_slices=[len(unmoved), unmoved[:8]])
    lim = ctx.workload["limits"]
    return {k: (v, lim[k]) for k, v in got.items()}
