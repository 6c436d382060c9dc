"""The readings that set the Granite prefill cell's limit of ``correct``,
on the card:

    python3 portbench/granite_control.py --seed <n> [<n> ...] \
        [--variant sound|fp8|<fault>] [--out control.jsonl]

One batch of the cell's traffic through the program as the cell runs it,
then, for each checked sequence, the cell's three readings against the
plain reference run step by step from the program's residual stream and
following its routing (``drivers/granite_prefill.compare``:
``logit_rms_gap``, the step gaps with every step's, ``route_margin``,
``bad_routes``) and the share of (token, layer) top-k sets the reference
would have chosen otherwise; for

* ``sound`` (the default): the program as it is;
* ``fp8``: the reference with every operand of the products the program
  runs in bf16 rounded to fp8 e4m3 (one scale per tensor), run alone in
  the program's place (the nearest precision below the configuration's);
* each fault of :data:`FAULTS`, planted in the program (its weights, its
  configuration or one of its functions) and the batch run again.

Prints one JSON object a seed (and appends them to ``--out``, a line
each).  One variant a process: a run's residual stream is ~11 GB of host
memory at the cell's size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "granite_4_0_h_small.prefill_16k"


def _softmax_all_experts(route):
    """Gates from the softmax over all E logits, not the k chosen."""
    import torch

    def planted(logits, n, k, use_pallas):
        r = route(logits, n, k, use_pallas)
        gates = torch.softmax(logits, dim=-1).gather(1, r.experts.long())
        return r._replace(gates=gates.contiguous())
    return planted


def _shifted_rows(route):
    """Each pair's row one further on (its neighbour's expert output)."""
    def planted(logits, n, k, use_pallas):
        r = route(logits, n, k, use_pallas)
        return r._replace(pos=(r.pos + 1) % r.xs.shape[0])
    return planted


def _duplicate_expert(route):
    """Each token's first expert twice and its last left out, gated by
    the softmax over the logits of the experts so named."""
    import torch
    from repro_torch.kernels import moe_route

    def planted(logits, n, k, use_pallas):
        experts = route(logits, n, k, use_pallas).experts.long()
        experts[:, -1] = experts[:, 0]
        gates = torch.softmax(logits.gather(1, experts), dim=-1)
        return moe_route.arrange(experts, gates.contiguous(), n,
                                 logits.shape[1])
    return planted


def _rope(qkv):
    """RoPE (θ 10 000, over the whole head) on q and k."""
    import torch
    from repro_torch.models.layers import apply_rope

    def planted(cfg, w, h):
        q, k, v = qkv(cfg, w, h)
        pos = torch.arange(h.shape[-2], device=h.device)
        return apply_rope(q, pos, 1e4), apply_rope(k, pos, 1e4), v
    return planted


def _no_shared_mlp(cfg, params):
    for p in params["layers"].values():
        p["shared"] = dict(p["shared"], w_out=p["shared"]["w_out"] * 0)
    return cfg


def _residual_one(cfg, params):
    return dataclasses.replace(cfg, residual_multiplier=1.0)


def _scale_sqrt_head(cfg, params):
    return dataclasses.replace(cfg, attention_multiplier=cfg.d_head ** -0.5)


# fault → ("config", f(cfg, params) → cfg) or ("function", name in
# models/granite.py, wrapper of it)
FAULTS = {
    "softmax_all_experts": ("function", "_route", _softmax_all_experts),
    "no_shared_mlp": ("config", _no_shared_mlp),
    "residual_multiplier_1": ("config", _residual_one),
    "scale_sqrt_head": ("config", _scale_sqrt_head),
    "rope": ("function", "_qkv", _rope),
    "shifted_rows": ("function", "_route", _shifted_rows),
    "duplicate_expert": ("function", "_route", _duplicate_expert),
}


@contextlib.contextmanager
def planted(fault, cfg, params):
    """Yields the configuration to run with ``fault`` planted in the
    program (``params``, its nested tree, or ``models/granite.py``);
    restored on exit."""
    from repro_torch.models import granite
    kind, *how = FAULTS[fault]
    layers = {i: dict(p) for i, p in params["layers"].items()}
    saved = None
    if kind == "function":
        name, wrap = how
        saved = getattr(granite, name)
        setattr(granite, name, wrap(saved))
        new = cfg
    else:
        new = how[0](cfg, params)
    try:
        yield new
    finally:
        if saved is not None:
            setattr(granite, how[0], saved)
        for i, leaves in layers.items():
            params["layers"][i].clear()
            params["layers"][i].update(leaves)


VARIANTS = ("sound", "fp8", *FAULTS)


def readings(seed: int, variant: str) -> dict:
    """The control's readings of one seed and one variant (see the module
    docstring)."""
    import torch
    from portbench import harness
    from portbench.drivers import granite_prefill as drv
    from portbench.drivers.prefill import batch_tokens, checked_rows
    from portbench.reference.zamba2_lm import fp8_operand

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == WORKLOAD)
    bdir = ROOT / "portbench"
    mix = harness.load_json(bdir / "traffic" / f"{entry['traffic']}.json")
    ctx = SimpleNamespace(
        root=ROOT, name=WORKLOAD, seed=seed, seconds=0.0,
        workload=harness.load_json(bdir / "workloads" / f"{WORKLOAD}.json"),
        config=harness.load_json(bdir / "configs"
                                 / f"{entry['config']}.json"),
        traffic=dict(mix["params"], warmup_prefills=0),
        device=torch.device("cuda", 0), stamps={}, notes={})
    t0 = time.perf_counter()
    t = ctx.traffic
    rows = checked_rows(seed, t["batch"], t["check_sequences"])
    tokens = batch_tokens(ctx.config["vocab_size"], t["batch"], t["seq"],
                          seed, 1, ctx.device)[rows]
    if variant == "fp8":    # the reference in fp8, in the program's place
        fp8 = drv.reference_model(ctx, fp8_operand)
        runs = []
        with torch.no_grad():
            for r in range(len(rows)):
                states = []
                lg = fp8.forward(tokens[r:r + 1], states)[0].cpu()
                runs.append(([x.to(torch.bfloat16).cpu() for x in states],
                             fp8.routes, lg))
                del states
        del fp8
    else:
        state = drv.setup(ctx)
        if variant == "sound":
            runs = drv.program_states(ctx, state, tokens)
        else:
            with planted(variant, state["mcfg"], state["params"]) \
                    as state["mcfg"]:
                runs = drv.program_states(ctx, state, tokens)
        state.clear()
    torch.cuda.empty_cache()
    out = {"seed": seed, "variant": variant, "rows": rows,
           "card": harness._card(), "checked": []}
    for r, (states, routes, logits) in enumerate(runs):
        out["checked"].append(drv.compare(ctx, states, routes, logits,
                                          tokens[r:r + 1]))
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--variant", choices=VARIANTS, default="sound")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for seed in args.seed:
        line = json.dumps(readings(seed, args.variant))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
