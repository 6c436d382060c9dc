"""The readings that set the prefill cell's limit of ``correct``, on the
card:

    python3 portbench/prefill_control.py --workload zamba2_7b.prefill \
        --seed <n> [<n> ...] [--out chiprun_out/prefill_control.jsonl]

One batch of the cell's traffic through the program as the cell runs it,
then ``logit_rms_gap`` (``drivers/prefill.py``) of each checked sequence
for

* ``sound``: the program as it is, against the plain reference;
* ``fp8``: the reference with every operand of the products the program
  runs in bf16 rounded to fp8 e4m3 (one scale per tensor), in the
  program's place: the nearest precision below the configuration's;
* each fault of :data:`FAULTS`, planted in the program's weights (or,
  for T in the residual, in a copy of its layer function) and the batch
  run again: q·k scaled by (head)^-½ (W_q × 2^-½), the adapters dropped
  (A_up zero), one B / C group for every head (group 0's columns copied
  over the others'), block 0 at every hybrid layer (block 1's leaves
  replaced by block 0's), T added into the residual.

Prints one JSON object a seed (and writes them to ``--out``, a line
each).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def _scale_sqrt_head(cfg, params):
    for w in params["shared"].values():
        w["w_q"] = (w["w_q"] * 2 ** -0.5).to(w["w_q"].dtype)


def _no_adapters(cfg, params):
    for i in cfg.hybrid_layer_ids:
        p = params["layers"][str(i)]
        p["adapter_up"] = p["adapter_up"] * 0


def _one_bc_group(cfg, params):
    """Group 0's B and C columns over every other group's, in the input
    projection and the convolution (columns [z | x | B | C | dt] and
    [x | B | C])."""
    Din, G, N = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    for p in params["layers"].values():
        for leaf, first in (("w_in", 2 * Din), ("conv_w", Din),
                            ("conv_b", Din)):
            t = p[leaf].clone()
            for part in (first, first + G * N):
                t[..., part + N:part + G * N] = \
                    t[..., part:part + N].repeat(*(1,) * (t.dim() - 1),
                                                 G - 1)
            p[leaf] = t


def _block0_everywhere(cfg, params):
    for k in params["shared"]:
        params["shared"][k] = params["shared"]["0"]


def _layer_t_in_residual(cfg, run, params, i, x, e, positions):
    """``hybrid._layer`` with T added into the residual as well as into the
    Mamba layer's input."""
    import torch
    from repro_torch.models import hybrid
    from repro_torch.models.layers import rms_norm
    p = params["layers"][str(i)]
    if i in cfg.hybrid_layer_ids:
        w = params["shared"][str(cfg.shared_block_of(i))]
        x = x + torch.matmul(hybrid.shared_block_forward(
            cfg, run, w, p, x, e, positions), p["linear"])
    return x + hybrid.mamba_forward(cfg, p, rms_norm(x, p["norm"],
                                                     cfg.norm_eps),
                                    use_pallas=run.use_pallas)


# fault → what it does to the program's weights (None: to its layer)
FAULTS = {
    "scale_sqrt_head": _scale_sqrt_head,
    "no_adapters": _no_adapters,
    "one_bc_group": _one_bc_group,
    "block0_everywhere": _block0_everywhere,
    "t_in_residual": None,
}


@contextlib.contextmanager
def planted(fault, cfg, params):
    """``params`` (the program's nested tree) with ``fault`` planted;
    restored on exit."""
    from repro_torch.models import hybrid
    layers = {i: dict(p) for i, p in params["layers"].items()}
    shared = {k: (w, dict(w)) for k, w in params["shared"].items()}
    layer = hybrid._layer
    if FAULTS[fault] is None:
        hybrid._layer = _layer_t_in_residual
    else:
        FAULTS[fault](cfg, params)
    try:
        yield params
    finally:
        hybrid._layer = layer
        for i, leaves in layers.items():
            params["layers"][i].clear()
            params["layers"][i].update(leaves)
        for k, (w, leaves) in shared.items():
            w.clear()
            w.update(leaves)
            params["shared"][k] = w


def readings(workload: str, seed: int) -> dict:
    """The control's readings of one seed (see the module docstring)."""
    import torch
    from portbench import harness
    from portbench.drivers import prefill as drv
    from portbench.reference.zamba2_lm import fp8_operand
    from portbench.reference.zamba2_lm import logit_rms_gap as gap

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    bdir = ROOT / "portbench"
    mix = harness.load_json(bdir / "traffic" / f"{entry['traffic']}.json")
    ctx = SimpleNamespace(
        root=ROOT, name=workload, seed=seed, seconds=0.0,
        workload=harness.load_json(bdir / "workloads" / f"{workload}.json"),
        config=harness.load_json(bdir / "configs"
                                 / f"{entry['config']}.json"),
        traffic=dict(mix["params"], warmup_prefills=1),
        device=torch.device("cuda", 0), stamps={}, notes={})
    t0 = time.perf_counter()
    state = drv.setup(ctx)
    V = ctx.config["vocab_size"]
    rows = drv.checked_rows(seed, ctx.traffic["batch"],
                            ctx.traffic["check_sequences"])

    def program_rows():
        state["index"] = 1
        logits, tokens = drv._prefill(ctx, state)
        return logits[rows, :, :V].clone(), tokens[rows].clone()

    sound, tokens = program_rows()
    faulty = {}
    for fault in FAULTS:
        with planted(fault, state["mcfg"], state["params"]):
            faulty[fault] = program_rows()[0]
    state.clear()
    torch.cuda.empty_cache()
    refs = list(drv.reference_logits(ctx, tokens))
    out = {"seed": seed, "rows": rows, "card": harness._card(),
           "sound": [gap(sound[r], ref) for r, ref in enumerate(refs)],
           "fp8": [gap(c, ref) for c, ref in zip(
               drv.reference_logits(ctx, tokens, fp8_operand), refs)]}
    for fault, lg in faulty.items():
        out[fault] = [gap(lg[r], ref) for r, ref in enumerate(refs)]
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="zamba2_7b.prefill")
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    lines = []
    for seed in args.seed:
        lines.append(json.dumps(readings(args.workload, seed)))
        print(lines[-1], flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
