"""Training launcher (counterpart of ``repro/launch/train.py``).

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --protocol softsync --n 4 --engine fused --steps 2 --batch 8 \
        --seq 1024 --ckpt /tmp/run1

On the CPU, at a reduced same-family config:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --device cpu --steps 20 --batch 8 --seq 64

The reference's flags, plus ``--device``.  Before training, a softsync or
async run reports its expected staleness from a 200-update schedule
through ``repro_torch.experiments.run`` (an ``ExperimentSpec`` without a
problem: the host-side schedule pass in measure mode, as in the
reference, so no kernel runs for it).  The checkpoint is the parameter
tree in the reference's npz layout (``checkpoint/io.py``) plus
``history.json``.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.config import RunConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--protocol", default="softsync",
                    choices=["hardsync", "softsync", "async"])
    ap.add_argument("--n", type=int, default=4, dest="n_softsync")
    ap.add_argument("--learners", type=int, default=8)
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "fused"])
    ap.add_argument("--lr-policy", default="staleness_inverse",
                    choices=["const", "staleness_inverse", "sqrt_scale",
                             "per_gradient"])
    ap.add_argument("--optimizer", default="momentum",
                    choices=["sgd", "momentum", "adagrad", "adamw"])
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(
        protocol=args.protocol, n_softsync=args.n_softsync,
        n_learners=args.learners,
        minibatch=max(1, args.batch // args.learners),
        base_lr=args.lr, lr_policy=args.lr_policy,
        optimizer=args.optimizer, num_microbatches=args.microbatches,
        seed=args.seed, attn_q_chunk=min(1024, args.seq),
        attn_kv_chunk=min(1024, args.seq))

    # report expected staleness for the chosen protocol (clock machinery)
    if run.protocol != "hardsync":
        from repro_torch.experiments import ExperimentSpec
        from repro_torch.experiments import run as run_experiment
        meas = run_experiment(ExperimentSpec(run=run, steps=200),
                              device=args.device)
        print(f"protocol={run.protocol} n={run.n_softsync} "
              f"c={run.gradients_per_update} "
              f"expected<sigma>={meas.staleness['mean']:.2f} "
              f"lr={run.learning_rate():.5f}", flush=True)

    res = train(cfg, run, steps=args.steps, batch=args.batch, seq=args.seq,
                engine=args.engine, eval_every=args.eval_every, log=print,
                device=args.device)
    print(f"done: {args.steps} rounds in {res.wallclock:.1f}s "
          f"({res.wallclock / args.steps * 1e3:.0f} ms/round)", flush=True)
    if args.ckpt:
        path = os.path.join(args.ckpt, "checkpoint.npz")
        save_checkpoint(path, res.params, step=args.steps)
        with open(os.path.join(args.ckpt, "history.json"), "w") as f:
            json.dump(res.history, f, indent=1)
        print(f"checkpoint -> {path}", flush=True)


if __name__ == "__main__":
    main()
