"""Smoke test of the port's experiment surface: one tiny sweep through it
(counterpart of ``repro/experiments/smoke.py``).

    PYTHONPATH=src python -m repro_torch.experiments.smoke            # card
    PYTHONPATH=src python -m repro_torch.experiments.smoke --device cpu

2 protocol cases × 2 seeds on the MLP teacher problem, batched where
shape-compatible, then held against sequential execution and the record
schema.  Exits non-zero on any mismatch — the gate that the declarative
surface, the batched replay and the RunResult schema still agree.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.experiments import (ExperimentSpec, RunResult, Sweep,
                                     run_sweep, validate_record)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments.smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    t0 = time.time()
    base = ExperimentSpec(
        run=RunConfig(n_learners=8, minibatch=8, base_lr=0.2,
                      optimizer="momentum", seed=0),
        problem="mlp_teacher", steps=60, eval_every=30)
    sweep = Sweep.over(base, cases=[
        {"protocol": "softsync", "n_softsync": 2,
         "lr_policy": "staleness_inverse"},
        {"protocol": "async", "lr_policy": "per_gradient"},
    ], seed=[0, 1])
    batched = run_sweep(sweep, device=args.device)      # 2 configs × 2 seeds
    sequential = run_sweep(sweep, batch=False, device=args.device)
    assert len(batched) == len(sequential) == 4
    for b, s in zip(batched, sequential):
        validate_record(b.record())
        assert b.runtime["replay_path"] == "batched"
        assert s.runtime["replay_path"] == "sequential"
        np.testing.assert_allclose(b.metrics["test_error"],
                                   s.metrics["test_error"], atol=1e-6)
        assert b.record() == RunResult.from_json(b.to_json()).record()
        err = b.metrics["test_error"]
        assert np.isfinite(err) and 0.0 <= err <= 1.0
        print(f"[smoke] {b.tag}: test_error={err:.4f} "
              f"<sigma>={b.staleness['mean']:.2f} "
              f"time={b.runtime['simulated_time']:.1f}s")
    print(f"[smoke] ok: 4 runs on {args.device} (batched ≡ sequential, "
          f"records valid) in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
