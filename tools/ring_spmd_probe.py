#!/usr/bin/env python3
"""The measurements behind the ``ring`` cell's cap and the seventh perf
floor, on one NVIDIA card.

    python3 tools/ring_spmd_probe.py

Builds the kernels, then prints:

* the ``ring`` cell's two children uncapped (``compute(cap_bytes=0)``):
  each lane's peak device memory (``torch.cuda.max_memory_allocated``),
  the basis of the cell's 6 GiB cap and of its ``h100_*`` bytes/param,
  and the same under the cap;
* ``chip_smoke.py``'s phase 13b (SPMD replay against the single
  placement at S = 1, 2, 4, then once through ``driver.run``);
* the ``distributed`` cell's ``measure`` at its defaults and at
  ``bench_guard``'s size (D 1 M, shards 1 and 4): ``spmd_s4`` there is
  ``distributed_replay_updates_per_s``, the floor's measurement.

Exits nonzero without a card.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ring_spmd_probe.py: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.experiments.cells import distributed_replay as dr
    from repro_torch.experiments.cells import ring_feasibility as rf
    from repro_torch.kernels import build

    t = time.time()
    build.build_all()
    print("build", round(time.time() - t, 1), flush=True)
    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    for cap in (0, rf._CAP_BYTES):
        t = time.time()
        _, d = rf.compute(cap_bytes=cap, device="cuda")
        print("ring cap", cap, round(time.time() - t, 1),
              json.dumps(d["rlimit_demo"]), flush=True)
    launches = {"ring_apply": 0, "ring_apply_whatif": 0, "ps_apply": 0}
    t = time.time()
    cs.phase_spmd(torch.device("cuda"), launches)
    print("spmd", round(time.time() - t, 1), launches, flush=True)
    for kw in ({}, dict(updates=32, d=1_000_000, repeats=2, shards=(1, 4))):
        t = time.time()
        print("distributed", json.dumps(dr.measure(device="cuda", **kw)),
              round(time.time() - t, 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
