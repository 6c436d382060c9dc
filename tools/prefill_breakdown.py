"""Where one prefill of the ``zamba2_7b.prefill`` cell spends the card's
time, by kernel class.

    python3 tools/prefill_breakdown.py [--seed N] [--prefills 2]

from the root of a checkout, on one H100 (~1.5 min with the weights
drawn): the cell's configuration
(``portbench/configs/zamba2_7b.json``) at its batch (8 × 4 096) through
``serve.engine.prefill_step`` with the kernels, one warm-up prefill, then
``--prefills`` prefills under ``torch.profiler``.  Prints one JSON line of
device seconds and launches per prefill by class (GEMMs, ``ssm_scan``'s
``ssd_*`` kernels, flash, the Mamba2 glue kernels, the RMSNorm kernel,
PyTorch's elementwise and reduction kernels, other), the device's busy
time and the span, then the 16 kernels that take longest.  It runs on any checkout with the
cell, so an older tree (``git archive`` into ``build/``) is read the same
way.
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def kernel_class(name: str) -> str:
    if "mamba_in_kernel" in name or "mamba_out_kernel" in name:
        return "mamba_glue"
    if "rms_norm_kernel" in name:
        return "norm"
    if "ssd_" in name:
        return "ssm_scan"
    if "flash_" in name:
        return "flash"
    if name.startswith("nvjet") or "gemm" in name.lower() \
            or "xmma" in name or "cutlass" in name:
        return "gemm"
    if "at::native" in name:
        return "torch_reduce" if "reduce_kernel" in name \
            else "torch_elementwise"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--prefills", type=int, default=2)
    args = ap.parse_args()
    import torch
    from portbench import hybrid_layout, inputs
    from portbench.devtrace import Trace
    from portbench.drivers.prefill import batch_tokens
    from repro_torch.config import RunConfig
    from repro_torch.serve.engine import prefill_step

    if not torch.cuda.is_available():
        print("prefill_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "portbench/configs/zamba2_7b.json").read_text())
    traffic = json.loads((ROOT / "portbench/traffic/prefill.json")
                         .read_text())["params"]
    mcfg = hybrid_layout.port_config(cfg)
    params = inputs.nest(hybrid_layout.draw_all(cfg, args.seed, dev,
                                                torch.bfloat16))
    run = RunConfig(attn_impl="pallas", use_pallas=True)

    def prefill(i):
        tokens = batch_tokens(cfg["vocab_size"], traffic["batch"],
                              traffic["seq"], args.seed, i, dev)
        return prefill_step(mcfg, run, params, {"tokens": tokens})

    prefill(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.prefills):
            prefill(1 + i)
        torch.cuda.synchronize()
    trace = Trace.from_profiler(prof)
    n = args.prefills
    secs, launches, by_name = (defaultdict(float), defaultdict(int),
                               defaultdict(float))
    for name, a, b in trace.device:
        secs[kernel_class(name)] += (b - a) * 1e-6 / n
        launches[kernel_class(name)] += 1
        by_name[name] += (b - a) * 1e-6 / n
    lo = min(a for _, a, _ in trace.device)
    hi = max(b for _, _, b in trace.device)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "per_prefill_s": dict(sorted(secs.items(), key=lambda x: -x[1])),
        "launches_per_prefill": {k: v / n for k, v in launches.items()},
        "device_busy_s": sum(secs.values()), "span_s": (hi - lo) * 1e-6 / n}))
    for name, s in sorted(by_name.items(), key=lambda x: -x[1])[:16]:
        print(f"  {s * 1e3:9.2f} ms  {name[:150]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
