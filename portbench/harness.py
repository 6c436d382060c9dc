"""One run of one cell: load what ``BENCHMARK.json`` names, set up, measure
the window, check the outputs against the reference, read the metrics and
build the result line.

Everything of one configuration, traffic mix or per-layer metric is a file
found by its name:

* ``portbench/configs/<config>.json``  the configuration as run;
* ``portbench/traffic/<traffic>.json`` the traffic mix: its driver and
  the driver's parameters;
* ``portbench/workloads/<cell>.json``  the limits of the numbers
  ``correct`` compares in the cell;
* ``portbench/drivers/<driver>.py``    ``setup(ctx)``, ``window(ctx,
  state)``, ``check(ctx, state)`` (see ``drivers/train.py``);
* ``portbench/metrics/<metric>.py``    ``read(run) -> float | None``, over
  the traced window (``run.trace``, a ``devtrace.Trace``) and the driver's
  stamps (``run.stamps``).

A driver's ``window`` returns ``{"t0", "t1", "work", "failed",
"metrics"}``: the host clock at the window's ends, the units of work it
did, how many of them failed, and its end-to-end metrics by name.
``check`` returns ``{name: (value, limit)}``; a run is correct when every
value is within its limit.  What a driver puts in ``ctx.notes`` (its
warm-up times, the window's size) goes into the result line as ``notes``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX package's or the JAX
    reference package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cell_metrics(bench: Dict, cell: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _card() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             bench: Optional[Dict] = None, bench_dir: Path = BENCH,
             config: Optional[Dict] = None) -> Dict:
    """Run one cell once; returns the result line's object.  ``bench`` is
    ``BENCHMARK.json``'s object (read from ``root`` when None), and the
    cell's files are found under ``bench_dir``; ``config`` stands in for
    the configuration's file when given."""
    import torch

    bench = bench or load_json(root / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    wl = load_json(bench_dir / "workloads" / f"{workload}.json")
    cfg = config or load_json(bench_dir / "configs"
                              / f"{entry['config']}.json")
    mix = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    driver = load_module(bench_dir / "drivers" / f"{mix['driver']}.py",
                         f"portbench_driver_{mix['driver']}")
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(device)
    ctx = SimpleNamespace(root=root, name=workload, workload=wl, config=cfg,
                          traffic=mix["params"], seed=int(seed),
                          seconds=float(seconds), device=dev, stamps={},
                          notes={})
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    state = driver.setup(ctx)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function("portbench.window"):
            out = driver.window(ctx, state)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    setup_s = out["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: JAX or the JAX package was loaded in "
                         f"the measured process: {', '.join(bad)}")

    tr = None
    if prof is not None:
        from portbench.devtrace import Trace
        tr = Trace.from_profiler(prof)
        del prof
    checks = driver.check(ctx, state)
    del state
    gc.collect()

    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": int(out["work"]), "failed": int(out["failed"])}
    metrics = {}
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = SimpleNamespace(trace=tr, stamps=ctx.stamps, config=cfg,
                              workload=wl, traffic=mix["params"])
        for m in cell_metrics(bench, workload, "per_layer"):
            reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(
                                     ".", "_"))
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None and tr.window is not None:
        busy = tr.busy_s()
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = tr.window_s()
        if tr.device:
            result["breakdown"] = {"device_ops": tr.top_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    if cuda:
        result["card"] = _card()
    result["notes"] = ctx.notes
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def emit(result: Dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard out."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

