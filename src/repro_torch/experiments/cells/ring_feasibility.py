"""Cell ``ring`` of the port (counterpart of
``repro/experiments/cells/ring_feasibility.py``) — max feasible model size
for trace-driven replay: stock path vs the what-if ring (DESIGN.md §12).

Part 1 — analytic, the reference's arithmetic as written: bytes/param of
the replay working set over every registered architecture's
``param_count`` under a 64 GiB budget.  Replaying a trace against a *real*
model backward materializes the (c, D) pulled-weight and (c, D) per-slot
gradient matrices every event on top of a double-buffered (K, D) ring:

    stock   ~ (2·K + 2·c) · 4          bytes/param

The what-if path carries only the ring (+ optimizer state, + the bf16
error-feedback residue — ``roofline.ring_bytes``) and streams the
closed-form gradients in O(D):

    what-if ~ ring_bytes/param + ~16   bytes/param

Part 2 — empirical: two child processes replay the same trace shape
(softsync n=1, λ=128, μ=1, sgd, 8 updates, seed 5) on ``device`` under one
memory cap.  The reference caps host address space (``RLIMIT_AS``, 2.5
GiB); on the card that would measure nothing (a CUDA context alone
reserves more address space), so the cap bounds device memory: each child
calls ``torch.cuda.set_per_process_memory_fraction(cap / total memory)``
before its first allocation and reports ``torch.cuda.max_memory_allocated``
as ``peak_bytes=``.  The stock path with a real MLP backward at D₀ ≈ 10 M
must die under the cap; the what-if kernel on the bf16 error-feedback ring
at 10·D₀ must fit.  ``torch.OutOfMemoryError`` or any other nonzero exit
counts as infeasible, reported with the child's last stderr line.

The cap, 6 GiB, sits between the two lanes' uncapped peaks on an NVIDIA
H100 80GB HBM3 (``MEASURED_BYTES_PER_PARAM``'s ``h100_*`` keys, from
``compute(cap_bytes=0)``): 14.45 GiB for the stock lane, 2.61 GiB for the
what-if lane — 2.3× the what-if peak, 0.42× the stock one, margin on both
sides for the allocator's rounding (the cap bounds only the caching
allocator).  ``skip_quick``: the children take seconds each, side by side.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from repro_torch.experiments.registry import (Cell, derived_claims, emit,
                                              register_cell, repo_root)

# the empirical cell: 1-softsync lam=128 (c = 128), 8 updates, sgd.
# D0: MLP hidden=232558 -> D = 43*232558 + 10 = 10_000_004 ~ 10M params.
# The what-if lane replays the reference's 10*D0 constant (its TPU tile
# multiple) on the bf16 error-feedback ring.
_CAP_BYTES = 6 << 30            # device-memory cap of each child
_D0 = 10_000_004
_HIDDEN0 = 232_558              # the real-backward lane sized to D0
_D_WHATIF = 100_007_936
_LAM = 128
_STEPS = 8
_CHILD_TIMEOUT = 600

# peak-memory calibration points: the reference's (peak RSS on its dev
# box, CPU XLA) and the card's (torch.cuda.max_memory_allocated over D,
# ``compute(cap_bytes=0)`` and ``compute()`` on an NVIDIA H100 80GB HBM3
# at 700.00 W: 15 514 959 872 bytes at D₀ = 10 000 004 and 2 803 902 976
# at 10·D₀ = 100 007 936, the same capped); softsync n=1 lam=128, 8 updates
MEASURED_BYTES_PER_PARAM = {
    "stock_mlp_backward_d4m_uncapped": 987.0,
    "whatif_fp32_sgd_d40m_uncapped": 32.7,
    "whatif_bf16_sgd_d100m_capped": 20.0,
    "h100_stock_mlp_backward_d10m_uncapped": 1551.50,
    "h100_whatif_bf16_sgd_d100m_uncapped": 28.04,
    "h100_whatif_bf16_sgd_d100m_capped": 28.04,
}

_CHILD = """
import resource
import torch
device, cap = {device!r}, int({cap})
if device == "cuda" and cap:
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
from repro_torch.config import RunConfig
from repro_torch.experiments import ExperimentSpec
from repro_torch.experiments import run as run_spec

cfg = RunConfig(protocol="softsync", n_softsync=1, n_learners={lam},
                minibatch=1, base_lr=0.01, optimizer="sgd", seed=5,
                ring_impl={impl!r}, ring_dtype={ring_dtype!r})
spec = ExperimentSpec(run=cfg, problem={problem!r},
                      problem_args={pargs!r}, steps={steps})
res = run_spec(spec, device=device)
if device == "cuda":
    peak = torch.cuda.max_memory_allocated()
else:
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
print("FEASIBLE", sorted(res.metrics)[0], f"peak_bytes={{peak}}")
"""


def _run_child(code: str, record: dict) -> dict:
    """Run one child; a zero exit with its FEASIBLE line is feasible,
    anything else (``torch.OutOfMemoryError``, a killed process, any other
    error) is not, with the child's last stderr line as the detail."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(repo_root(), "src"),
                    env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=_CHILD_TIMEOUT)
    ok = proc.returncode == 0 and "FEASIBLE" in proc.stdout
    return dict(record, feasible=ok, detail=(
        proc.stdout.strip() if ok else
        (proc.stderr.strip().splitlines() or ["killed"])[-1][:200]))


def _try_replay(label: str, d: int, impl: str, problem: str, pargs: tuple,
                ring_dtype: str = "fp32", cap: int = _CAP_BYTES,
                device: str = "cuda") -> dict:
    """One capped replay in a child process (``cap`` 0: uncapped)."""
    code = _CHILD.format(device=device, cap=cap, lam=_LAM, impl=impl,
                         problem=problem, pargs=pargs, steps=_STEPS,
                         ring_dtype=ring_dtype)
    return _run_child(code, {"label": label, "d": d, "impl": impl,
                             "problem": problem, "ring_dtype": ring_dtype,
                             "cap_bytes": cap})


def peak_bytes(trial: dict):
    """The ``peak_bytes=`` a feasible trial's child reported, else None."""
    if not trial["feasible"]:
        return None
    return int(trial["detail"].rsplit("peak_bytes=", 1)[1])


def _stock_bytes_per_param(K: int, c: int) -> float:
    """Working-set bytes/param of the stock real-backward path: the
    double-buffered (K, D) fp32 ring + the per-event (c, D) pulled-weight
    and gradient fp32 matrices (live together through the backward)."""
    return 2.0 * K * 4 + 2.0 * c * 4


def _whatif_bytes_per_param(K: int, ring_dtype: str, optimizer: str) -> float:
    """Working-set bytes/param of the what-if path: the ring carry (+
    state/residue, ``roofline.ring_bytes``) plus the O(D) streaming set —
    a, w*, the accumulator, and one pulled row."""
    from repro_torch.launch.roofline import ring_bytes
    carry = ring_bytes(K, 1 << 20, ring_dtype, optimizer)["bytes_per_param"]
    return carry + 4.0 * 4


def analytic() -> dict:
    """Part 1: ``configs_table`` and ``analytic``, the reference's
    arithmetic over the registered architectures (64 GiB budget, K = 3,
    c = 128)."""
    from repro_torch.configs import ARCH_IDS, get_config

    budget = 64 << 30
    K, c = 3, _LAM          # 1-softsync lam=128: sigma <= 2n -> K = 3
    stock_bpp = _stock_bytes_per_param(K, c)
    rows = {}
    for arch in ARCH_IDS:
        n = int(get_config(arch).param_count())
        for dtype in ("fp32", "bf16"):
            bpp = _whatif_bytes_per_param(K, dtype, "momentum")
            rows[f"{arch}_{dtype}"] = {
                "params": n,
                "whatif_bytes_per_param": bpp,
                "whatif_gb": n * bpp / 2**30,
                "stock_gb": n * stock_bpp / 2**30,
                "whatif_fits_budget": n * bpp <= budget,
                "stock_fits_budget": n * stock_bpp <= budget,
            }
    out = {"configs_table": rows}
    out["analytic"] = {
        "K": K, "c": c, "budget_gb": budget / 2**30,
        "stock_bytes_per_param": stock_bpp,
        "whatif_fp32_bytes_per_param": _whatif_bytes_per_param(
            K, "fp32", "momentum"),
        "whatif_bf16_bytes_per_param": _whatif_bytes_per_param(
            K, "bf16", "momentum"),
        "max_feasible_d_stock": int(budget / stock_bpp),
        "max_feasible_d_whatif_fp32": int(
            budget / _whatif_bytes_per_param(K, "fp32", "momentum")),
        "max_feasible_d_whatif_bf16": int(
            budget / _whatif_bytes_per_param(K, "bf16", "momentum")),
    }
    out["analytic"]["feasible_d_gain_bf16"] = (
        out["analytic"]["max_feasible_d_whatif_bf16"]
        / out["analytic"]["max_feasible_d_stock"])
    return out


def compute(cap_bytes: int = _CAP_BYTES, device="cuda"):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    out = analytic()
    rows, gain = out["configs_table"], out["analytic"]["feasible_d_gain_bf16"]
    K, c = out["analytic"]["K"], out["analytic"]["c"]
    out["measured_bytes_per_param"] = dict(MEASURED_BYTES_PER_PARAM)
    emit("ring_feasibility/analytic/max_feasible_D",
         f"stock={out['analytic']['max_feasible_d_stock']:.2e} "
         f"whatif_bf16={out['analytic']['max_feasible_d_whatif_bf16']:.2e}",
         f"gain={gain:.1f}x at K={K} c={c} under 64GB")
    fits = [a for a in ARCH_IDS
            if rows[f"{a}_bf16"]["whatif_fits_budget"]
            and not rows[f"{a}_bf16"]["stock_fits_budget"]]
    emit("ring_feasibility/analytic/configs_unlocked",
         len(fits), ",".join(fits))

    # ---- empirical: two capped children, run side by side ----------------
    # old path = real MLP backward through the stock body at D0; new path =
    # the what-if kernel on the closed-form quadratic at 10*D0, same trace
    # shape and cap
    lanes = [
        ("stock_real_backward_D0", _D0, "stock", "mlp_teacher",
         (("hidden", _HIDDEN0),), "fp32"),
        ("whatif_megakernel_10xD0", _D_WHATIF, "auto", "quadratic_whatif",
         (("d", _D_WHATIF),), "bf16"),
    ]
    with ThreadPoolExecutor(len(lanes)) as pool:
        trials = list(pool.map(
            lambda lane: _try_replay(*lane, cap=cap_bytes,
                                     device=dev.type), lanes))
    out["rlimit_demo"] = {
        "cap_gb": cap_bytes / 2**30, "lam": _LAM, "steps": _STEPS,
        "trials": trials,
        "demonstrated_gain": (">=10x" if (not trials[0]["feasible"]
                                          and trials[1]["feasible"])
                              else "NOT demonstrated"),
    }
    for t in trials:
        emit(f"ring_feasibility/rlimit/{t['label']}",
             "feasible" if t["feasible"] else "OOM",
             f"d={t['d']:.0e} cap={cap_bytes / 2**30:.1f}GB "
             f"peak_bytes={peak_bytes(t)}")
    emit("ring_feasibility/rlimit/gain",
         out["rlimit_demo"]["demonstrated_gain"],
         f"real backward dies at D0={_D0:.0e}; what-if replays 10*D0")

    out["claims"] = {
        "whatif_extends_feasible_d": gain > 10.0,
        "rlimit_gain_demonstrated":
            out["rlimit_demo"]["demonstrated_gain"] == ">=10x",
    }
    return [], out


register_cell(Cell(
    name="ring", result="ring_feasibility",
    title="Ring feasibility: stock vs what-if kernel model-size limits",
    compute=compute, skip_quick=True,
    claims=derived_claims("whatif_extends_feasible_d",
                          "rlimit_gain_demonstrated")))
