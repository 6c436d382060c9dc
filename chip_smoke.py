#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: every CUDA source under ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all started together).
3. Kernel vs plain version on the card: ``ring_apply`` over optimizer ×
   mode × ring dtype and ``ring_apply_whatif`` over optimizer × ring dtype,
   at D = 2²² + 37 (a ragged edge), c = 32, K ∈ {3, 1} (K = 1: hardsync,
   the read and written rows are one).  Tolerance: 0 — bitwise.
4. The paper's shape: ``mlp_teacher`` at its defaults (D = 2 762),
   1-softsync λ = 30, μ = 4, momentum, 300 updates, eval every 100 —
   through ``driver.run``; held against the same run through the plain
   versions on the CPU (weights within 1e-5, test error within two of the
   2 048 test samples: the matmuls sum in another order there).
5. The real-backward wide lane: ``mlp_teacher(hidden=232558)``
   (D = 10 000 004), 1-softsync λ = 128, μ = 1, sgd, 8 updates, fp32 and
   bf16 ring; each held bitwise against the same run through the plain
   versions on the card (``ring_impl="fused"``).
6. The what-if lane: ``quadratic_whatif(arch="qwen2_1_5b")``
   (D = 1 777 086 464), 1-softsync λ = 128, sgd, 8 updates, bf16 ring;
   the loss must fall, and the run is held bitwise against the plain
   versions on the card.
7. Per-launch times of each kernel at the phase 5 / 6 shapes beside its
   bound and its plain version's time, then the ``kernels`` JSON line, the
   ``nvidia-smi`` line and, last, ``{"ok": true, "device": ...}``.

Launch counts are zeroed just before each main-path phase (4, 5, 6) and
read just after it; they must equal the update counts.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM fp32 outside the tensor cores is 67 TFLOP/s counting an FMA as
# two operations.  The kernels are built with -fmad=false (kernel ≡ plain
# version needs every product and sum rounded on its own), so each add or
# multiply takes an issue slot of its own: half that rate.
PEAK_FP32_OPS_PER_S = 67e12 / 2
OPT_OPS = {"sgd": 2, "momentum": 4, "adagrad": 7}   # fp32 ops per element


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(xs, ys) -> float:
    """Max |x − y| over matching tensors (None pairs skipped), row by row
    so a what-if-sized ring never has an fp32 copy."""
    worst = 0.0
    for x, y in zip(xs, ys):
        if x is None and y is None:
            continue
        for xr, yr in zip(x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])):
            worst = max(worst, float((xr.float() - yr.float()).abs().max()))
    return worst


def assert_bitwise(xs, ys, what: str) -> float:
    """0.0 when every tensor pair is bitwise equal; raises otherwise."""
    import torch
    for x, y in zip(xs, ys):
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: kernel and plain version differ "
                                 f"(max |diff| {max_abs_diff(xs, ys)})")
    return 0.0


# ---------------------------------------------------------------------------
# event inputs
# ---------------------------------------------------------------------------
def event_inputs(D, c, K, opt, dtype, whatif, seed, dev):
    """One event's operands on the card, from a torch.Generator seed."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    ring = torch.empty(K, D, device=dev, dtype=torch.bfloat16
                       if dtype == "bf16" else torch.float32)
    for r in range(K):                  # row by row: no (K, D) fp32 temp
        ring[r] = randn(D)
    s = None if opt == "sgd" else randn(D).abs()
    res = randn(D, scale=1e-3) if dtype == "bf16" else None
    coef = torch.full((c,), 1.0 / c, device=dev)
    lrs = torch.rand(c, generator=gen, device=dev) * 0.09 + 0.01
    # pulled rows: any row but the slot row (as in a trace, where the row
    # being overwritten is older than any live pull)
    prev, slot = 0, 1 % K
    rows = torch.tensor([r for r in range(K) if r != slot] or [0],
                        device=dev)
    ts = rows[torch.randint(0, rows.numel(), (c,), generator=gen,
                            device=dev)]
    idx = torch.cat([torch.tensor([prev, slot], device=dev), ts]).to(
        torch.int32)
    ops = dict(ring=ring, s=s, res=res, coef=coef, lrs=lrs, idx=idx)
    if whatif:
        ops["a"] = torch.rand(D, generator=gen, device=dev) + 0.5
        ops["wstar"] = randn(D)
    else:
        ops["g"] = randn(c, D)
        ops["idx"] = idx[:2].contiguous()
    return ops


def clone_state(ops):
    return {k: (None if v is None else
                v.clone() if k in ("ring", "s", "res") else v)
            for k, v in ops.items()}


def run_kernel(ops, spec, mode, whatif):
    from repro_torch.kernels import replay_ring
    if whatif:
        return replay_ring.ring_apply_whatif(
            ops["ring"], ops["s"], ops["res"], ops["a"], ops["wstar"],
            ops["coef"], ops["lrs"], ops["idx"], spec=spec)
    return replay_ring.ring_apply(ops["ring"], ops["s"], ops["res"],
                                  ops["g"], ops["coef"], ops["lrs"],
                                  ops["idx"], spec=spec, mode=mode)


def run_plain(ops, spec, mode, whatif):
    from repro_torch.optim import backends
    idx = ops["idx"]
    if whatif:
        return backends.apply_event_ring_whatif(
            spec, ops["ring"], ops["s"], ops["res"], ops["a"], ops["wstar"],
            idx[2:], ops["coef"], ops["lrs"], idx[0], idx[1])
    return backends.apply_event_ring(spec, ops["ring"], ops["s"], ops["res"],
                                     ops["g"], ops["coef"], ops["lrs"],
                                     idx[0], idx[1], mode)


def compare(ops, spec, mode, whatif, what) -> float:
    """One kernel launch on a copy of the inputs and one plain call on the
    inputs themselves; raises unless bitwise equal.  Returns max |diff|."""
    import torch
    kern = run_kernel(clone_state(ops), spec, mode, whatif)
    plain = run_plain(ops, spec, mode, whatif)
    torch.cuda.synchronize()
    return assert_bitwise(kern, plain, what)


def event_cost(ops, opt, mode, whatif):
    """(bytes, fp32 ops) one event needs: each input read once, each output
    written once.  A what-if event reads each distinct pulled row once and
    needs gⱼ = a·(r − w*) once per distinct row (equal rows give equal
    gⱼ, so the slot-order sum keeps its rounding); the sum itself is a
    multiply and an add per slot."""
    ring = ops["ring"]
    K, D = ring.shape
    rb = ring.element_size()
    c = ops["coef"].shape[0]
    stateful, ef = ops["s"] is not None, ops["res"] is not None
    per = 8 * stateful + 8 * ef + rb          # state r/w, residue r/w, write
    if whatif:
        idx = ops["idx"].tolist()
        rows = {idx[0], *idx[2:]}             # prev and the distinct ts rows
        per += rb * len(rows) + 8             # pulled rows, a and w*
        ops_per = 2 * c + 2 * len(set(idx[2:])) + OPT_OPS[opt]
    else:
        per += rb + 4 * c                     # row prev, staged gradients
        ops_per = (2 * c + OPT_OPS[opt] if mode == "combine"
                   else c * (1 + OPT_OPS[opt]))
    ops_per += 2 * ef
    return per * D, ops_per * D


def bound_ms(ops, opt, mode, whatif):
    nbytes, nops = event_cost(ops, opt, mode, whatif)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_kernels_vs_plain(dev) -> dict:
    """Both kernels at K = 3 (prev, slot and the pulled rows apart) and at
    K = 1 (hardsync: prev = slot = every tsⱼ = row 0, read and written in
    the same launch)."""
    from repro_torch.optim import UpdateSpec
    D, c = (1 << 22) + 37, 32
    worst = {"ring_apply": 0.0, "ring_apply_whatif": 0.0}
    for K in (3, 1):
        for opt in ("sgd", "momentum", "adagrad"):
            for dtype in ("fp32", "bf16"):
                for mode in ("combine", "sequential"):
                    ops = event_inputs(D, c, K, opt, dtype, False, 11, dev)
                    err = compare(ops, UpdateSpec(opt), mode, False,
                                  f"ring_apply {opt}/{mode}/{dtype}/K={K}")
                    worst["ring_apply"] = max(worst["ring_apply"], err)
                    log(f"  ring_apply        {opt:8s} {mode:10s} {dtype} "
                        f"K={K}  D={D} c={c}  max|kernel-plain| = {err}")
                ops = event_inputs(D, c, K, opt, dtype, True, 12, dev)
                err = compare(ops, UpdateSpec(opt), "combine", True,
                              f"ring_apply_whatif {opt}/{dtype}/K={K}")
                worst["ring_apply_whatif"] = max(worst["ring_apply_whatif"],
                                                 err)
                log(f"  ring_apply_whatif {opt:8s} combine    {dtype} "
                    f"K={K}  D={D} c={c}  max|kernel-plain| = {err}")
    return worst


def drive(spec, dev):
    """driver.run on the card with launch counts zeroed just before and
    read just after; returns (result, seconds, launches)."""
    import torch
    from repro_torch.experiments import run
    from repro_torch.kernels import replay_ring
    torch.cuda.synchronize()
    replay_ring.reset_launches()
    t0 = time.perf_counter()
    res = run(spec, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, secs, dict(replay_ring.launches)


def params_bitwise(a, b, what):
    import torch
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: leaf {k} differs")


def params_finite(p, what):
    import torch
    for k, v in p.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite values in {k}")


def phase_paper_shape(dev, launches):
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec
    spec = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=30,
                      minibatch=4, base_lr=0.1,
                      lr_policy="staleness_inverse", optimizer="momentum"),
        problem="mlp_teacher", steps=300, eval_every=100)
    res, secs, counts = drive(spec, dev)
    launches["ring_apply"] += counts["ring_apply"]
    if counts != {"ring_apply": 300, "ring_apply_whatif": 0}:
        raise AssertionError(f"phase 4 launches {counts}, expected 300")
    params_finite(res.params, "phase 4")
    errs = [round(c["test_error"], 6) for c in res.curve]
    log(f"  test error per segment {errs} (updates "
        f"{[c['update'] for c in res.curve]}); final "
        f"{res.metrics['test_error']}; {300 / secs:.1f} events/s "
        f"({secs:.3f} s incl. staging); ring_apply launches "
        f"{counts['ring_apply']}; K = {res.staleness['ring_buffer_K']}")
    from repro_torch.experiments import run
    cpu = run(spec, device="cpu")
    cpu_errs = [c["test_error"] for c in cpu.curve]
    worst = max(float((res.params[k].cpu() - cpu.params[k]).abs().max())
                for k in cpu.params)
    log(f"  same spec through the plain versions on the CPU: test error "
        f"{cpu_errs}; max |card - cpu| over the params = {worst}")
    # cuBLAS and the CPU sum the matmuls in different orders, so the two
    # runs agree to fp32 rounding compounded over 300 events, not bitwise
    if worst > 1e-5 or max(abs(a - b) for a, b in zip(errs, cpu_errs)) \
            > 2 / 2048:
        raise AssertionError("phase 4: card and CPU runs disagree")
    if not errs[-1] < 0.5:
        raise AssertionError(f"phase 4: test error {errs[-1]} did not fall")
    del res, cpu
    torch.cuda.empty_cache()


def phase_wide_lane(dev, launches):
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec
    out = {}
    for dtype in ("fp32", "bf16"):
        spec = ExperimentSpec(
            run=RunConfig(protocol="softsync", n_softsync=1,
                          n_learners=128, minibatch=1, base_lr=0.01,
                          optimizer="sgd", seed=5, ring_dtype=dtype),
            problem="mlp_teacher", problem_args={"hidden": 232558},
            steps=8)
        torch.cuda.reset_peak_memory_stats()
        res, secs, counts = drive(spec, dev)
        peak = torch.cuda.max_memory_allocated()
        launches["ring_apply"] += counts["ring_apply"]
        if counts != {"ring_apply": 8, "ring_apply_whatif": 0}:
            raise AssertionError(f"phase 5 launches {counts}, expected 8")
        D = sum(v.numel() for v in res.params.values())
        if D != 10_000_004:
            raise AssertionError(f"phase 5: D = {D}")
        params_finite(res.params, "phase 5")
        log(f"  {dtype} ring: D = {D}, c = 128, K = "
            f"{res.staleness['ring_buffer_K']}: {secs / 8 * 1e3:.3f} "
            f"ms/event ({secs:.3f} s incl. staging), peak "
            f"{peak / 2**30:.2f} GiB, test error "
            f"{res.metrics['test_error']}, ring_apply launches "
            f"{counts['ring_apply']}")
        plain, psecs, _ = drive(spec.replace(
            run=spec.run.replace(ring_impl="fused")), dev)
        params_bitwise(res.params, plain.params, f"phase 5 {dtype}")
        log(f"    same run through the plain versions on the card: "
            f"bitwise equal; {psecs / 8 * 1e3:.3f} ms/event")
        out[dtype] = res.staleness["ring_buffer_K"]
        del res, plain
        torch.cuda.empty_cache()
    return out


def phase_whatif_lane(dev, launches):
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec
    from repro_torch.experiments.problems import get_problem
    spec = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=128,
                      minibatch=1, base_lr=0.01, optimizer="sgd", seed=5,
                      ring_dtype="bf16"),
        problem="quadratic_whatif", problem_args={"arch": "qwen2_1_5b"},
        steps=8)
    prob = get_problem(spec.problem, spec.problem_args)
    before = prob.eval_fn(prob.init(dev))["loss"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, secs, counts = drive(spec, dev)
    peak = torch.cuda.max_memory_allocated()
    launches["ring_apply_whatif"] += counts["ring_apply_whatif"]
    if counts != {"ring_apply": 0, "ring_apply_whatif": 8}:
        raise AssertionError(f"phase 6 launches {counts}, expected 8")
    after = res.metrics["loss"]
    w = res.params["w"]
    if w.numel() != 1_777_086_464 or not bool(torch.isfinite(w).all()):
        raise AssertionError("phase 6: bad final weights")
    log(f"  D = {w.numel()}, c = 128, K = {res.staleness['ring_buffer_K']}, "
        f"bf16 ring: loss {before} -> {after}; {secs / 8 * 1e3:.3f} "
        f"ms/event ({secs:.3f} s incl. a/w* generation and the final "
        f"loss); peak {peak / 2**30:.2f} GiB of 80; ring_apply_whatif "
        f"launches {counts['ring_apply_whatif']}")
    if not after < before:
        raise AssertionError(f"phase 6: loss did not fall ({before} -> "
                             f"{after})")
    if peak > 70e9:
        raise AssertionError(f"phase 6: peak memory {peak} too close to "
                             f"80 GB")
    K = res.staleness["ring_buffer_K"]
    kept = w.cpu()
    del res, w
    torch.cuda.empty_cache()
    plain, psecs, _ = drive(spec.replace(
        run=spec.run.replace(ring_impl="fused")), dev)
    params_bitwise({"w": kept}, {"w": plain.params["w"].cpu()}, "phase 6")
    log(f"    same run through the plain versions on the card: bitwise "
        f"equal; {psecs / 8 * 1e3:.3f} ms/event")
    del plain, kept
    torch.cuda.empty_cache()
    return K


def time_kernel(name, D, c, K, opt, dtype, mode, whatif, dev, reps,
                plain_reps):
    """Time one kernel and its plain version at one shape; hold one launch
    of each against the other first."""
    import torch
    from repro_torch.optim import UpdateSpec
    spec = UpdateSpec(opt)
    ops = event_inputs(D, c, K, opt, dtype, whatif, 21, dev)
    err = compare(ops, spec, mode, whatif, f"{name} at the path's shape")
    ms = cuda_ms(lambda: run_kernel(ops, spec, mode, whatif), reps)
    plain_ms = cuda_ms(lambda: run_plain(ops, spec, mode, whatif),
                       plain_reps)
    bms, by = bound_ms(ops, opt, mode, whatif)
    nbytes, nops = event_cost(ops, opt, mode, whatif)
    log(f"  {name:18s} {opt} {mode} {dtype} D={D} c={c} K={K}: "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms; bound {bms:.4f} ms by "
        f"{by}: {nbytes / 1e9:.3f} GB, {nops / 1e9:.3f} Gop; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)")
    del ops
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script drives the port on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    log("phase 1: device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    log("phase 2: build")
    secs, libs = build.build_all()
    for name, path in libs.items():
        spills = [ln.strip() for ln in
                  path.with_suffix(".log").read_text().splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes")]
        log(f"  {name}: {path.name} in {secs:.1f} s (nvcc, parallel); "
            f"ptxas lines with spills: {len(spills)}")
        for ln in spills[:4]:
            log(f"    {ln}")

    log("phase 3: kernel vs plain version on the card (tolerance 0)")
    worst = phase_kernels_vs_plain(dev)

    launches = {"ring_apply": 0, "ring_apply_whatif": 0}
    log("phase 4: paper shape — mlp_teacher D=2762, 1-softsync λ=30, μ=4, "
        "momentum, 300 updates")
    phase_paper_shape(dev, launches)
    log("phase 5: wide lane — mlp_teacher hidden=232558, 1-softsync λ=128, "
        "μ=1, sgd, 8 updates")
    wide_K = phase_wide_lane(dev, launches)
    log("phase 6: what-if lane — quadratic_whatif arch=qwen2_1_5b, "
        "1-softsync λ=128, sgd, 8 updates, bf16 ring")
    whatif_K = phase_whatif_lane(dev, launches)

    log("phase 7: per-launch times at the phase 5 / 6 shapes")
    t_apply = time_kernel("ring_apply", 10_000_004, 128, wide_K["fp32"],
                          "sgd", "fp32", "combine", False, dev, 20, 5)
    time_kernel("ring_apply", 10_000_004, 128, wide_K["bf16"], "sgd",
                "bf16", "combine", False, dev, 20, 5)
    t_whatif = time_kernel("ring_apply_whatif", 1_777_086_464, 128,
                           whatif_K, "sgd", "bf16", "combine", True, dev, 5,
                           1)
    kernels = []
    for name, t, line in (("ring_apply", t_apply, 275),
                          ("ring_apply_whatif", t_whatif, 366)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/replay_ring.cu",
            "replaces": f"src/repro/kernels/replay_ring.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(worst[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    for k in kernels:
        if k["launches"] == 0 or not math.isfinite(k["ms"]):
            raise AssertionError(f"{k['name']}: not launched on the path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
