#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN,
   and bf16 matmuls reduce in fp32
   (``allow_bf16_reduced_precision_reduction = False``), which the
   serving phases' prefill-vs-decode comparisons rely on.
2. Build: every CUDA source under ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all started together); each build's
   seconds and ptxas lines with spills; for both flash kernels
   (``flash_attention_sm90``, ``flash_attention``) the counts of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in their SASS
   (``cuobjdump -sass``), each required to be nonzero, and ptxas's wgmma
   warnings; for the redesigned ``ring_apply_whatif`` kernel, the
   four ``ssm_scan`` kernels and the three ``wkv6`` kernels, their
   registers and spill bytes (ptxas; a ``wkv6`` kernel that spills fails).
3. Kernel vs plain version on the card: ``ring_apply`` over optimizer ×
   mode × ring dtype and ``ring_apply_whatif`` over optimizer × ring dtype,
   at D = 2²² + 37 (a ragged edge), c = 32, K ∈ {3, 1} (K = 1: hardsync,
   the read and written rows are one); ``ring_apply_whatif``'s two
   variants (c = 64 slots pulling 1, 2 and ``WHATIF_ROWS`` distinct rows,
   and one more, in short and in long runs of equal rows) with the slot row
   pulled and at K = 1, at D = 2²² (its 8-wide
   path) and the ragged D; ``ps_apply`` over optimizer × mode
   at the same D and c (its inputs must come back unchanged: it writes
   out of place).  Tolerance: 0 — bitwise.  Then ``flash_attention`` at
   qwen2_1_5b's GQA (H = 12 over KV = 2, D = 128) and a ragged S = 1 000:
   causal, causal with a window of 48, and non-causal, fp32 (the 3×TF32
   kernel) and bf16 (the sm90 kernel), once through the (B, KV, G, S, D)
   entry with Sq ≠ Sk, at D 64, at Sq 201 against Sk 777, and at
   zamba2_7b's attention (H = KV = 32, D = 112), causal.  Tolerance: 2e-5
   absolute in fp32 (3×TF32 products err by ~2⁻²¹ relative, exp and the
   summation order differ, FMAs allowed); in
   bf16 2⁻⁸ · max|v| over the (b, kv head)'s keys + one bf16 ulp of the
   larger output + 2e-5 (the sm90 kernel rounds P to bf16 before P·V:
   ``flash_attention.sm90_error_share``, printed as the share of that
   bound used).  Then ``ssm_scan`` at zamba2_7b's mamba
   head (H 112, P 64, N 64, chunk 256; dt in [1e-3, 0.1], A = −(1…112))
   with B / C as column slices of one tensor in bf16 and in fp32, and
   ``wkv6`` at rwkv6_7b's head (H 64, P 64, chunk 32) with r / k / v in
   bf16 and fp32, at the model's decay and at one whose exp above the
   diagonal overflows; B 2, a ragged S = 1 000 (and ``ssm_scan`` at every
   N and P it takes, S = 333, chunks 64 / 128 / 256; ``wkv6`` also at
   S = 2 000, across three edges of its groups of chunks, with the strong
   decay in odd chunks, and with chunk decay spans of 20 to 60.1, across
   the factored form's limit of 60, so its pair term takes both of its
   forms in one call); the output and the final
   state each held within (1e-5 + 2⁻²⁰ · span) of the plain version's
   largest magnitude, span the largest cumulative log decay of a chunk
   (fp32 sums in another order with FMAs, plus eight ulps of the
   cumulative decay, whose rounding every decay term exp(cum_i − cum_j)
   inherits in both versions).
4. The paper's shape: ``mlp_teacher`` at its defaults (D = 2 762),
   1-softsync λ = 30, μ = 4, momentum, 300 updates, eval every 100 —
   through ``driver.run``; held against the same run through the plain
   versions on the CPU (weights within 1e-5, test error within two of the
   2 048 test samples: the matmuls sum in another order there).
4b. The legacy paper shape: the same run through the per-arrival host-PS
   loop (``execute(engine="legacy")``), every update one ``ps_apply``
   launch (300); vector clocks and simulated time equal phase 4's
   exactly, weights within 1e-5 and test errors within two of the 2 048
   test samples of phase 4's (the replay computes an event's 30 gradients
   in one batched matmul, the loop one at a time).
5. The real-backward wide lane: ``mlp_teacher(hidden=232558)``
   (D = 10 000 004), 1-softsync λ = 128, μ = 1, sgd, 8 updates, fp32 and
   bf16 ring; each held bitwise against the same run through the plain
   versions on the card (``ring_impl="fused"``).
5b. The legacy wide lane: phase 5's fp32 spec through ``driver.run`` with
   ``engine="legacy"`` (8 ``ps_apply`` launches over D = 10 000 004,
   c = 128), held bitwise against the same run through the pytree backend
   (``ps_backend="reference"``) on the card; max |diff| against phase 5's
   replay printed.
5c. The elastic sharded wide lane: phase 5's fp32 spec with 8 PS shards
   (pull jitter 0.1) and learners 0–31 crashing at 1.2 s for 2.5 s (their
   slots cancelled, with coefficient 0, in events 1–5): one ``ring_apply``
   launch per event over the padded width 8 · 1 250 001 (8 launches), held
   bitwise against the same run through the plain versions on the card;
   ms/event beside phase 5's and peak memory printed.
6. The what-if lane: ``quadratic_whatif(arch="qwen2_1_5b")``
   (D = 1 777 086 464), 1-softsync λ = 128, sgd, 8 updates, bf16 ring;
   the loss must fall, and the run is held bitwise against the plain
   versions on the card.
7. Per-launch times of each kernel at the phase 5 / 6 shapes beside its
   bound, its plain version's time and one PyTorch call computing the same
   event (``torch.addmv``, where one exists); ``flash_attention`` at one
   layer of the prefill_32k shape (B 1, KV 2, G 6, S 32 768, D 128, causal)
   and at one layer of zamba2_7b's prefill (B 1, H = KV = 32, S 8 192,
   D 112): the sm90 kernel in bf16 and the 3×TF32 kernel in fp32, each
   beside its plain version, ``scaled_dot_product_attention`` in the same
   dtype (the yardstick; the port never calls it; fp32 through its
   memory-efficient backend on K/V expanded to H heads) with the
   kernel/library ratio, and its bound (``attention_cost``: the mask's
   live pairs at 989 TFLOP/s bf16, or three times them at 495 TFLOP/s
   TF32, the CUDA-core bound at 67 TFLOP/s fp32 beside it), with the
   tensor-core rate achieved and the share of the bound reached; and
   ``ssm_scan`` and ``wkv6`` at one layer of their model's prefill (B 1,
   S 8 192, bf16 operands) beside their plain versions and bounds (no
   PyTorch call computes either: no library time); ``ring_apply_whatif``
   also with the older ring row pulled (2 distinct rows) in 4 runs, as the
   lane's events come, and in short runs; ``ssm_scan``'s and ``wkv6``'s
   time per call split by their kernels (``torch.profiler``), ``wkv6``'s
   scratch, the operations its kernels do beside the bound's count, and
   its time also with every chunk's pair term in the direct form (the
   strong decay) and with half of them (the mixed decay).  Each
   time with its achieved rates and its share of the bound.
8. Serving: qwen2_1_5b at full width and depth (28 layers, bf16, weights
   from a seeded ``torch.Generator`` on the card) through
   ``serve/engine.py`` with ``attn_impl="pallas", use_pallas=True``:
   ``prefill_step`` of one 8 192-token prompt (exactly 28 flash launches,
   all 28 through the sm90 kernel; finite logits, tokens per second); at
   a 64-token prompt and B = 2, ``prefill_step``'s logits against the
   decode-replay ``prefill``'s and against ``attn_impl="naive",
   use_pallas=False`` (the plain versions) —
   printed in bf16, and held within 1e-3 on the same weights in fp32 (fp32
   rounding orders; bf16 at 28 layers differs by more than the 2-layer
   reference test's 7e-2 between any two of the three, so it is reported,
   not held); ``generate`` (B 4, 16 prompt and 32 new tokens, decode
   tokens per second); ``ContinuousBatchingEngine`` answering 6 requests
   in 4 slots, each with its 8 tokens; peak device memory.
9. The same for zamba2_7b (81 layers: 27 units of shared attention and two
   mamba blocks, 4 645 909 472 parameters): exactly 54 ``ssm_scan`` and 27
   ``flash_attention`` launches per prefill forward (in bf16 all 27 through
   the sm90 kernel, in fp32 through the 3×TF32 one); fp32 held within
   1e-2 (``SERVING``: 81 layers of random weights amplify rounding).
10. The same for rwkv6_7b (32 rwkv layers, 6 997 544 960 parameters):
   exactly 32 ``wkv6`` launches per prefill forward; fp32 held within
   1e-3.  Each model is freed before the next.  Then the ``kernels`` JSON
   line (all six TPU kernels; the flash kernel a row per dtype's kernel),
   the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": ...}`` (after phase 12).
11. The paper cells ``elastic``, ``topology`` and ``serve`` at their
   default params (``epochs`` 2.0, 1 024 requests) through
   ``campaign.run_cell`` on the card, into a temporary results directory:
   every claim ``ok``; every record found in the reference's committed
   envelope (``benchmarks/results/*.json``) by its spec's address without
   the port's backend marker, its ``simulated_time``, ``updates``,
   ``minibatches``, staleness block and serving trace counts equal and its
   ``replay_path`` the envelope's (but for the one record named in
   ``STALE_REPLAY_PATH``) and the CPU run's; ``test_error`` and ``serving_accuracy``
   within two of the 2 048 test samples of the same cell run through the
   plain versions on the CPU, and within 37 of the envelope's (the
   envelopes come from an older reference: ``CARD_VS_CPU_TOL``,
   ``ENVELOPE_TOL``); ``ring_apply``
   launches per cell equal to the events its records replay (plus the 4 ×
   40 of ``topology``'s engine-overhead timing); seconds and events/s
   per cell.
12. The rest of the paper campaign through ``campaign.run_cell`` on the
   card at the cells' default params, into a temporary results directory,
   each cell also run on the CPU at the same params (every CPU twin at the
   default params — fig5 4.4, fig6_7 25.2, table2 11.9, baselines 8.2,
   table3_4 42.8 s on the host of one NVIDIA H100 80GB HBM3, 700.00 W —
   so none runs at ``quick_params``):
   ``table1`` and ``fig8`` (analytic) with ``derived`` equal to the
   envelope's and the CPU run's exactly; ``fig4`` (measure mode) with every
   record's schedule side equal to the envelope's and no launch; the replay
   cells ``fig5``, ``fig6_7`` and ``table2`` with every record's schedule
   side (simulated time, updates, minibatches, staleness) equal to the
   envelope's and the CPU run's, ``replay_path`` the CPU run's (and
   ``fig5``'s envelope's, the only one that records it), ``test_error``
   finite exactly where the other side's is, within 2/2048 of the CPU
   run's (``CARD_VS_CPU_TOL``; ``fig5``'s n=30/const within
   ``CHAOTIC``'s 140/2048, the spread one-ulp changes of one initial weight
   give it on the CPU) and within ``PAPER_ENVELOPE_TOL`` of the envelope's
   (per cell, today's reference's drift from its envelope plus 2 samples:
   fig5 290, fig6_7 88, table2 50, baselines 38, table3_4 29 of 2 048),
   and ``ring_apply`` launches equal to the events the records replay
   (123 648); the legacy cells ``baselines`` and ``table3_4`` with every
   number of ``derived`` that is not a test error (simulated time,
   staleness, stalls, ``time_s``, ``minutes_per_epoch_model``) equal to
   the envelope's and the CPU run's, their errors held as above, and
   ``ps_apply`` launches equal to the host-PS updates their simulations
   apply (``ps_updates``: 384 and 33 751); ``sim_engine`` at its quick
   budget (40 updates a row; the legacy rows at λ = 128 make its default
   480 take minutes), ``kernels`` and ``bench_guard`` with every claim ok,
   ``sim_engine``'s ``max_param_drift`` printed, and the guard's floors
   (``experiments/ci_floor_h100.json``) failing at 100 times their value
   through ``bench_guard.check`` in this process; every claim ``ok`` but
   ``fig6_7``'s ``error_grows_with_mu_lambda``, which today's reference
   fails too (``RED_IN_REFERENCE``, ROADMAP.md §3) and which is held
   equal to the CPU run's; then the ``smoke`` campaign twice, the second
   pass all cache hits.  Seconds, events/s or updates/s and launches per
   cell.

Launch counts are zeroed just before each main-path phase (4, 4b, 5, 5b,
5c, 6, each run of phases 8–10 and each cell of phases 11 and 12) and
read just after it; they must equal the update counts (phases 8–10: one
kernel launch per attention, mamba or rwkv layer of a prefill forward,
none in decode); flash launches are also counted per kernel
(``flash_sm90``, ``flash_tf32x3``).  The ``kernels`` line adds every
phase-12 cell's launches but the ``kernels`` cell's, which holds each
kernel against a plain chain.

Time budget: the whole script stays under 700 s, well inside a 900 s
limit: it took 458.8–464.8 s, phase 12 238.4–252.2 s of it (card runs and
CPU twins), on one NVIDIA H100 80GB HBM3, 700.00 W.
"""

import dataclasses
import functools
import json
import math
import re
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
# flash_attention builds with FMAs: the data sheet's fp32 rate as it is
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12          # dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12          # dense bf16 on the tensor cores
# the kernels line's flash rows and the launch count each reads
FLASH_ROWS = {"flash_attention": "flash_sm90",
              "flash_attention_fp32": "flash_tf32x3"}
OPT_OPS = {"sgd": 2, "momentum": 4, "adagrad": 7}   # fp32 ops per element
CHECK_D = (1 << 22) + 37          # phase 3: a ragged width (no vector path)
WIDE_HIDDEN = 232558              # phases 5 / 5b: mlp_teacher's width …
WIDE_D = 10_000_004               # … and its parameter count


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
def event_inputs(D, c, K, opt, dtype, whatif, seed, dev, n_rows=None,
                 slot_pulled=False, long_runs=False):
    """One event's operands on the card, from a torch.Generator seed.
    ``n_rows``: the what-if slots pull exactly that many distinct rows, in
    runs of 1 to 3 equal slots, or (``long_runs``) in max(n_rows, 4) equal
    runs, as a trace's slots come (the what-if lane's events pull 2 rows in
    2 or 3 runs); ``slot_pulled``: the slot row may be among them (an older
    snapshot the event reads before it writes)."""
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
    rows = torch.tensor([r for r in range(K) if r != slot or slot_pulled]
                        or [0], device=dev)
    if n_rows is None:
        ts = rows[torch.randint(0, rows.numel(), (c,), generator=gen,
                                device=dev)]
    else:
        pulled = rows[:n_rows].tolist()
        if len(pulled) != n_rows:
            raise ValueError(f"{n_rows} distinct rows from a ring of {K}")
        lens = torch.randint(1, 4, (c,), generator=gen, device=dev).tolist()
        picks = torch.randint(0, n_rows, (c,), generator=gen,
                              device=dev).tolist()
        if long_runs:
            n = max(n_rows, 4)
            lens, picks = [-(-c // n)] * n, [k % n_rows for k in range(n)]
        seq = []
        for k in range(len(lens)):   # each pulled row, then random runs
            seq += [pulled[k] if k < n_rows else pulled[picks[k]]] * lens[k]
        ts = torch.tensor(seq[:c], device=dev)
        if len(set(ts.tolist())) != n_rows:
            raise ValueError(f"ts {ts.tolist()} has no {n_rows} rows")
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


def ps_inputs(D, c, opt, seed, dev):
    """One host-PS update's operands on the card, from a torch.Generator
    seed: w, s (None for sgd), g (c, D), coef = 1/c, lrs."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"w": torch.randn(D, generator=gen, device=dev),
            "s": None if opt == "sgd" else
            torch.randn(D, generator=gen, device=dev).abs(),
            "g": torch.randn(c, D, generator=gen, device=dev),
            "coef": torch.full((c,), 1.0 / c, device=dev),
            "lrs": torch.rand(c, generator=gen, device=dev) * 0.09 + 0.01}


def ps_kernel(ops, spec, mode):
    from repro_torch.kernels import ps_update
    return ps_update.ps_apply(ops["w"], ops["s"], ops["g"], ops["coef"],
                              ops["lrs"], spec=spec, mode=mode)


def ps_plain(ops, spec, mode):
    from repro_torch.optim import backends
    return backends.apply_event_flat(spec, ops["w"], ops["s"], ops["g"],
                                     ops["coef"], ops["lrs"], mode)


def ps_compare(ops, spec, mode, what) -> float:
    """One kernel launch and one plain call on the same inputs; raises
    unless bitwise equal, or if the kernel wrote its inputs (it must write
    out of place).  Returns max |diff|."""
    import torch
    kept = {k: None if v is None else v.clone() for k, v in ops.items()}
    kern = ps_kernel(ops, spec, mode)
    torch.cuda.synchronize()
    assert_bitwise([ops[k] for k in kept], list(kept.values()),
                   f"{what}: inputs after the launch")
    plain = ps_plain(ops, spec, mode)
    torch.cuda.synchronize()
    return assert_bitwise(kern, plain, what)


def ps_cost(ops, opt, mode):
    """(bytes, fp32 ops) of one host-PS update: g, w and s read once, w and
    s written once; the slot-order sum is a multiply and an add per slot."""
    c, D = ops["g"].shape
    per = 4 * c + 8 + 8 * (ops["s"] is not None)
    ops_per = (2 * c + OPT_OPS[opt] if mode == "combine"
               else c * (1 + OPT_OPS[opt]))
    return per * D, ops_per * D


def bound_ms(nbytes, nops):
    """The least time for the work: the larger of bytes over HBM rate and
    fp32 operations over the fp32 issue rate; and which one bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ptxas_by_kernel(lib, families):
    """Phase 2 for the redesigned kernels: from ptxas's ``-v`` lines in the
    build log, each kernel family's registers and spill bytes (the largest
    over its template instantiations), e.g. {"ssd_out_kernel": (96, 0, 0)}."""
    out, cur = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = next((f for f in families if f in m.group(1)), None)
            continue
        if cur is None:
            continue
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        r0, st0, ld0 = out.get(cur, (0, 0, 0))
        if regs:
            out[cur] = (max(r0, int(regs.group(1))), st0, ld0)
        if spill:
            out[cur] = (r0, max(st0, int(spill.group(1))),
                        max(ld0, int(spill.group(2))))
    for f in families:
        r, st, ld = out.get(f, (0, 0, 0))
        log(f"  {lib.name.split('-')[0]} {f}: at most {r} registers, "
            f"{st} bytes spill stores, {ld} bytes spill loads (ptxas, over "
            f"its instantiations)")
        if f not in out:
            raise AssertionError(f"{f}: no ptxas lines in {lib}")
    return out


def sass_counts(lib, nvcc):
    """Phase 2 for each flash kernel: its wgmma (``HGMMA``) and TMA load
    (``UTMALDG``) instructions in the built library's SASS, each required
    to be nonzero, and ptxas's wgmma warnings (serialised wgmma)."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    warns = [ln.strip() for ln in
             lib.with_suffix(".log").read_text().splitlines()
             if "wgmma" in ln.lower()]
    name = lib.name.split("-")[0]
    log(f"  {name} SASS: {counts['HGMMA']} HGMMA, "
        f"{counts['UTMALDG']} UTMALDG instructions; ptxas wgmma warnings: "
        f"{len(warns)}")
    for ln in warns[:4]:
        log(f"    {ln}")
    if not all(counts.values()):
        raise AssertionError(f"{name}: no wgmma or no TMA load in its SASS "
                             f"({counts})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_kernels_vs_plain(dev) -> dict:
    """Both ring kernels at K = 3 (prev, slot and the pulled rows apart) and
    at K = 1 (hardsync: prev = slot = every tsⱼ = row 0, read and written
    in the same launch); then ``ps_apply``."""
    from repro_torch.optim import UpdateSpec
    D, c = CHECK_D, 32
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
    worst["ring_apply_whatif"] = max(worst["ring_apply_whatif"],
                                     phase_whatif_rows(dev))
    worst["ps_apply"] = 0.0
    for opt in ("sgd", "momentum", "adagrad"):
        for mode in ("combine", "sequential"):
            ops = ps_inputs(D, c, opt, 13, dev)
            err = ps_compare(ops, UpdateSpec(opt), mode,
                             f"ps_apply {opt}/{mode}")
            worst["ps_apply"] = max(worst["ps_apply"], err)
            log(f"  ps_apply          {opt:8s} {mode:10s} fp32 "
                f"       D={D} c={c}  max|kernel-plain| = {err}; "
                f"inputs unchanged")
    return worst


def phase_whatif_rows(dev) -> float:
    """The what-if kernel's two variants: slots pulling 1, 2 and
    ``WHATIF_ROWS`` distinct rows (the register variant) and one more (the
    per-slot variant), the slot row among them at K = 2, and hardsync's
    K = 1; at D = 2²² (the 8-wide path) and the ragged ``CHECK_D``
    (1-wide), c = 32, every optimizer, fp32 and bf16 rings.  Bitwise."""
    from repro_torch.kernels.replay_ring import WHATIF_ROWS
    from repro_torch.optim import UpdateSpec
    cases = [(3, 1, False), (3, 2, False), (2, 2, True),
             (WHATIF_ROWS + 1, WHATIF_ROWS, False),
             (WHATIF_ROWS + 2, WHATIF_ROWS + 1, False), (1, 1, True)]
    for D in (1 << 22, CHECK_D):
        for K, n_rows, slot_pulled in cases:
            for long_runs in (False, True):
                for opt in ("sgd", "momentum", "adagrad"):
                    for dtype in ("fp32", "bf16"):
                        ops = event_inputs(D, 64, K, opt, dtype, True, 17,
                                           dev, n_rows=n_rows,
                                           slot_pulled=slot_pulled,
                                           long_runs=long_runs)
                        compare(ops, UpdateSpec(opt), "combine", True,
                                f"ring_apply_whatif {opt}/{dtype}/D={D}/K={K}"
                                f"/{n_rows} rows/long runs {long_runs}")
        log(f"  ring_apply_whatif D={D} c=64: distinct pulled rows "
            f"{[n for _, n, _ in cases]} (register variant up to "
            f"{WHATIF_ROWS}; the slot row pulled at K=2; K=1), in runs of "
            f"1-3 slots and of 16 x sgd, momentum, adagrad x fp32, bf16: "
            f"max|kernel-plain| = 0.0")
    return 0.0


def counted(fn):
    """``fn()`` with every kernel's launch count zeroed just before and
    read just after; returns (result, seconds, launches)."""
    import torch
    from repro_torch.kernels import (flash_attention, ps_update,
                                     replay_ring, ssm_scan, wkv6)
    mods = (replay_ring, ps_update, flash_attention, ssm_scan, wkv6)
    torch.cuda.synchronize()
    for m in mods:
        m.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: v for m in mods for k, v in m.launches.items()}
    counts.update({f"flash_{path}": n for path, n in
                   flash_attention.launches_by_path.items()})
    return res, secs, counts


def drive(spec, dev):
    """driver.run on the card, counted (see :func:`counted`)."""
    from repro_torch.experiments import run
    return counted(lambda: run(spec, device=dev))


def expect(counts, what, **want):
    full = {"ring_apply": 0, "ring_apply_whatif": 0, "ps_apply": 0,
            "flash_attention": 0, "flash_sm90": 0, "flash_tf32x3": 0,
            "ssm_scan": 0, "wkv6": 0, **want}
    if counts != full:
        raise AssertionError(f"{what} launches {counts}, expected {full}")


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
    expect(counts, "phase 4", ring_apply=300)
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
    kept = {"spec": spec, "clocks": clock_rows(res.trace.clock_log()),
            "time": res.runtime["simulated_time"],
            "curve": list(res.curve),
            "params": {k: v.cpu() for k, v in res.params.items()}}
    del res, cpu
    torch.cuda.empty_cache()
    return kept


def clock_rows(log):
    """A vector-clock log as comparable rows (update index, clock)."""
    return [(r.update_index, list(r.gradient_timestamps))
            for r in log.records]


def phase_legacy_paper_shape(dev, launches, compiled):
    """Phase 4's spec through the per-arrival host-PS loop."""
    import torch
    from repro_torch.experiments import execute
    from repro_torch.experiments.driver import per_arrival_grad
    spec = compiled["spec"]
    prob = spec.resolve_problem()
    steps = spec.resolved_steps()
    init = prob.init(dev)
    sim, secs, counts = counted(lambda: execute(
        spec.run, steps=steps, grad_fn=per_arrival_grad(prob.grad_fn),
        init_params=init, batch_fn=prob.batch_fn_for(spec.run.minibatch),
        eval_fn=prob.eval_fn, eval_every=spec.eval_every, engine="legacy",
        device=dev))
    launches["ps_apply"] += counts["ps_apply"]
    expect(counts, "phase 4b", ps_apply=steps)
    params_finite(sim.params, "phase 4b")
    errs = [h["test_error"] for h in sim.history]
    ref_errs = [c["test_error"] for c in compiled["curve"]]
    worst = max(float((sim.params[k].cpu() - compiled["params"][k])
                      .abs().max()) for k in sim.params)
    log(f"  test error per segment {errs} (updates "
        f"{[h['update'] for h in sim.history]}); {steps / secs:.1f} "
        f"updates/s ({secs:.3f} s, {sim.minibatches} arrivals, one "
        f"gradient each); ps_apply launches {counts['ps_apply']}")
    same_clocks = (clock_rows(sim.clock_log) == compiled["clocks"]
                   and sim.simulated_time == compiled["time"]
                   and [h["update"] for h in sim.history]
                   == [c["update"] for c in compiled["curve"]])
    log(f"  against phase 4's replay: vector clocks and simulated time "
        f"{'equal' if same_clocks else 'DIFFER'}; test error "
        f"{ref_errs}; max |legacy - replay| over the params = {worst}")
    if not same_clocks:
        raise AssertionError("phase 4b: clocks differ from phase 4's")
    # one gradient per cuBLAS call here, thirty per batched call there:
    # fp32 rounding compounded over 300 events, not bitwise
    if worst > 1e-5 or max(abs(a - b) for a, b in zip(errs, ref_errs)) \
            > 2 / 2048:
        raise AssertionError("phase 4b: legacy and replay runs disagree")
    del sim
    torch.cuda.empty_cache()


def wide_spec(dtype="fp32"):
    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec
    return ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=128,
                      minibatch=1, base_lr=0.01, optimizer="sgd", seed=5,
                      ring_dtype=dtype),
        problem="mlp_teacher", problem_args={"hidden": WIDE_HIDDEN},
        steps=8)


def phase_wide_lane(dev, launches):
    import torch
    from repro_torch.experiments.problems import get_problem
    # the initial weights are the reference's draw, made once per problem
    # on the host (data/threefry.py); made here, outside the timed runs
    t0 = time.perf_counter()
    get_problem("mlp_teacher", (("hidden", WIDE_HIDDEN),)).init("cpu")
    log(f"  initial weights (the reference's draw, host numpy, once per "
        f"process): {time.perf_counter() - t0:.3f} s")
    out = {}
    for dtype in ("fp32", "bf16"):
        spec = wide_spec(dtype)
        torch.cuda.reset_peak_memory_stats()
        res, secs, counts = drive(spec, dev)
        peak = torch.cuda.max_memory_allocated()
        launches["ring_apply"] += counts["ring_apply"]
        expect(counts, "phase 5", ring_apply=8)
        D = sum(v.numel() for v in res.params.values())
        if D != WIDE_D:
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
        if dtype == "fp32":
            out["params"] = {k: v.cpu() for k, v in res.params.items()}
            out["ms"] = secs / 8 * 1e3
        del res, plain
        torch.cuda.empty_cache()
    return out


def elastic_wide_spec():
    """Phase 5's fp32 spec with 8 PS shards (pull jitter 0.1: each slot's
    weights from 8 rows at per-shard timestamps) and learners 0–31 down
    from t = 1.2 s for 2.5 s (their slots cancelled in events 1–5)."""
    from repro_torch.membership import MembershipTimeline
    spec = wide_spec()
    return spec.replace(run=spec.run.replace(
        shards=8, shard_pull_jitter=0.1,
        membership=MembershipTimeline.crash_restart(range(32), 1.2, 2.5)))


def phase_elastic_sharded_wide_lane(dev, launches, wide_ms):
    """Phase 5c: the wide lane through the sharded ring (one ring_apply
    launch per event over the padded width 8 · 1 250 001) with masked
    coefficients; held bitwise against the plain versions on the card."""
    import torch
    spec = elastic_wide_spec()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, secs, counts = drive(spec, dev)
    peak = torch.cuda.max_memory_allocated()
    launches["ring_apply"] += counts["ring_apply"]
    expect(counts, "phase 5c", ring_apply=8)
    tr = res.trace
    masked = int((~tr.valid).any(axis=1).sum())
    if masked < 2:
        raise AssertionError(f"phase 5c: slots cancelled in {masked} events")
    D = sum(v.numel() for v in res.params.values())
    if D != WIDE_D:
        raise AssertionError(f"phase 5c: D = {D}")
    params_finite(res.params, "phase 5c")
    log(f"  S = 8 (width {8 * -(-D // 8)}), c = 128, K = "
        f"{res.staleness['ring_buffer_K']}; committed slots per event "
        f"{tr.valid.sum(axis=1).tolist()}: {secs / 8 * 1e3:.3f} ms/event "
        f"(phase 5 fp32: {wide_ms:.3f}; {secs:.3f} s incl. staging), peak "
        f"{peak / 2**30:.2f} GiB, test error {res.metrics['test_error']}, "
        f"ring_apply launches {counts['ring_apply']}")
    params = {k: v.cpu() for k, v in res.params.items()}
    del res
    torch.cuda.empty_cache()
    plain, psecs, _ = drive(spec.replace(
        run=spec.run.replace(ring_impl="fused")), dev)
    params_bitwise(params, {k: v.cpu() for k, v in plain.params.items()},
                   "phase 5c")
    log(f"    same run through the plain versions on the card: bitwise "
        f"equal; {psecs / 8 * 1e3:.3f} ms/event")
    del plain, params
    torch.cuda.empty_cache()


def phase_legacy_wide_lane(dev, launches, replayed):
    """Phase 5's fp32 spec through driver.run with engine="legacy"; held
    bitwise against the same loop through the pytree backend."""
    import torch
    from repro_torch.core import simulate
    from repro_torch.experiments.driver import per_arrival_grad
    spec = wide_spec().replace(engine="legacy")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, secs, counts = drive(spec, dev)
    peak = torch.cuda.max_memory_allocated()
    launches["ps_apply"] += counts["ps_apply"]
    expect(counts, "phase 5b", ps_apply=8)
    D = sum(v.numel() for v in res.params.values())
    if D != WIDE_D:
        raise AssertionError(f"phase 5b: D = {D}")
    params_finite(res.params, "phase 5b")
    log(f"  D = {D}, c = 128: {secs / 8 * 1e3:.3f} ms/update "
        f"({secs:.3f} s for 8 updates, {res.runtime['minibatches']} "
        f"arrivals), peak {peak / 2**30:.2f} GiB, test error "
        f"{res.metrics['test_error']}, ps_apply launches "
        f"{counts['ps_apply']}")
    params = {k: v.cpu() for k, v in res.params.items()}
    del res
    torch.cuda.empty_cache()
    prob = spec.resolve_problem()
    ref, rsecs, rcounts = counted(lambda: simulate(
        spec.run, steps=8, grad_fn=per_arrival_grad(prob.grad_fn),
        init_params=prob.init(dev), batch_fn=prob.batch_fn_for(1),
        ps_backend="reference", device=dev))
    expect(rcounts, "phase 5b (pytree backend)")
    params_bitwise(params, {k: v.cpu() for k, v in ref.params.items()},
                   "phase 5b: kernel vs pytree backend")
    worst = max(float((params[k] - replayed[k]).abs().max())
                for k in params)
    log(f"    same loop through the pytree backend (ps_backend="
        f"'reference') on the card: bitwise equal; {rsecs / 8 * 1e3:.3f} "
        f"ms/update; max |legacy - phase 5 replay| = {worst}")
    del ref, params
    torch.cuda.empty_cache()


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
    expect(counts, "phase 6", ring_apply_whatif=8)
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


def library_addmv(w, g, coef, lr, out=None):
    """The sgd / combine event as one PyTorch call: w − lr·(gᵀ coef) —
    the yardstick beside a kernel (the port never calls it)."""
    import torch
    return torch.addmv(w, g.t(), coef, alpha=-lr, out=out)


def time_library(fn, kern_w, reps):
    """(ms of one library call, max |library − kernel|)."""
    out = fn()
    diff = float((out - kern_w).abs().max())
    return cuda_ms(fn, reps), diff


def time_kernel(name, D, c, K, opt, dtype, mode, whatif, dev, reps,
                plain_reps, **pulls):
    """Time one ring kernel and its plain version at one shape (and, for an
    fp32 ring's sgd combine event, ``torch.addmv`` writing the slot row);
    hold one launch of each against the other first.  ``pulls``: the
    what-if slots' rows (``event_inputs``' n_rows, slot_pulled)."""
    import torch
    from repro_torch.optim import UpdateSpec
    spec = UpdateSpec(opt)
    ops = event_inputs(D, c, K, opt, dtype, whatif, 21, dev, **pulls)
    err = compare(ops, spec, mode, whatif, f"{name} at the path's shape")
    ms = cuda_ms(lambda: run_kernel(ops, spec, mode, whatif), reps)
    plain_ms = cuda_ms(lambda: run_plain(ops, spec, mode, whatif),
                       plain_reps)
    nbytes, nops = event_cost(ops, opt, mode, whatif)
    bms, by = bound_ms(nbytes, nops)
    lib_ms = None
    if not whatif and dtype == "fp32" and opt == "sgd" and \
            mode == "combine" and K > 1:
        ring = ops["ring"]
        kern = run_kernel(clone_state(ops), spec, mode, whatif)[0][1 % K]
        lib_ms, lib_diff = time_library(lambda: library_addmv(
            ring[0], ops["g"], ops["coef"], float(ops["lrs"][0]),
            out=ring[1 % K]), kern, reps)
        log(f"  torch.addmv into the slot row: {lib_ms:.4f} ms, "
            f"max |addmv - kernel| = {lib_diff}")
    ts = ops["idx"][2:].tolist()
    rows = (f", {len(set(ts))} distinct pulled rows in "
            f"{1 + sum(a != b for a, b in zip(ts, ts[1:]))} runs"
            if whatif else "")
    log(f"  {name:18s} {opt} {mode} {dtype} D={D} c={c} K={K}{rows}: "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms; bound {bms:.4f} ms by "
        f"{by}: {nbytes / 1e9:.3f} GB, {nops / 1e9:.3f} Gop; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s and "
        f"{nops / (ms * 1e-3) / 1e12:.2f} Top/s achieved, "
        f"{bms / ms:.3f} of the bound)")
    del ops
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err, "library_ms": lib_ms}


def time_ps(opt, mode, D, c, dev, reps, plain_reps):
    """Time ``ps_apply``, its plain version and (sgd / combine)
    ``torch.addmv`` at one shape; hold kernel and plain version first."""
    import torch
    from repro_torch.optim import UpdateSpec
    spec = UpdateSpec(opt)
    ops = ps_inputs(D, c, opt, 22, dev)
    err = ps_compare(ops, spec, mode, "ps_apply at the path's shape")
    ms = cuda_ms(lambda: ps_kernel(ops, spec, mode), reps)
    plain_ms = cuda_ms(lambda: ps_plain(ops, spec, mode), plain_reps)
    nbytes, nops = ps_cost(ops, opt, mode)
    bms, by = bound_ms(nbytes, nops)
    lib_ms = None
    if opt == "sgd" and mode == "combine":
        kern = ps_kernel(ops, spec, mode)[0]
        lib_ms, lib_diff = time_library(lambda: library_addmv(
            ops["w"], ops["g"], ops["coef"], float(ops["lrs"][0])), kern,
            reps)
        log(f"  torch.addmv: {lib_ms:.4f} ms, max |addmv - kernel| = "
            f"{lib_diff}")
    log(f"  ps_apply           {opt} {mode} fp32 D={D} c={c}: {ms:.4f} ms "
        f"(plain {plain_ms:.4f} ms; bound {bms:.4f} ms by {by}: "
        f"{nbytes / 1e9:.3f} GB, {nops / 1e9:.3f} Gop; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)")
    del ops
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CELLS = (   # (B, Sq, Sk, H, KV, D, causal, window, bkgsd entry)
    (2, 1000, 1000, 12, 2, 128, True, 0, False),
    (2, 1000, 1000, 12, 2, 128, True, 48, False),
    (2, 1000, 1000, 12, 2, 128, False, 0, False),
    (1, 1000, 777, 12, 2, 128, False, 0, True),
    (2, 1000, 1000, 8, 2, 64, True, 0, False),
    (2, 201, 777, 12, 2, 128, False, 0, False),
    (2, 1000, 1000, 32, 32, 112, True, 0, False),     # zamba2's attention
)


def flash_inputs(B, Sq, Sk, H, KV, D, dtype, seed, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    return randn(B, Sq, H, D), randn(B, Sk, KV, D), randn(B, Sk, KV, D)


def flash_pair(q, k, v, causal, window, bkgsd):
    """(kernel, plain version, v) on the same inputs, (B, KV, G, S, D) and
    (B, KV, Sk, D).  ``bkgsd``: through the (B, KV, G, S, D) entry on
    contiguous copies; otherwise through the model's (B, S, H, D) entry,
    which the kernels read through strides."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qb = q.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kb, vb = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    bq, bk = fa.kernel_tiles(Sq, k.shape[1], q.dtype)
    plain = fa.flash_attention_bkgsd_plain(qb, kb, vb, causal=causal,
                                           window=window, blk_q=bq, blk_k=bk)
    if bkgsd:
        kern = fa.flash_attention_bkgsd(
            qb.contiguous(), kb.contiguous(), vb.contiguous(), causal=causal,
            window=window)
    else:
        kern = fa.flash_attention(q, k, v, causal=causal, window=window)
        kern = kern.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    return kern, plain, vb


def flash_check(kern, plain, v, what):
    """Raise unless kernel and plain version agree (2e-5 absolute in fp32;
    in bf16 within the sm90 kernel's bound, see
    ``flash_attention.sm90_error_share``); returns (max |kernel − plain|,
    the share of the bf16 bound used or None)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    torch.cuda.synchronize()
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((kern.float() - plain.float()).abs().max())
    share = None
    if kern.dtype == torch.bfloat16:
        share = fa.sm90_error_share(kern, plain, v)
        if share > 1:
            raise AssertionError(f"{what}: beyond the bf16 bound (share "
                                 f"{share}, max |diff| {err})")
    elif err > 2e-5:
        raise AssertionError(f"{what}: max |kernel - plain| = {err}")
    return err, share


def phase_flash_vs_plain(dev) -> dict:
    """Every cell in fp32 and bf16; returns the worst error of each kernel
    by its row in the ``kernels`` line (``FLASH_ROWS``)."""
    import torch
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, Sq, Sk, H, KV, D, causal, window, bkgsd in FLASH_CELLS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(B, Sq, Sk, H, KV, D, dtype, 14, dev)
            what = (f"flash_attention B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
                    f"D={D} causal={causal} window={window} "
                    f"{str(dtype)[6:]}{' bkgsd' if bkgsd else ''}")
            err, share = flash_check(*flash_pair(q, k, v, causal, window,
                                                 bkgsd), what)
            worst[dtype] = max(worst[dtype], err)
            log(f"  {what}: max|kernel-plain| = {err}"
                + ("" if share is None else
                   f" ({share:.4f} of the bf16 bound)"))
    log(f"  flash worst: fp32 (3xTF32 kernel) {worst[torch.float32]}, "
        f"bf16 (sm90 kernel) {worst[torch.bfloat16]}")
    return {"flash_attention": worst[torch.bfloat16],
            "flash_attention_fp32": worst[torch.float32]}


def time_flash(dev, S, H=12, KV=2, D=128):
    """One causal attention layer at B 1: by default qwen2_1_5b's (KV 2,
    G 6, D 128; the prefill_32k shape at S = 32 768).  The sm90 kernel in
    bf16 and the 3×TF32 kernel in fp32, each beside its plain version on
    the same inputs, and ``scaled_dot_product_attention`` on the same
    operands in each dtype (the yardstick; in fp32 its memory-efficient
    backend on K/V expanded to H heads).  Bounds: the larger of bytes over
    the HBM rate and ``attention_cost``'s flops (the mask's live pairs, 4·D
    each) over the bf16 tensor-core rate, or, for the 3×TF32 kernel, three
    times those flops over the TF32 rate (its CUDA-core predecessor's bound,
    the flops at the fp32 rate, printed beside it).  Returns each kernel's
    numbers ({"sm90": row, "tf32x3": row}: the ``kernels`` line's rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, G = 1, H // KV
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(B, S, S, H, KV, D, dtype, 23, dev)
        kern, plain, vb = flash_pair(q, k, v, True, 0, False)
        err, share = flash_check(kern, plain, vb,
                                 f"flash_attention at S={S} {dtype}")
        del kern, plain
        torch.cuda.empty_cache()
        path = fa.kernel_path(dtype)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 3)
        bq, bk = fa.kernel_tiles(S, S, dtype)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bkgsd_plain(
            q.reshape(B, S, KV, G, D).permute(0, 2, 3, 1, 4),
            k.permute(0, 2, 1, 3), vb, causal=True, window=0, blk_q=bq,
            blk_k=bk), 1, warmup=0)
        nbytes, flops = fa.attention_cost(B, H, KV, S, S, D, True, 0,
                                          itemsize=q.element_size())
        # the tensor-core work: bf16 once, 3×TF32 three times the flops
        work, peak = ((flops, PEAK_BF16_FLOPS) if dtype == torch.bfloat16
                      else (3 * flops, PEAK_TF32_FLOPS))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = work / peak * 1e3
        bms, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": by, "max_abs_err": err, "flops": flops,
               "work": work, "peak": peak, "nbytes": nbytes, "share": share}
        if dtype == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
            row["lib_diff"] = float((sdpa.float() - fa.flash_attention(
                q, k, v, causal=True).float()).abs().max())
            del sdpa
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 3)
            del qt, kt, vt
        else:
            # fp32: the memory-efficient backend (flash takes no fp32, and
            # the math backend would hold the S × S scores), K/V heads
            # expanded to H beforehand (it takes no GQA); the expansion is
            # not timed
            from torch.nn.attention import SDPBackend, sdpa_kernel
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                      for t in (k, v))
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                sdpa = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True).transpose(1, 2)
                row["lib_diff"] = float((sdpa - fa.flash_attention(
                    q, k, v, causal=True)).abs().max())
                del sdpa
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), 3)
            del qt, kt, vt
        res[path] = row
        del q, k, v, vb
        torch.cuda.empty_cache()
    for path, name in (("sm90", "bf16, sm90 kernel"),
                       ("tf32x3", "fp32, 3xTF32 kernel")):
        r = res[path]
        rate = r["work"] / (r["ms"] * 1e-3) / 1e12
        extra = (f" = {r['share']:.4f} of the bf16 bound"
                 if r["share"] is not None else "")
        if path == "tf32x3":
            extra += (f"; the CUDA-core bound (the flops at "
                      f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32) "
                      f"{r['flops'] / PEAK_FP32_FLOPS * 1e3:.4f} ms")
        log(f"  flash_attention B={B} S={S} H={H} KV={KV} D={D} causal "
            f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms; "
            f"scaled_dot_product_attention "
            f"{'bf16' if path == 'sm90' else 'fp32'} "
            f"{r['library_ms']:.4f} ms, kernel/library "
            f"{r['ms'] / r['library_ms']:.3f}x; bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}: {r['nbytes'] / 1e6:.1f} MB, "
            f"{r['flops'] / 1e12:.4f} Tflop of the mask's live pairs"
            f"{'' if path == 'sm90' else ' x 3 products'} at "
            f"{r['peak'] / 1e12:.0f} TFLOP/s; {rate:.2f} TFLOP/s of "
            f"tensor-core work achieved, "
            f"{r['flops'] / (r['ms'] * 1e-3) / 1e12:.2f} TFLOP/s of the "
            f"mask's, {r['bound_ms'] / r['ms']:.3f} of the bound; max "
            f"|kernel - plain| {r['max_abs_err']}{extra}; max |sdpa - "
            f"kernel| {r['lib_diff']})")
    return res


# ---------------------------------------------------------------------------
# the scan kernels: ssm_scan and wkv6
# ---------------------------------------------------------------------------
SSM_HEAD = dict(H=112, P=64, N=64, chunk=256)   # zamba2_7b's mamba layer
WKV_HEAD = dict(H=64, P=64, chunk=32)           # rwkv6_7b's rwkv layer
WKV_KERNELS = ("wkv_group_kernel", "wkv_pass_kernel", "wkv_out_kernel")


def decay_span(a, chunk) -> float:
    """The largest |cumulative log decay| within one chunk (a ≤ 0 along
    dim 1, so the chunk's total)."""
    import torch
    S = a.shape[1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    x = torch.nn.functional.pad(a.double(),
                                (0, 0) * (a.dim() - 2) + (0, nc * Q - S))
    return float(-x.reshape(a.shape[0], nc, Q, *a.shape[2:]).sum(2).min())


def scan_check(got, want, span, what):
    """Raise unless max |got − want| ≤ (1e-5 + 2⁻²⁰·span)·max |want|:
    fp32 sums in another order with FMAs, plus eight fp32 ulps of the
    largest cumulative log decay of a chunk (``span``), whose rounding
    every decay term exp(cum_i − cum_j) of a chunked scan inherits in both
    versions; returns (max |got − want|, its share of that limit)."""
    import torch
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((got - want).abs().max())
    lim = (1e-5 + 2.0 ** -20 * span) * float(want.abs().max())
    if err > lim:
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > {lim}")
    return err, err / lim


def ssm_inputs(B, S, H, P, N, bc_dtype, seed, dev):
    """The mamba block's scan operands at zamba2's decay: dt in [1e-3, 0.1]
    (softplus of dt_bias spans it), A = −(1…H) (A_log = log(1…H)), x·dt,
    and B, C as column slices of one (B, S, 2N) tensor in ``bc_dtype``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.rand(B, S, H, generator=gen, device=dev) * 0.099 + 1e-3
    x = torch.randn(B, S, H, P, generator=gen, device=dev) * dt[..., None]
    a = dt * -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
    bc = torch.randn(B, S, 2 * N, generator=gen, device=dev).to(bc_dtype)
    return x, a, bc[..., :N], bc[..., N:]


def wkv_inputs(B, S, H, P, dtype, strong, seed, dev):
    """The rwkv block's WKV operands: r, k, v in ``dtype``; w = −exp(z),
    z ~ N(−6, 0.5²) (decay_w0 = −6 and the LoRA's spread) or, ``strong``,
    z ~ N(2.5, 0.5²) (a chunk's decay sums past −88: exp of the pair term's
    argument for j ≥ i overflows); u ~ 0.1·N(0, 1) (bonus_u's init)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    r, k, v = (randn(B, S, H, P).mul(0.5).to(dtype) for _ in range(3))
    w = -torch.exp(randn(B, S, H, P) * 0.5 + (2.5 if strong else -6.0))
    return r, k, v, w, randn(H, P) * 0.1


# decay spans of a chunk around the factored pair term's limit
# (wkv6.FACTOR_SPAN, 60): well inside it, just under and just over
WKV_EDGE_SPANS = (20.0, 30.0, 40.0, 50.0, 58.0, 59.9, 60.1)


def chunk_sums(w, chunk):
    """w (B, S, H, P) in fp64 as (B, nc, Q, H, P) chunks, zero past S."""
    import torch
    Bt, S, H, P = w.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    x = torch.nn.functional.pad(w.double(), (0, 0, 0, 0, 0, nc * Q - S))
    return x.reshape(Bt, nc, Q, H, P)


def pair_forms(w, chunk, what):
    """Log how many (b, h, chunk) blocks of the log decay ``w`` take the
    kernel's factored pair term (the chunk's largest decay span over its
    channels at most ``wkv6.FACTOR_SPAN``) and how many the direct one;
    require both."""
    from repro_torch.kernels import wkv6 as wk
    span = -chunk_sums(w, chunk).sum(2).amin(-1)   # (B, nc, H)
    n_fac = int((span <= wk.FACTOR_SPAN).sum())
    log(f"  {what}: {n_fac} (b, h, chunk) blocks take the factored pair "
        f"term, {span.numel() - n_fac} the direct one")
    if not 0 < n_fac < span.numel():
        raise AssertionError(f"the {what} does not take both forms")


def wkv_mixed(ops, chunk, seed):
    """``ops`` (``wkv_inputs`` at the model's decay) with the strong decay
    in every odd chunk, so the kernel's pair term takes both forms in one
    call."""
    import torch
    r, k, v, w, u = ops
    Bt, S, H, P = w.shape
    strong = wkv_inputs(Bt, S, H, P, torch.float32, True, seed, w.device)[3]
    odd = (torch.arange(S, device=w.device) // chunk) % 2 == 1
    w = torch.where(odd[None, :, None, None], strong, w)
    pair_forms(w, chunk, "mixed decay")
    return r, k, v, w, u


def wkv_edge(ops, chunk):
    """``ops`` with w scaled per (b, chunk, h) so that the chunk's decay
    span is one of ``WKV_EDGE_SPANS``, in turn along b + chunk + h: the
    factored pair term's factors reach e^±29, and the blocks just over the
    limit take the direct form in the same call."""
    import torch
    r, k, v, w, u = ops
    Bt, S, H, P = w.shape
    x = chunk_sums(w, chunk)
    nc = x.shape[1]
    span = -x.sum(2).amin(-1)                        # (B, nc, H)
    ar = functools.partial(torch.arange, device=w.device)
    turn = (ar(Bt)[:, None, None] + ar(nc)[None, :, None]
            + ar(H)[None, None, :]) % len(WKV_EDGE_SPANS)
    want = torch.tensor(WKV_EDGE_SPANS, dtype=torch.float64,
                        device=w.device)[turn]
    x = x * (want / span)[:, :, None, :, None]
    w = x.reshape(Bt, -1, H, P)[:, :S].float()
    pair_forms(w, chunk, "edge decay")
    return r, k, v, w, u


def held_pair(kern, plain, ops, chunk, a, what):
    """Kernel and plain version of a scan on the same operands (``a``: the
    log decay), held for the output and the final state; returns (max
    |kernel − plain| over both, the larger share of its limit), and logs
    both."""
    y, st = kern(*ops, chunk=chunk)
    py, pst = plain(*ops, chunk=chunk)
    span = decay_span(a, chunk)
    (ey, ry), (es, rs) = (scan_check(y, py, span, f"{what} output"),
                          scan_check(st, pst, span, f"{what} state"))
    log(f"  {what}: max|kernel-plain| = {ey} output ({ry:.3f} of the "
        f"limit, max |plain| {float(py.abs().max()):.4g}), {es} state "
        f"({rs:.3f}); largest chunk decay {span:.1f}")
    return max(ey, es), max(ry, rs)


def ssm_pair(ops, chunk, what):
    from repro_torch.kernels import ssm_scan as sk
    return held_pair(sk.ssm_scan, sk.ssm_scan_plain, ops, chunk, ops[1],
                     what)


def wkv_pair(ops, chunk, what):
    from repro_torch.kernels import wkv6 as wk
    return held_pair(wk.wkv6, wk.wkv6_plain, ops, chunk, ops[3], what)


def phase_scans_vs_plain(dev) -> dict:
    """``ssm_scan`` at zamba2's mamba head and ``wkv6`` at rwkv6's, B 2 and
    a ragged S = 1 000, B/C (r/k/v) in bf16 as the bf16 models pass them
    and in fp32 as the fp32 ones do; wkv6 also at a decay whose exp above
    the diagonal overflows."""
    import torch
    worst = {"ssm_scan": 0.0, "wkv6": 0.0}
    h = SSM_HEAD
    for dt in (torch.bfloat16, torch.float32):
        ops = ssm_inputs(2, 1000, h["H"], h["P"], h["N"], dt, 15, dev)
        what = (f"ssm_scan B=2 S=1000 H={h['H']} P={h['P']} N={h['N']} "
                f"chunk={h['chunk']} B/C {str(dt)[6:]}")
        err, _ = ssm_pair(ops, h["chunk"], what)
        worst["ssm_scan"] = max(worst["ssm_scan"], err)
    from repro_torch.kernels.ssm_scan import HEAD_DIMS, STATE_DIMS
    cells = [(N, P) for N in STATE_DIMS for P in HEAD_DIMS]
    for k, (N, P) in enumerate(cells):
        chunk, dt = (64, 128, 256)[k % 3], (torch.bfloat16,
                                             torch.float32)[k % 2]
        ops = ssm_inputs(2, 333, 4, P, N, dt, 30 + k, dev)
        err, _ = ssm_pair(ops, chunk, f"ssm_scan B=2 S=333 H=4 P={P} N={N} "
                                      f"chunk={chunk} B/C {str(dt)[6:]}")
        worst["ssm_scan"] = max(worst["ssm_scan"], err)
    h = WKV_HEAD
    for dt in (torch.bfloat16, torch.float32):
        for strong in (False, True):
            ops = wkv_inputs(2, 1000, h["H"], h["P"], dt, strong, 16, dev)
            what = (f"wkv6 B=2 S=1000 H={h['H']} P={h['P']} "
                    f"chunk={h['chunk']} r/k/v {str(dt)[6:]} "
                    f"{'strong' if strong else 'model'} decay")
            err, _ = wkv_pair(ops, h["chunk"], what)
            worst["wkv6"] = max(worst["wkv6"], err)
    # groups of chunks: S = 2 000 crosses three group edges and ends in a
    # ragged group; odd chunks strong, even ones the model's decay; then
    # chunk spans of 20 to 60.1, across the factored form's limit
    base = wkv_inputs(2, 2000, h["H"], h["P"], torch.bfloat16, False, 17, dev)
    for name, ops in (("mixed", wkv_mixed(base, h["chunk"], 18)),
                      ("edge", wkv_edge(base, h["chunk"]))):
        err, _ = wkv_pair(ops, h["chunk"], f"wkv6 B=2 S=2000 H={h['H']} "
                          f"P={h['P']} chunk={h['chunk']} r/k/v bfloat16 "
                          f"{name} decay")
        worst["wkv6"] = max(worst["wkv6"], err)
    return worst


def chunk_rows(S, Q):
    """The row counts of the chunks of a length-S scan."""
    return [min(Q, S - c) for c in range(0, S, Q)]


def ssm_cost(B, S, H, P, N, Q, bc_bytes):
    """(bytes, fp32 ops) of one ``ssm_scan``: x, a, B and C read once, y and
    the state written once.  Per (b, chunk of q rows, T = q(q+1)/2 pairs
    j ≤ i): C·Bᵀ once (B and C are shared by the heads), 2TN; per head the
    decay (a difference, an exp and a product per pair), the decayed
    product 2TP, the inter-chunk term 2qNP + qP + q, the state update
    2qNP + qP + q + NP and the cumulative sum q."""
    ops = 0
    for q in chunk_rows(S, Q):
        T = q * (q + 1) // 2
        ops += 2 * T * N + H * (3 * T + 2 * T * P + 4 * q * N * P
                                + 2 * q * P + 3 * q + N * P)
    nbytes = 8 * B * S * H * P + 4 * B * S * H + 2 * B * S * N * bc_bytes \
        + 4 * B * H * N * P
    return nbytes, B * ops


def wkv_cost(B, S, H, P, Q, rkv_bytes):
    """(bytes, fp32 ops) of one ``wkv6``: r, k, v, w and u read once, out
    and the state written once.  Per (b, h, chunk of q rows): the
    cumulative sums and their differences 2qP, r·exp(cum⁻) 2qP, the pair
    term q(q−1)/2·P × (difference, exp, two products, sum), the bonus 3qP,
    the inter-chunk term 2qP², the pair and bonus terms against v
    q(q+1)·P, the state decay P + P², k·exp(cum_Q − cum) 3qP and the state
    update 2qP²."""
    ops = 0
    for q in chunk_rows(S, Q):
        ops += (10 * q * P + 5 * P * q * (q - 1) // 2 + 4 * q * P * P
                + P * q * (q + 1) + P + P * P)
    nbytes = (3 * rkv_bytes + 8) * B * S * H * P + 4 * H * P \
        + 4 * B * H * P * P
    return nbytes, B * H * ops


def wkv_kernel_ops(B, S, H, P, Q, G):
    """fp32 operations the staged ``wkv6`` kernels do at the model's decay
    (the factored pair term), beside ``wkv_cost``'s count of the chunked
    closed form, which stays the bound: per (b, h, chunk of q rows) the
    group kernel's cumulative sum, k·exp(cum_Q − cum) and state update
    (qP + 3qP + 2qP² + P²); the out kernel's cumulative sum and operands
    (qP + 7qP), bonus 3qP, (r∘exp(cum⁻))·S 2qP², the pair term as a
    q × q × P product 2q²P, A·v 2q²P and, but for a group's last chunk,
    the state update again (2qP² + P²); the pass over the groups 2P² a
    group."""
    rows = chunk_rows(S, Q)
    ops = 0
    for c, q in enumerate(rows):
        ops += 4 * q * P + 2 * q * P * P + P * P
        ops += 11 * q * P + 2 * q * P * P + 4 * q * q * P
        if (c + 1) % G and c + 1 < len(rows):
            ops += 2 * q * P * P + P * P
    return B * H * (ops + 2 * P * P * -(-len(rows) // G))


def scan_bound(nbytes, nops):
    """The larger of bytes over HBM rate and fp32 operations over the CUDA
    cores' fp32 rate (FMAs allowed), and which one bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def short_name(kernel: str) -> str:
    """A profiler kernel name without its namespace and template list."""
    m = re.search(r"::(\w+)", kernel) or re.search(r"(\w+)", kernel)
    return m[1] if m else kernel


def kernel_split(fn, reps=3):
    """{kernel name: ms per call} of ``fn``'s device kernels over ``reps``
    calls, from ``torch.profiler`` (the split of a call that launches
    several kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            out[ev.key] = us / 1e3 / reps
    return out


def time_scan(name, ops, chunk, cost, dev):
    """Per-launch time of ``ssm_scan`` / ``wkv6`` at the prefill shape
    beside its plain version and its bound (no PyTorch call computes
    either function: library_ms is None); holds kernel and plain version
    first."""
    import torch
    from repro_torch.kernels import ssm_scan as sk
    from repro_torch.kernels import wkv6 as wk
    kern, plain, pair = ((sk.ssm_scan, sk.ssm_scan_plain, ssm_pair)
                         if name == "ssm_scan"
                         else (wk.wkv6, wk.wkv6_plain, wkv_pair))
    err, _ = pair(ops, chunk, f"{name} at the prefill shape")
    ms = cuda_ms(lambda: kern(*ops, chunk=chunk), 5)
    plain_ms = cuda_ms(lambda: plain(*ops, chunk=chunk), 2)
    nbytes, nops = cost
    bms, by = scan_bound(nbytes, nops)
    log(f"  {name} B=1 S={ops[0].shape[1]} {tuple(ops[0].shape[2:])} "
        f"chunk={chunk}: {ms:.4f} ms (plain {plain_ms:.4f} ms; bound "
        f"{bms:.4f} ms by {by}: {nbytes / 1e9:.3f} GB, {nops / 1e9:.3f} "
        f"Gflop at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32; "
        f"{nops / (ms * 1e-3) / 1e12:.2f} TFLOP/s and "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved, "
        f"{bms / ms:.3f} of the bound)")
    # several kernels per call: where its time goes
    split = kernel_split(lambda: kern(*ops, chunk=chunk))
    log("    per call, by kernel (torch.profiler): " + "; ".join(
        f"{short_name(k)} {v:.4f} ms"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    if name == "wkv6":
        wkv_details(ops, chunk, ms, dev)
    del ops
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err, "library_ms": None}


def wkv_details(ops, chunk, ms, dev):
    """Phase 7 for ``wkv6`` beyond its time at the model's decay: the
    scratch, the kernels' own operation count beside the bound's, and the
    time at the same shape with every chunk's pair term in the direct form
    (the strong decay) and with half of them (the mixed decay), each held
    first and split by kernel."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    Bt, S, H, P = ops[0].shape
    Q = min(chunk, S)
    scratch = sum(4 * math.prod(sh) for sh in wk.scratch_shapes(Bt, S, H, P,
                                                                  Q))
    kops = wkv_kernel_ops(Bt, S, H, P, Q, wk.GROUP)
    log(f"    scratch {scratch / 1e6:.2f} MB (group states and decays, G = "
        f"{wk.GROUP}); the kernels' own fp32 ops {kops / 1e9:.3f} G "
        f"({kops / (ms * 1e-3) / 1e12:.2f} TFLOP/s)")
    strong = wkv_inputs(Bt, S, H, P, ops[0].dtype, True, 27, dev)
    for name, o in (("strong", strong), ("mixed", wkv_mixed(ops, chunk, 28))):
        wkv_pair(o, chunk, f"wkv6 at the prefill shape, {name} decay")
        t = cuda_ms(lambda: wk.wkv6(*o, chunk=chunk), 5)
        split = kernel_split(lambda: wk.wkv6(*o, chunk=chunk))
        log(f"    {name} decay: {t:.4f} ms ({t / ms:.2f}x the model "
            f"decay's); by kernel: " + "; ".join(
                f"{short_name(k)} {v:.4f} ms"
                for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    del strong
    torch.cuda.empty_cache()


def time_scans(dev):
    """Both scan kernels at one layer of their model's prefill: B 1,
    S 8 192, bf16 operands as the bf16 models pass them."""
    import torch
    S, h = 8192, SSM_HEAD
    t_ssm = time_scan("ssm_scan", ssm_inputs(1, S, h["H"], h["P"], h["N"],
                                             torch.bfloat16, 24, dev),
                      h["chunk"], ssm_cost(1, S, h["H"], h["P"], h["N"],
                                           h["chunk"], 2), dev)
    h = WKV_HEAD
    t_wkv = time_scan("wkv6", wkv_inputs(1, S, h["H"], h["P"],
                                         torch.bfloat16, False, 25, dev),
                      h["chunk"], wkv_cost(1, S, h["H"], h["P"], h["chunk"],
                                           2), dev)
    return t_ssm, t_wkv


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
# The serving phases: (phase, architecture, fp32 prefill-vs-decode limit).
# qwen2_1_5b's 28 layers hold 1e-3.  zamba2_7b's 81 layers of random
# weights amplify fp32 rounding differences more (its mamba decode is the
# step-by-step recurrence, its prefill the chunked scan), so 1e-2 there —
# still orders of magnitude under what a state that does not advance, a
# wrong decay or a cache written in the wrong unit gives.
SERVING = ((8, "qwen2_1_5b", 1e-3), (9, "zamba2_7b", 1e-2),
           (10, "rwkv6_7b", 1e-3))


def tree_to(tree, dtype):
    """A copy of a nested dict of tensors in ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def expected_params(cfg) -> int:
    """The port's parameter count from ``ModelConfig.param_count``, which
    counts the unpadded vocab (embedding and head), no final norm, two
    norms and no convolution biases per mamba block (the tree has one norm
    and Din + 2N biases), and seven d_model vectors per rwkv block (the
    tree has eight: five token-shift mixes, mu_ck, decay_w0, ln_x_scale)."""
    M = cfg.d_model
    per_unit = 0
    for b in cfg.block_pattern:
        if b == "mamba":
            per_unit += cfg.ssm_d_inner + 2 * cfg.ssm_state - M
        elif b == "rwkv":
            per_unit += M
    return (cfg.param_count() + 2 * (cfg.padded_vocab - cfg.vocab_size) * M
            + M + cfg.n_units * per_unit)


def forward_launches(cfg) -> dict:
    """Kernel launches of one prefill forward: one flash_attention per
    attention layer (zamba2's shared ones too) — all through the sm90
    kernel in bf16, the 3×TF32 one in fp32 —, one ssm_scan per mamba
    layer, one wkv6 per rwkv layer."""
    def n(*types):
        return cfg.n_units * sum(b in types for b in cfg.block_pattern)
    attn = n("attn", "shared_attn")
    bf16 = cfg.dtype == "bfloat16"
    return {"flash_attention": attn, "flash_sm90": attn if bf16 else 0,
            "flash_tf32x3": 0 if bf16 else attn,
            "ssm_scan": n("mamba"), "wkv6": n("rwkv")}


def add_launches(launches, counts):
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def consistency(cfg, params, toks, launches, dev, label, phase):
    """prefill_step (the kernels) against the decode-replay prefill and
    against ``attn_impl="naive", use_pallas=False`` (plain attention and
    plain scans) on the same prompt; returns the max |diff| of each over
    the live vocab."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.serve.engine import (init_serve_state, prefill,
                                          prefill_step)
    run = RunConfig(attn_impl="pallas", use_pallas=True)
    B, S = toks.shape
    full, _, counts = counted(lambda: prefill_step(cfg, run, params,
                                                   {"tokens": toks}))
    add_launches(launches, counts)
    expect(counts, f"phase {phase} consistency {label}",
           **forward_launches(cfg))
    (dec, _), dsecs, counts = counted(lambda: prefill(
        cfg, run, params, {"tokens": toks},
        init_serve_state(cfg, B, S, device=dev)))
    expect(counts, f"phase {phase} decode replay {label}")
    naive = prefill_step(cfg, RunConfig(attn_impl="naive"), params,
                         {"tokens": toks})
    v = cfg.vocab_size
    full, dec, naive = full[..., :v], dec[..., :v], naive[..., :v]
    for x in (full, dec, naive):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"phase {phase} {label}: non-finite logits")
    out = {"decode": float((full - dec).abs().max()),
           "naive": float((full - naive).abs().max())}
    same = float((full.argmax(-1) == dec.argmax(-1)).float().mean())
    log(f"  {label}, B={B} S={S}: max |prefill_step - decode-replay "
        f"prefill| = {out['decode']}, max |kernels - plain versions| = "
        f"{out['naive']} (logits span {float(full.min()):.3f} to "
        f"{float(full.max()):.3f}); greedy tokens equal at {same:.4f} of "
        f"positions; decode replay {S / dsecs:.1f} steps/s")
    return out


def phase_serving(phase, arch, fp32_limit, dev, launches):
    """One architecture at full width and depth through the serving
    engine."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_model
    from repro_torch.serve.engine import generate, prefill_step
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    cfg = get_config(arch)
    run = RunConfig(attn_impl="pallas", use_pallas=True)
    per_forward = forward_launches(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n = count_params(params)
    if n != expected_params(cfg):
        raise AssertionError(f"phase {phase}: {n} parameters, expected "
                             f"{expected_params(cfg)}")
    log(f"  {cfg.name}: {cfg.n_layers} layers {cfg.block_pattern} x "
        f"{cfg.n_units}, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab} (padded), {cfg.dtype}: {n} parameters "
        f"(ModelConfig.param_count {cfg.param_count()} + "
        f"{n - cfg.param_count()}: the vocab padding, the final norm and the "
        f"leaves it does not count, see expected_params), drawn in "
        f"{time.perf_counter() - t0:.2f} s; kernel launches per prefill "
        f"forward {per_forward}")

    def tokens(B, S):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev, dtype=torch.int32)

    # 1. prefill: one 8 192-token prompt (after a short warm-up prompt)
    prefill_step(cfg, run, params, {"tokens": tokens(1, 256)})
    prompt = tokens(1, 8192)
    for rep in range(2):
        logits, secs, counts = counted(lambda: prefill_step(
            cfg, run, params, {"tokens": prompt}))
        add_launches(launches, counts)
        expect(counts, f"phase {phase} prefill", **per_forward)
        if tuple(logits.shape) != (1, 8192, cfg.padded_vocab) or not bool(
                torch.isfinite(logits[..., :cfg.vocab_size]).all()):
            raise AssertionError(f"phase {phase}: bad prefill logits")
        log(f"  prefill_step B=1 S=8192 (run {rep + 1}): {secs:.4f} s, "
            f"{8192 / secs:.1f} tokens/s; launches "
            f"{ {k: v for k, v in counts.items() if v} }; logits finite, "
            f"{tuple(logits.shape)}")
        del logits
    torch.cuda.empty_cache()

    # 2. prefill vs decode replay vs the plain versions, B = 2, S = 64: in
    # bf16 as configured (reported), and on the same weights in fp32, held
    toks = tokens(2, 64)
    d = consistency(cfg, params, toks, launches, dev, "bf16", phase)
    log(f"    bf16 at {cfg.n_layers} layers is not held to the 2-layer "
        f"reference's 7e-2: the kernels and the plain versions inside one "
        f"forward differ by {d['naive']} there (rounding order alone), the "
        f"decode replay by {d['decode']}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_to(params, torch.float32)
    d = consistency(cfg32, params32, toks, launches, dev, "fp32", phase)
    if d["decode"] > fp32_limit or d["naive"] > fp32_limit:
        raise AssertionError(f"phase {phase}: fp32 prefill and decode "
                             f"logits disagree ({d}; limit {fp32_limit})")
    del params32
    torch.cuda.empty_cache()

    # 3. greedy generation: B 4, 16 prompt tokens, 32 new
    prompt = tokens(4, 16)
    out, gsecs, counts = counted(lambda: generate(cfg, run, params, prompt,
                                                  32))
    expect(counts, f"phase {phase} generate")
    if tuple(out.shape) != (4, 32) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"phase {phase}: bad generated tokens")
    log(f"  generate B=4, 16 + 32 tokens: {gsecs:.3f} s for 48 decode "
        f"steps, {4 * 48 / gsecs:.1f} tokens/s decoded ({4 * 32 / gsecs:.1f}"
        f" new tokens/s); first row {out[0, :8].tolist()}")

    # 4. continuous batching: 6 requests into 4 slots
    def serve_batch():
        eng = ContinuousBatchingEngine(cfg, run, params, max_batch=4,
                                       max_len=64)
        rids = [eng.submit(list(range(2 + i, 10 + i)), max_new_tokens=8)
                for i in range(6)]
        return rids, eng.run_until_done()
    (rids, done), csecs, counts = counted(serve_batch)
    expect(counts, f"phase {phase} continuous batching")
    if set(done) != set(rids) or any(
            not done[r].done or len(done[r].generated) != 8 for r in rids):
        raise AssertionError(f"phase {phase}: a request did not complete")
    log(f"  ContinuousBatchingEngine: 6 requests in 4 slots, 8 new tokens "
        f"each, all complete in {csecs:.3f} s ({48 / csecs:.1f} new "
        f"tokens/s incl. the batch-1 prefills)")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the paper cells
# ---------------------------------------------------------------------------
# Phase 11 holds each record's metrics twice.  Against the same cell run
# through the plain versions on the CPU: within two of the 2 048 test
# samples, as phase 4 holds the card against the CPU (on the CPU the port
# gives the reference's metrics exactly, tests/test_torch_campaign.py).
# Against the reference's committed envelopes: within 37 of 2 048, since
# the envelopes were written by an older reference, which the reference as
# it stands misses by up to 35 samples (0.01709 test error, 0.01465
# serving accuracy; ``python tests/test_torch_campaign.py``), plus the
# same two samples.
CARD_VS_CPU_TOL = 2 / 2048
ENVELOPE_TOL = 37 / 2048
CELL_METRICS = ("test_error", "serving_accuracy")
SCHEDULE_KEYS = ("simulated_time", "updates", "minibatches")
# Envelope records whose replay_path predates today's campaign: the
# committed elastic envelope batched hardsync_b0/seed=2 with its group,
# while the campaign's fixed checkpoint slices of 8 specs now leave it
# alone in the second slice, so it replays sequentially.
STALE_REPLAY_PATH = {("elastic", "hardsync_b0/seed=2"): "sequential"}
SERVING_KEYS = ("n_requests", "n_served", "n_refreshes", "staleness_mean",
                "staleness_max")


def reference_address(echo) -> str:
    """The JAX package's ``spec_hash`` of a record's spec echo: the port's
    hashed payload without its backend marker (``spec_hash.BACKEND``)."""
    from repro_torch.experiments.result import SCHEMA_VERSION
    from repro_torch.experiments.spec_hash import (canonical_echo,
                                                   content_hash,
                                                   problem_identity)
    return content_hash({"schema": SCHEMA_VERSION,
                         "problem": problem_identity(echo.get("problem")),
                         "spec": canonical_echo(echo)})


def schedule_side(rec):
    side = {k: rec["runtime"][k] for k in SCHEDULE_KEYS}
    side["staleness"] = rec["staleness"]
    if "serving" in rec["runtime"]:
        side["serving"] = {k: rec["runtime"]["serving"][k]
                           for k in SERVING_KEYS}
    return side


def phase_cells(dev, launches):
    """Phase 11: the elastic, topology and serve cells through
    ``campaign.run_cell`` at their default params, each record held
    against the reference's committed envelope."""
    import tempfile
    from repro_torch.experiments import campaign, registry
    out = {}
    with tempfile.TemporaryDirectory(prefix="results_torch_") as tmp:
        for name in ("elastic", "topology", "serve"):
            cell = registry.get_cell(name)
            ref = json.loads((ROOT / "benchmarks" / "results"
                              / f"{cell.result}.json").read_text())
            by_address = {r["spec_hash"]: r for r in ref["records"]}
            card_dir, cpu_dir = (Path(tmp) / name / d for d in ("card",
                                                                 "cpu"))
            derived, secs, counts = counted(lambda: campaign.run_cell(
                name, results_dir=str(card_dir), device=dev))
            env = registry.load_envelope(cell, str(card_dir))
            cpu_metrics, cpu_paths, cpu_secs = {}, {}, None
            if name != "topology":          # topology's records: measure
                t0 = time.perf_counter()
                campaign.run_cell(name, results_dir=str(cpu_dir),
                                  device="cpu")
                cpu_secs = time.perf_counter() - t0
                cpu_recs = registry.load_envelope(cell,
                                                  str(cpu_dir))["records"]
                cpu_metrics = {r["spec_hash"]: r["metrics"] for r in cpu_recs}
                cpu_paths = {r["spec_hash"]: r["runtime"]["replay_path"]
                             for r in cpu_recs}
            claims = env["campaign"]["claims"]
            failed = sorted(k for k, c in claims.items() if not c["ok"])
            if failed:
                raise AssertionError(f"phase 11 {name}: claims {failed}")
            events = 0
            worst = {k: 0.0 for k in CELL_METRICS}      # against envelope
            worst_cpu = {k: 0.0 for k in CELL_METRICS}  # against the CPU
            for rec in env["records"]:
                tag = rec["spec"]["tag"]
                want = by_address[reference_address(rec["spec"])]
                if schedule_side(rec) != schedule_side(want):
                    raise AssertionError(f"phase 11 {name} {tag}: schedule "
                                         f"side differs from the envelope")
                path = rec["runtime"]["replay_path"]
                want_path = STALE_REPLAY_PATH.get(
                    (name, tag), want["runtime"]["replay_path"])
                if path != want_path or path != cpu_paths.get(
                        rec["spec_hash"], path):
                    raise AssertionError(
                        f"phase 11 {name} {tag}: replay_path {path}, "
                        f"expected {want_path} (the envelope's "
                        f"{want['runtime']['replay_path']}), the CPU run's "
                        f"{cpu_paths.get(rec['spec_hash'])}")
                for k in CELL_METRICS:
                    if k in want["metrics"]:
                        worst[k] = max(worst[k], abs(rec["metrics"][k]
                                                     - want["metrics"][k]))
                        worst_cpu[k] = max(worst_cpu[k], abs(
                            rec["metrics"][k]
                            - cpu_metrics[rec["spec_hash"]][k]))
                if rec["runtime"]["replay_path"] != "measure":
                    events += rec["runtime"]["updates"]
            if name == "topology":   # its derive times 2 + 2 replays
                events += 4 * derived["engine_overhead_cell"]["updates"]
            launches["ring_apply"] += counts["ring_apply"]
            expect(counts, f"phase 11 {name}", ring_apply=events)
            paths = {}
            for r in env["records"]:
                p = r["runtime"]["replay_path"]
                paths[p] = paths.get(p, 0) + 1
            log(f"  {name}: {len(env['records'])} records ({paths}), every "
                f"record's schedule side equal to the envelope's; claims "
                f"ok {sorted(claims)}; ring_apply launches "
                f"{counts['ring_apply']} (reckoned {events}); {secs:.1f} s, "
                f"{counts['ring_apply'] / secs:.1f} events/s")
            if cpu_secs is not None:
                log(f"    max |card - envelope| "
                    + ", ".join(f"{k} {v}" for k, v in worst.items())
                    + f" (tolerance {ENVELOPE_TOL}); max |card - cpu| "
                    + ", ".join(f"{k} {v}" for k, v in worst_cpu.items())
                    + f" (tolerance {CARD_VS_CPU_TOL}; the CPU run "
                    f"{cpu_secs:.1f} s)")
            if name == "topology":
                o = derived["engine_overhead_cell"]
                log(f"    engine overhead: sharded {o['topology_s']:.4f} s vs "
                    f"trivial {o['trivial_s']:.4f} s for {o['updates']} "
                    f"updates ({o['overhead_x']:.3f}x)")
            if max(worst.values()) > ENVELOPE_TOL:
                raise AssertionError(f"phase 11 {name}: metrics {worst} off "
                                     f"the envelope's")
            if max(worst_cpu.values()) > CARD_VS_CPU_TOL:
                raise AssertionError(f"phase 11 {name}: metrics "
                                     f"{worst_cpu} off the CPU run's")
            out[name] = {"seconds": secs, "launches": counts["ring_apply"],
                         "worst": worst}
    return out


# ---------------------------------------------------------------------------
# the rest of the paper campaign
# ---------------------------------------------------------------------------
# Phase 12 holds the replay and legacy cells' test errors against the
# reference's committed envelopes within PAPER_ENVELOPE_TOL: per cell, the
# largest drift of today's reference from its envelope at the cell's
# default params, in test samples (``python tests/test_torch_paper_cells.py``
# on the CPU), plus the two samples of CARD_VS_CPU_TOL.
PAPER_ENVELOPE_DRIFT = {"fig5": 288, "fig6_7": 86, "table2": 48,
                        "baselines": 36, "table3_4": 27}
PAPER_ENVELOPE_TOL = {k: (v + 2) / 2048
                      for k, v in PAPER_ENVELOPE_DRIFT.items()}
ANALYTIC_CELLS = ("table1", "fig8")
REPLAY_CELLS = ("fig5", "fig6_7", "table2")
LEGACY_CELLS = ("baselines", "table3_4")
TIMING_CELLS = ("sim_engine", "kernels", "bench_guard")
# run order: sim_engine before table3_4, whose summary folds it in
PHASE12_CELLS = ANALYTIC_CELLS + ("fig4",) + REPLAY_CELLS + (
    "baselines", "sim_engine", "table3_4", "kernels", "bench_guard")
# the parts of table3_4's derived that its simulations make (the rest is
# folded in from whatever dep envelopes the results directory holds)
TABLE3_4_OWN = ("table3", "table3_best", "table4")
# claims that today's reference also fails at the cell's default params on
# the CPU (ROADMAP.md §3, ``python tests/test_torch_paper_cells.py``)
RED_IN_REFERENCE = {("fig6_7", "error_grows_with_mu_lambda")}
# Records whose final test error one ulp moves by many samples: on the CPU,
# sixteen one-ulp changes of one initial weight move fig5's n=30/const (the
# unmodulated rate at λ = 30 staleness and base_lr 2.0, divergent by design)
# by up to 138 of 2 048 samples, and every other fig5 record by none
# (``python tests/test_torch_paper_cells.py``).  The card's matmuls round
# differently from the CPU's, so such a record is held against the CPU
# within that spread plus the two samples of CARD_VS_CPU_TOL.
CHAOTIC = {("fig5", "n=30/const"): (138 + 2) / 2048}
METRIC_LEAVES = ("err", "test_error")


def finite_close(a, b, tol) -> bool:
    """Both finite and within ``tol``, or both non-finite: a NaN on one
    side never passes (``abs(a - b) <= tol`` of a NaN is False, and
    ``max(worst, nan)`` would keep the old worst)."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.isfinite(a) == math.isfinite(b)
    return abs(a - b) <= tol


def held_derived(got, want, tol, what, path=()) -> float:
    """Every leaf of ``want`` in ``got``: floats under a test-error key
    within ``tol`` (non-finite together), every other value equal.
    Returns the largest test-error difference."""
    worst = 0.0
    if isinstance(want, dict):
        for k in want:
            if k not in got:
                raise AssertionError(f"{what}: {path + (k,)} missing")
            worst = max(worst, held_derived(got[k], want[k], tol, what,
                                            path + (k,)))
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {path} has {len(got)} entries, "
                                 f"not {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            worst = max(worst, held_derived(a, b, tol, what, path + (i,)))
    elif isinstance(want, float) and path and any(
            m in str(path[-1]) for m in METRIC_LEAVES):
        if not finite_close(got, want, tol):
            raise AssertionError(f"{what}: {path} {got} against {want} "
                                 f"(tolerance {tol})")
        if math.isfinite(want):
            worst = abs(got - want)
    elif got != want:
        raise AssertionError(f"{what}: {path} {got!r} != {want!r}")
    return worst


def held_claims(name, env, cpu_env=None):
    """Every claim ok but those red in the reference; with ``cpu_env`` (a
    run at the same params) every verdict equal to the CPU's."""
    claims = env["campaign"]["claims"]
    for k, c in sorted(claims.items()):
        if cpu_env is not None and \
                c["ok"] != cpu_env["campaign"]["claims"][k]["ok"]:
            raise AssertionError(f"phase 12 {name}: claim {k} {c['ok']} on "
                                 f"the card, not the CPU's")
        if not c["ok"] and (name, k) not in RED_IN_REFERENCE:
            raise AssertionError(f"phase 12 {name}: claim {k} failed")
    return {k: c["ok"] for k, c in sorted(claims.items())}


def held_records(name, env, ref, tol) -> float:
    """A spec cell's records against the reference's envelope, each found
    by its address: schedule side equal, replay_path equal where the
    envelope has one, test errors within ``tol``.  Returns the largest
    test-error difference."""
    by_address = {r["spec_hash"]: r for r in ref["records"]}
    worst = 0.0
    for rec in env["records"]:
        tag = rec["spec"]["tag"]
        want = by_address[reference_address(rec["spec"])]
        if schedule_side(rec) != schedule_side(want):
            raise AssertionError(f"phase 12 {name} {tag}: schedule side "
                                 f"differs from the envelope's")
        want_path = want["runtime"].get("replay_path")
        if want_path is not None and \
                rec["runtime"]["replay_path"] != want_path:
            raise AssertionError(f"phase 12 {name} {tag}: replay_path "
                                 f"{rec['runtime']['replay_path']}, the "
                                 f"envelope's {want_path}")
        for k, v in want["metrics"].items():
            if k in METRIC_LEAVES:
                got = rec["metrics"][k]
                if not finite_close(got, v, tol):
                    raise AssertionError(f"phase 12 {name} {tag}: {k} "
                                         f"{got} against the envelope's {v}")
                if math.isfinite(v):
                    worst = max(worst, abs(got - v))
    return worst


def held_against_cpu(name, env, cpu_env) -> dict:
    """A spec cell's records on the card against its CPU twin at the same
    params: schedule side and replay_path equal, metrics within
    CARD_VS_CPU_TOL (a ``CHAOTIC`` record within its own tolerance).
    Returns the largest metric difference, and each chaotic record's."""
    cpu = {r["spec_hash"]: r for r in cpu_env["records"]}
    worst = {"others": 0.0}
    for rec in env["records"]:
        tag, twin = rec["spec"]["tag"], cpu[rec["spec_hash"]]
        if schedule_side(rec) != schedule_side(twin) or \
                rec["runtime"]["replay_path"] != \
                twin["runtime"]["replay_path"]:
            raise AssertionError(f"phase 12 {name} {tag}: schedule side or "
                                 f"replay_path differs from the CPU run's")
        tol = CHAOTIC.get((name, tag), CARD_VS_CPU_TOL)
        key = tag if (name, tag) in CHAOTIC else "others"
        for k, v in twin["metrics"].items():
            got = rec["metrics"][k]
            if not finite_close(got, v, tol):
                raise AssertionError(f"phase 12 {name} {tag}: {k} {got} "
                                     f"against the CPU's {v} (tolerance "
                                     f"{tol})")
            if math.isfinite(v):
                worst[key] = max(worst.get(key, 0.0), abs(got - v))
    return worst


def replay_events(env) -> int:
    """ring_apply launches a spec cell's records reckon: one per replayed
    event and lane (each record is a lane)."""
    return sum(r["runtime"]["updates"] for r in env["records"]
               if r["runtime"]["replay_path"] != "measure")


def phase_paper_cells(dev, launches):
    """Phase 12: the rest of the paper campaign and the smoke campaign
    through ``campaign.run_cell`` on the card (see the module docstring)."""
    import tempfile

    from repro_torch.experiments import campaign, registry
    from repro_torch.experiments.cells import bench_guard

    with tempfile.TemporaryDirectory(prefix="results_torch_") as tmp:
        def on_card(name, **kw):
            _, secs, counts = counted(lambda: campaign.run_cell(
                name, results_dir=str(Path(tmp) / "card"), device=dev, **kw))
            return (registry.load_envelope(name, str(Path(tmp) / "card")),
                    secs, counts)

        def on_cpu(name):
            t0 = time.perf_counter()
            campaign.run_cell(name, results_dir=str(Path(tmp) / "cpu"),
                              device="cpu")
            return (registry.load_envelope(name, str(Path(tmp) / "cpu")),
                    time.perf_counter() - t0)

        for name in PHASE12_CELLS:
            cell = registry.get_cell(name)
            if name in TIMING_CELLS:
                timing_cell(name, on_card, launches, bench_guard)
                continue
            ref = json.loads((ROOT / "benchmarks" / "results"
                              / f"{cell.result}.json").read_text())
            env, secs, counts = on_card(name)
            cpu_env = cpu_secs = None
            if name != "fig4":
                cpu_env, cpu_secs = on_cpu(name)
            claims = held_claims(name, env, cpu_env)
            tol = PAPER_ENVELOPE_TOL.get(name)
            if name in ANALYTIC_CELLS:
                derived = json.loads(json.dumps(env["derived"]))
                if derived != ref["derived"] or \
                        derived != cpu_env["derived"]:
                    raise AssertionError(f"phase 12 {name}: derived differs "
                                         f"from the envelope's or the CPU's")
                expect(counts, f"phase 12 {name}")
                note = "derived equal to the envelope's and the CPU run's"
            elif name == "fig4":
                held_records(name, env, ref, 0.0)
                expect(counts, f"phase 12 {name}")
                note = (f"{len(env['records'])} measure records, schedule "
                        f"sides equal to the envelope's; no launches")
            elif name in REPLAY_CELLS:
                worst = held_records(name, env, ref, tol)
                worst_cpu = held_against_cpu(name, env, cpu_env)
                events = replay_events(env)
                expect(counts, f"phase 12 {name}", ring_apply=events)
                launches["ring_apply"] += counts["ring_apply"]
                paths = {}
                for r in env["records"]:
                    p = r["runtime"]["replay_path"]
                    paths[p] = paths.get(p, 0) + 1
                note = (f"{len(env['records'])} records ({paths}), schedule "
                        f"sides equal to the envelope's; ring_apply "
                        f"{counts['ring_apply']} (reckoned {events}), "
                        f"{counts['ring_apply'] / secs:.1f} events/s; max "
                        f"|card - envelope| {worst} (tolerance {tol}); max "
                        f"|card - cpu| {worst_cpu} (tolerance "
                        f"{CARD_VS_CPU_TOL}; CHAOTIC records their own)")
            else:
                # the cell module's reckoning of its host-PS updates
                reckon = sys.modules[cell.compute.__module__].ps_updates
                own = (TABLE3_4_OWN if name == "table3_4"
                       else tuple(ref["derived"]))
                worst = held_derived(
                    env["derived"], {k: ref["derived"][k] for k in own
                                     if k in ref["derived"]},
                    tol, f"phase 12 {name} against the envelope")
                worst_cpu = held_derived(
                    env["derived"], {k: cpu_env["derived"][k] for k in own},
                    CARD_VS_CPU_TOL, f"phase 12 {name} against the CPU")
                want = reckon(**cell.resolved_params())
                expect(counts, f"phase 12 {name}", ps_apply=want)
                launches["ps_apply"] += counts["ps_apply"]
                note = (f"ps_apply {counts['ps_apply']} (reckoned {want}, "
                        f"the host-PS updates of its simulations), "
                        f"{counts['ps_apply'] / secs:.1f} updates/s; max "
                        f"|card - envelope| {worst} (tolerance {tol}); max "
                        f"|card - cpu| {worst_cpu} (tolerance "
                        f"{CARD_VS_CPU_TOL})")
            log(f"  {name}: {secs:.1f} s; claims {claims}; {note}"
                + (f"; the CPU run {cpu_secs:.1f} s" if cpu_secs else ""))

        # the smoke campaign twice: the second pass all cache hits
        first, secs, counts = counted(lambda: campaign.run_campaign(
            "smoke", results_dir=str(Path(tmp) / "smoke"), device=dev))
        second = campaign.run_campaign(
            "smoke", results_dir=str(Path(tmp) / "smoke"), device=dev)
        if first["failed_claims"] or first["executed"] != 3 or \
                second["cached"] != 3 or second["executed"]:
            raise AssertionError(f"phase 12 smoke: {first} then {second}")
        launches["ring_apply"] += counts["ring_apply"]
        log(f"  smoke: 3 cells executed in {secs:.1f} s (ring_apply "
            f"{counts['ring_apply']}), then 3 of 3 cache hits")


def timing_cell(name, on_card, launches, bench_guard):
    """sim_engine (at its quick budget, 40 updates a row), kernels and
    bench_guard on the card: claims ok, their numbers printed; sim_engine
    launches every update kernel, its what-if row one ``ring_apply_whatif``
    per event of its warm-up and three timed runs."""
    env, secs, counts = on_card(name, quick=name == "sim_engine")
    claims = held_claims(name, env)
    d = env["derived"]
    if name == "sim_engine":
        drift = {k: v["max_param_drift"] for k, v in d.items()
                 if "max_param_drift" in v}
        mk = d["megakernel_vs_xla"]
        drift["megakernel_vs_xla"] = mk["megakernel_max_param_drift"]
        whatif = 4 * d["whatif_quadratic"]["updates"]
        if counts["ring_apply_whatif"] != whatif or not (
                counts["ring_apply"] and counts["ps_apply"]):
            raise AssertionError(f"phase 12 sim_engine launches {counts}, "
                                 f"expected ring_apply_whatif {whatif} and "
                                 f"ring_apply, ps_apply > 0")
        log(f"  sim_engine (40 updates a row): max_param_drift {drift}; "
            f"ring_apply/stock updates/s {mk['megakernel_vs_xla_ratio']:.3f}"
            f"; replay/legacy " + ", ".join(
                f"{k} {v['speedup']:.2f}" for k, v in d.items()
                if k.startswith("softsync")))
    elif name == "bench_guard":
        m = d["measured"]["metrics"]
        tripped = [r["metric"] for r in bench_guard.check(
            m, d["floor"], 100.0) if not r["ok"]]
        if not tripped:
            raise AssertionError("phase 12 bench_guard: nothing trips at "
                                 "--floor-scale 100")
        log(f"  bench_guard: every floor holds at scale 1 ("
            + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
            + f"); at --floor-scale 100 {len(tripped)} of {len(m)} trip; "
            f"absent: {sorted(d['absent'])}")
    else:
        mk, ps = d["replay_megakernel"], d["ps_update_timed"]
        log(f"  kernels: ring_apply event {mk['megakernel_us']:.1f} us, "
            f"stock chain {mk['stock_us']:.1f} us, bf16 "
            f"{mk['bf16_us']:.1f} us; ps_apply {ps['fused_us']:.1f} us, "
            f"unfused {ps['unfused_us']:.1f} us")
    if name != "kernels":        # kernels holds kernels against plain chains
        for k in ("ring_apply", "ring_apply_whatif", "ps_apply"):
            launches[k] += counts[k]
    log(f"  {name}: {secs:.1f} s; claims {claims}; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))


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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = smi_line()
    log(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off; bf16 "
        f"matmuls reduce in fp32")

    log("phase 2: build")
    t_build = time.perf_counter()
    secs, libs = build.build_all()
    log(f"  all sources in {time.perf_counter() - t_build:.1f} s (one nvcc "
        f"each, started together)")
    for name, path in libs.items():
        spills = [ln.strip() for ln in
                  path.with_suffix(".log").read_text().splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes")]
        log(f"  {name}: {path.name} in {secs[name]:.1f} s; ptxas lines "
            f"with spills: {len(spills)}")
        for ln in spills[:4]:
            log(f"    {ln}")
    for name in ("flash_attention_sm90", "flash_attention"):
        sass_counts(libs[name], build.nvcc())
    ptxas_by_kernel(libs["replay_ring"], ("ring_apply_whatif_kernel",))
    ptxas_by_kernel(libs["ssm_scan"], ("ssd_cb_kernel", "ssd_state_kernel",
                                       "ssd_pass_kernel", "ssd_out_kernel"))
    wkv_regs = ptxas_by_kernel(libs["wkv6"], WKV_KERNELS)
    spilled = {k: v for k, v in wkv_regs.items() if v[1] or v[2]}
    if spilled:
        raise AssertionError(f"wkv6 kernels spill (ptxas): {spilled}")

    log("phase 3: kernel vs plain version on the card (tolerance 0; "
        "flash_attention: 2e-5 fp32, 2^-8 max|v| + one ulp + 2e-5 bf16; "
        "ssm_scan, wkv6: "
        "(1e-5 + 2^-20 * largest chunk decay) * max |plain|)")
    t3 = time.perf_counter()
    worst = phase_kernels_vs_plain(dev)
    worst.update(phase_flash_vs_plain(dev))
    worst.update(phase_scans_vs_plain(dev))
    log(f"  phase 3 in {time.perf_counter() - t3:.1f} s")

    launches = {"ring_apply": 0, "ring_apply_whatif": 0, "ps_apply": 0,
                "flash_attention": 0, "flash_sm90": 0, "flash_tf32x3": 0,
                "ssm_scan": 0, "wkv6": 0}
    t4 = time.perf_counter()
    log("phase 4: paper shape — mlp_teacher D=2762, 1-softsync λ=30, μ=4, "
        "momentum, 300 updates")
    paper = phase_paper_shape(dev, launches)
    log("phase 4b: legacy paper shape — the same run through the "
        "per-arrival host-PS loop")
    phase_legacy_paper_shape(dev, launches, paper)
    log("phase 5: wide lane — mlp_teacher hidden=232558, 1-softsync λ=128, "
        "μ=1, sgd, 8 updates")
    wide_K = phase_wide_lane(dev, launches)
    log("phase 5b: legacy wide lane — phase 5's fp32 spec, "
        "engine='legacy'")
    phase_legacy_wide_lane(dev, launches, wide_K.pop("params"))
    log("phase 5c: elastic sharded wide lane — phase 5's fp32 spec, "
        "shards=8, learners 0-31 crash at 1.2 s for 2.5 s")
    phase_elastic_sharded_wide_lane(dev, launches, wide_K.pop("ms"))
    log("phase 6: what-if lane — quadratic_whatif arch=qwen2_1_5b, "
        "1-softsync λ=128, sgd, 8 updates, bf16 ring")
    whatif_K = phase_whatif_lane(dev, launches)

    log(f"  phases 4-6 in {time.perf_counter() - t4:.1f} s")
    log("phase 7: per-launch times at the phase 5 / 5b / 6 shapes and at "
        "one layer of each served model's prefill")
    t7 = time.perf_counter()
    t_apply = time_kernel("ring_apply", WIDE_D, 128, wide_K["fp32"],
                          "sgd", "fp32", "combine", False, dev, 20, 5)
    time_kernel("ring_apply", WIDE_D, 128, wide_K["bf16"], "sgd",
                "bf16", "combine", False, dev, 20, 5)
    t_whatif = time_kernel("ring_apply_whatif", 1_777_086_464, 128,
                           whatif_K, "sgd", "bf16", "combine", True, dev, 5,
                           1)
    if whatif_K > 1:   # the older ring row pulled too: the lane's 2 rows in
        for long_runs in (True, False):   # a few runs, and in short runs
            time_kernel("ring_apply_whatif", 1_777_086_464, 128, whatif_K,
                        "sgd", "bf16", "combine", True, dev, 5, 1, n_rows=2,
                        slot_pulled=True, long_runs=long_runs)
    t_ps = time_ps("sgd", "combine", WIDE_D, 128, dev, 20, 5)
    time_ps("momentum", "combine", WIDE_D, 128, dev, 20, 5)
    t_flash = time_flash(dev, 32768)
    if max(r["ms"] for r in t_flash.values()) > 2000:
        log("  over 2 s per launch at S = 32768: timed at S = 8192 instead")
        t_flash = time_flash(dev, 8192)
    time_flash(dev, 8192, H=32, KV=32, D=112)    # zamba2_7b's attention
    t_ssm, t_wkv = time_scans(dev)
    log(f"  phase 7 in {time.perf_counter() - t7:.1f} s")

    for phase, arch, fp32_limit in SERVING:
        log(f"phase {phase}: serving — {arch}, full width and depth, bf16, "
            f"attn_impl='pallas', use_pallas=True")
        tp = time.perf_counter()
        phase_serving(phase, arch, fp32_limit, dev, launches)
        log(f"  phase {phase} in {time.perf_counter() - tp:.1f} s")

    log("phase 11: the paper cells elastic, topology and serve at their "
        "default params through campaign.run_cell, against "
        "benchmarks/results/*.json")
    t11 = time.perf_counter()
    phase_cells(dev, launches)
    log(f"  phase 11 in {time.perf_counter() - t11:.1f} s")
    log("phase 12: the rest of the paper campaign (table1, fig8, fig4, "
        "fig5, fig6_7, table2, baselines, sim_engine, table3_4, kernels, "
        "bench_guard) and the smoke campaign through campaign.run_cell, "
        "against benchmarks/results/*.json and the same cells on the CPU")
    t12 = time.perf_counter()
    phase_paper_cells(dev, launches)
    log(f"  phase 12 in {time.perf_counter() - t12:.1f} s")

    kernels = []
    ring_src = "src/repro_torch/kernels/csrc/replay_ring.cu"
    for name, t, source, replaces in (
            ("ring_apply", t_apply, ring_src,
             "src/repro/kernels/replay_ring.py:275"),
            ("ring_apply_whatif", t_whatif, ring_src,
             "src/repro/kernels/replay_ring.py:366"),
            ("ps_apply", t_ps, "src/repro_torch/kernels/csrc/ps_update.cu",
             "src/repro/kernels/ps_update.py:116,128"),
            ("flash_attention", t_flash["sm90"],
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:123"),
            ("flash_attention_fp32", t_flash["tf32x3"],
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:123"),
            ("ssm_scan", t_ssm, "src/repro_torch/kernels/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan.py:85"),
            ("wkv6", t_wkv, "src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/kernels/wkv6.py:106")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # each flash row counts its own kernel's launches on the path
            "launches": launches[FLASH_ROWS.get(name, name)],
            "max_abs_err": max(worst[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
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
