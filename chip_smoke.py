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
   warnings; for the redesigned ``ring_apply_whatif`` kernel, the update
   kernels' ``simple_kernel`` instances (in ``replay_ring`` and
   ``ps_update``), the four ``ssm_scan`` kernels and
   the three ``wkv6`` kernels, their registers and spill bytes (ptxas; a
   ``wkv6`` kernel that spills fails).
3. Kernel vs plain version on the card: ``ring_apply`` over optimizer ×
   mode × ring dtype and ``ring_apply_whatif`` over optimizer × ring dtype,
   at D = 2²² + 37 (a ragged edge), c = 32, K ∈ {3, 1} (K = 1: hardsync,
   the read and written rows are one); ``ring_apply_whatif``'s two
   variants (c = 64 slots pulling 1, 2 and ``WHATIF_ROWS`` distinct rows,
   and one more, in short and in long runs of equal rows) with the slot row
   pulled and at K = 1, at D = 2²² (its 8-wide
   path) and the ragged D; ``ps_apply`` over optimizer × mode
   at the same D and c (its inputs must come back unchanged: it writes
   out of place).  Then both update kernels at the wide lanes' D =
   10 000 004 with their 4-wide loads (checked: ``build.vec4``), c = 32,
   K 3 and 1, every optimizer, mode and ring dtype; the sequential mode
   at c = 128 (momentum, adagrad); a ring view 16 bytes past a 128-byte
   boundary; and ``ring_apply``'s lane axis (3 lanes of D 3 333 336,
   4-wide, and of the ragged 2²² + 37, 1-wide; K 3 and 1; combine,
   sequential and a masked per-lane coef; 4 lanes at the paper's D 2 762,
   c 30).  Tolerance: 0 — bitwise.  Then
   ``flash_attention`` at
   qwen2_1_5b's GQA (H = 12 over KV = 2, D = 128) and a ragged S = 1 000:
   causal, causal with a window of 48, and non-causal, fp32 (the 3×TF32
   kernel) and bf16 (the sm90 kernel), once through the (B, KV, G, S, D)
   entry with Sq ≠ Sk, at D 64, at Sq 201 against Sk 777, at
   zamba2_7b's attention (H = KV = 32, D = 112), causal, at the groupings
   phase 15 launches — G 5 (llama4, qwen3), 7 (arctic) and 9 (starcoder2)
   causal, G 1 non-causal, at D 128 — and, in bf16 only (the sm90 kernel;
   the fp32 kernel is not built for D 80), at hubert_xlarge's attention
   (H = KV = 16, D 80, non-causal).  Tolerance: 2e-5
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
   event (``torch.addmv``, where one exists): ``ring_apply`` fp32 and
   bf16 (with its residue) and ``ps_apply`` sgd and momentum at D
   10 000 004, c 128, beside the card's practical memory rate (a 5.12 GB
   copy); ``ring_apply`` at the paper shape (D 2 762, c 30): one ring, 4
   lanes in one launch and in 4; ``flash_attention`` at one
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
   time with its achieved rates and its share of the bound.  Rows 4″
   and 5′ (``time_zamba2_instruct``): Zamba2-7B-Instruct's layer at the
   ``zamba2_7b.prefill`` cell's shapes, the sm90 kernel at head 224 and
   ``ssm_scan`` at 2 B / C groups, each held to its plain version and
   timed; row 7 (``time_mamba_glue``): the Mamba2 layer's prologue and
   epilogue kernels there, the prologue bitwise its plain version and the
   epilogue within one bf16 ulp, each timed beside it; row 8
   (``time_rms_norm``): the RMSNorm kernel there over d_model and over
   two pieces of d_model, within one bf16 ulp of its plain version, timed
   beside it; then one prefill of the published model with its launches
   counted (13 sm90, 81 each of ``ssm_scan``, ``mamba_in``,
   ``mamba_out``, 108 ``rms_norm``); six more rows of the ``kernels``
   line.  Rows 9 and 10 (``time_granite_moe``): the dropless MoE's
   dispatch and combine kernels at one layer of the
   ``granite_4_0_h_small.prefill_16k`` cell (T 16 384, 72 experts,
   top-10), each held to its plain version and timed beside it, the
   routing skewed (an expert with no row, one with every token's), the
   grouped expert product beside one product an expert, and one prefill
   of Granite-4.0-H-Small at full width and depth with its launches
   counted (4 sm90, 36 each of ``ssm_scan``, ``mamba_in``, ``mamba_out``,
   81 ``rms_norm``, 40 each of ``moe_dispatch``, ``moe_combine``); two
   more rows.
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
   ``ENVELOPE_TOL``); ``ring_apply`` lane events per cell equal to the
   events its records replay (plus the 4 × 40 of ``topology``'s
   engine-overhead timing), and its launches to those less the lanes that
   share a launch: one per event of each batched group (``LaneGroups``
   records the groups ``run_sweep`` forms and holds them to the batched
   records); seconds and events/s per cell.
12. The rest of the paper campaign through ``campaign.run_cell`` on the
   card at the cells' default params, into a temporary results directory,
   each cell also run on the CPU at the same params, in three worker
   processes of one torch thread each, started after phase 7 so that
   they run while the card runs phases 8-12 and no kernel timing of
   phase 7 shares the host with them (every CPU twin at the
   default params — fig5 4.4, fig6_7 25.2, table2 11.9, baselines 8.2,
   table3_4 42.8 s on the host of one NVIDIA H100 80GB HBM3, 700.00 W, 90.1
   s on a slower one — so none runs at ``quick_params``):
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
   and ``ring_apply`` lane events equal to the events the records replay
   (123 648), its launches one per event of each batched group; the
   legacy cells ``baselines`` and ``table3_4`` with every
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
   cell.  (``bench_guard`` runs in phase 13, after the cell it measures.)
13. The ``ring`` cell, SPMD placement, the ``distributed`` cell.  ``ring``
   through ``campaign.run_cell``: its ``configs_table`` and ``analytic``
   equal to the reference's envelope, its two children (the stock lane at
   D₀ = 10 000 004, the what-if lane at 100 007 936 on the bf16 ring)
   under a 6 GiB device-memory cap infeasible and feasible as in the
   envelope, ``demonstrated_gain`` ">=10x", both claims ok; each child's
   peak bytes and bytes/param printed.  13b: SPMD replay
   (``placement="spmd"``) against the single placement at S = 1, 2, 4,
   in one world of 4 gloo ranks (``launch.mesh.shard_map``; every rank
   on the card, the collectives on host tensors), on ``mlp_teacher`` (D
   2 762; c = 4: L = 4, 2, 1) with ``ring_impl`` "pallas" (one
   ``ring_apply`` per rank and event), its ppermute assembly, "fused",
   the bf16 ring and the sequential mode, and on the what-if quadratic (D
   1 000 003; L = 1: one ``ring_apply_whatif`` per PS rank and event) at
   "pallas", bf16 and "fused": each rank's launches zeroed just before a
   case and read just after, equal to one per event on every rank of the
   mesh; what-if ≡ single bitwise, ppermute ≡ all_gather bitwise, the
   staged cases within ``SPMD_ATOL`` (1e-5) of single; then once through
   ``driver.run`` with ``placement="spmd"`` (S = 2, L = 2: the replay
   spawns its own world; 96 ``ring_apply`` launches, 24 per rank, counted
   back in this process).  Then the ``distributed`` cell at its defaults
   (worlds of 1, 2 and 4 ranks; claims ok; updates/s, ranks, cpu_count
   and the card printed), ``table3_4`` at its quick budget with its five
   deps' card envelopes (phases 11–13) beside it (claims ok, every dep
   folded, ``ps_apply`` launches as reckoned: 10 122) and ``bench_guard``
   (all seven floors hold; at 100 times them, they trip).
14. Training (``tools/train_probe.py`` runs this phase alone).  14a:
   qwen2_1_5b at full width and depth (28 layers, d 1 536, vocab 151 936,
   bf16, weights from a seeded ``torch.Generator`` on the card) through
   ``train.loop.train`` at batch 8 × seq 1 024, momentum,
   ``staleness_inverse``, remat, the chunked attention: softsync n 4,
   λ 8 through the sequential engine (3 rounds), the fused engine (3
   rounds), then hardsync (2 rounds); every loss finite, no kernel
   launched (the training path runs none: ``models.model_loss``); ms per
   round (each synchronised; the first with its warm-up), tokens/s and
   peak memory per engine.  14c: the fused case's params (bf16, stored as
   fp32) and velocity saved with ``checkpoint.io`` and reloaded into fresh
   trees on the card, bitwise; bytes and seconds.  14b: qwen2_1_5b's
   width at 2 layers in fp32 (batch 8 × 16, naive attention): one round of
   each engine on the card against the same round on the CPU, each leaf's
   update and velocity within ``FIDELITY_REL`` (1e-3) of its largest
   update; sgd fused against sequential on the card within ``FUSED_ATOL``
   (1e-6, the reference's bound on its toy problem); one hardsync engine
   step against ``simulate``'s one hardsync update over λ = 8 learners
   (one ``ps_apply`` launch over the flattened model) within ``SIM_ATOL``
   (1e-6).  14d: ``python -m repro_torch.launch.train --arch qwen2-1.5b
   --steps 2 --batch 8 --seq 1024 --engine fused --ckpt <tmp>`` as a
   subprocess: exit 0, its staleness line (a measure-mode schedule, as in
   the reference: no kernel), its checkpoint loaded here (every leaf
   finite).  14e: the
   ``cnn`` cell at its defaults (1 600 updates, two policies) through
   ``campaign.run_cell``, cuDNN's deterministic algorithms on (the cell
   is chaotic): its claim ok, 3 200 ``ps_apply`` launches; then
   at 30 updates on the card and on the CPU, each test error within
   ``CNN_SPREAD`` (2) of the 512 test samples of the CPU's (the spread
   one-ulp changes of every initial weight give it on the CPU, 0, + 2).
15. MoE and the modality frontends (``tools/moe_probe.py`` runs this
   phase alone, after phase 3's flash checks).  All bf16, weights from a
   seeded ``torch.Generator`` on the card, ``attn_impl="pallas",
   use_pallas=True``, each model freed before the next; each prints its
   parameters and bytes, the draw's peak, two ``prefill_step`` runs at
   8 192 positions (tokens/s; flash launches exactly one per attention
   layer, all through the sm90 kernel; finite logits), decode tokens/s
   and peak memory (under 80 GB).  15a: llama4_maverick_400b_a17b at full
   width (d 5 120, 40 heads over 8, 128 experts top-1, moe_d_ff 8 192,
   vocab 202 240 padded) cut to one unit (a dense attention block and an
   MoE block, 18.4 G parameters: two units would not fit 80 GB), its
   dropped fraction per MoE layer, ``generate`` (B 4, 16 + 32 tokens) and
   ``ContinuousBatchingEngine`` (6 requests in 4 slots).  15b: arctic_480b
   at full width (d 7 168, 56 heads over 8, top-2 of 128, moe_d_ff 4 864)
   cut to 2 ``moe_dense`` layers (27.7 G parameters), the same.  15c:
   qwen3_14b (40 layers) and starcoder2_7b (32 layers) at full width and
   depth: the same but the batching engine (dropped when the script ran
   past 1 050 s), with phase 8's bf16 prefill-vs-decode-replay check
   (reported).  15d: hubert_xlarge (48 non-causal layers, frames in) and
   internvl2_2b (24 layers, 256 patches before 7 936 tokens) at full
   width and depth: the forward only (hubert is encoder-only).  15e: the
   MoE configs at a reduced width in fp32 (``REDUCED``: d 640 and 896, the
   G of each, 128 experts), ``prefill_step`` (B 2 × S 512) and
   ``generate`` (B 4, 16 + 16) on the card against the same calls on the
   CPU (plain versions): routing first — every token routed differently
   must have a router gap (k-th to (k+1)-th logit) under ``ROUTER_TOL``
   (1e-4) on a side, each such token ambiguous and counted; positions
   before the first ambiguity of their row (a prefill group is one row; a
   decode group is the whole step) held within ``LOGIT_TOL`` (1e-3), the
   generated tokens before the first ambiguous call (or greedy near-tie)
   equal.  15f: ``python -m repro_torch.launch.dryrun --arch
   llama4-maverick-400b-a17b --shape prefill_32k`` as a subprocess (exit
   0, its JSON row printed), then ``dryrun_one`` of 15a's own prefill on a
   1 × 1 mesh: its parameter bytes must equal the tree 15a drew on the
   card (``count_params`` × 2 + the fp32 router's two more bytes an
   element), printed beside 15a's measured peak and time.

Launch counts are zeroed just before each main-path phase (4, 4b, 5, 5b,
5c, 6, each run of phases 8–10, each cell of phases 11–13 and each SPMD
case of phase 13, in every rank, each case of phase 14, each prefill of
phase 15) and read just after it; they must equal the update counts (a
batched group's one launch per event, ``ring_apply``'s lane events one
per event and lane)
(phases 8–10, 15: one kernel launch per attention, mamba or rwkv layer of
a prefill forward, none in decode); flash launches are also counted per
kernel
(``flash_sm90``, ``flash_tf32x3``).  The ``kernels`` line adds every
phase-12 and phase-13 cell's launches but the ``kernels`` cell's, which
holds each kernel against a plain chain, phase 13's SPMD launches
summed over ranks (the ``ring`` cell's children count their own) and
phase 14's ``ps_apply`` (14b and 14e).

Time budget: the whole script took 863.8–998.3 s on one NVIDIA H100 80GB
HBM3, 700.00 W, and past its 1 180 s on a slower host (every phase ~1.4×
slower; phase 12 445.6 s, most of it waiting on the CPU twins, then
running in two workers from phase 12 on and holding each card cell
against its twin before running the next).  So the twins now start
after phase 7 in three single-threaded workers, and phase 12 runs every
card cell before it waits on a twin.  Its time follows the host:
744.2–846.8 s before phase 15 was added.
"""

import dataclasses
import functools
import json
import math
import multiprocessing
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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


def steady_ms(fn, reps: int, windows: int = 3, most: int = 20) -> float:
    """ms per call once the card has settled: after 3 warm-up calls,
    windows of ``reps`` calls (:func:`cuda_ms`) until the last ``windows``
    agree within 1 % (at most ``most`` windows), their median.  After a
    large free (phase 6's what-if lane, 46 GiB) the card streams ~15 %
    slower for a while, a few windows long (PERF.md §6 row 1); a fixed
    window would charge that to the kernel.  Logs the first window when it
    took more than ``windows`` to settle."""
    for _ in range(3):
        fn()
    times = []
    while len(times) < most:
        times.append(cuda_ms(fn, reps, warmup=0))
        last = times[-windows:]
        if len(last) == windows and max(last) <= 1.01 * min(last):
            break
    if len(times) > windows:
        log(f"    (settled after {len(times)} windows of {reps}: the first "
            f"{times[0]:.4f} ms a call)")
    return sorted(times[-windows:])[windows // 2]


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
    phase_update_paths(dev)
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


# phase 3's widths for the update kernels: the ragged CHECK_D takes the
# 1-wide loads, WIDE_D (the wide lanes') and LANES_D x 3 lanes the 4-wide
# ones
LANES_D = 3_333_336


def lane_inputs(B, D, c, K, opt, dtype, masked, seed, dev):
    """One lane-axis event's operands on the card (``replay_batch``'s
    layout), from a torch.Generator seed: ring (B, K, D), s / res (B, D),
    g (B, c, D), coef (c,) or — masked, as elastic lanes — (B, c) with
    about 30 % of the slots cancelled, lrs (B, c), idx [prev, slot]."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    ring = torch.empty(B, K, D, device=dev, dtype=torch.bfloat16
                       if dtype == "bf16" else torch.float32)
    for b in range(B):
        for r in range(K):
            ring[b, r] = torch.randn(D, generator=gen, device=dev)
    coef = torch.full((c,), 1.0 / c, device=dev)
    if masked:
        keep = torch.rand(B, c, generator=gen, device=dev) >= 0.3
        coef = torch.where(keep, coef, torch.zeros_like(coef))
    return dict(
        ring=ring,
        s=(None if opt == "sgd" else
           torch.randn(B, D, generator=gen, device=dev).abs()),
        res=(torch.randn(B, D, generator=gen, device=dev) * 1e-3
             if dtype == "bf16" else None),
        g=torch.randn(B, c, D, generator=gen, device=dev),
        coef=coef,
        lrs=torch.rand(B, c, generator=gen, device=dev) * 0.09 + 0.01,
        idx=torch.tensor([0, 1 % K], dtype=torch.int32, device=dev))


def lanes_compare(ops, spec, mode, what):
    """One lane-axis launch on a copy of the inputs and the plain version
    on the inputs; raises unless bitwise equal."""
    import torch
    from repro_torch.kernels import replay_ring
    from repro_torch.optim import backends
    k = clone_state(ops)
    kern = replay_ring.ring_apply(
        k["ring"], k["s"], k["res"], k["g"], k["coef"], k["lrs"], k["idx"],
        spec=spec, mode=mode)
    plain = backends.apply_event_ring_lanes(
        spec, ops["ring"], ops["s"], ops["res"], ops["g"], ops["coef"],
        ops["lrs"], ops["idx"][0], ops["idx"][1], mode)
    torch.cuda.synchronize()
    return assert_bitwise(kern, plain, what)


def offset_ring(ops, nbytes):
    """``ops`` with its ring moved into a buffer whose base is ``nbytes``
    past a 512-byte boundary (a view as a caller's slice would give)."""
    import torch
    ring = ops["ring"]
    skip = nbytes // ring.element_size()
    buf = torch.empty(ring.numel() + skip, dtype=ring.dtype,
                      device=ring.device)
    view = buf[skip:].view(ring.shape)
    view.copy_(ring)
    if view.data_ptr() % 128 != nbytes % 128:
        raise AssertionError(f"ring view at {view.data_ptr() % 128} mod 128")
    return {**ops, "ring": view}


def phase_update_paths(dev) -> None:
    """``ring_apply`` and ``ps_apply`` at the wide lanes' D with its 4-wide
    loads, and the lane axis, bitwise against the plain versions (see the
    module docstring, phase 3).  Each case's loads are checked
    (``build.vec4``)."""
    from repro_torch.kernels import build
    from repro_torch.optim import UpdateSpec

    def wide(ops, *keys):
        if not build.vec4(WIDE_D, *(ops[k] for k in keys)):
            raise AssertionError("phase 3: the wide case is not 4-wide")
        return ops
    n = 0
    for K in (3, 1):
        for opt in ("sgd", "momentum", "adagrad"):
            for dtype in ("fp32", "bf16"):
                for mode in ("combine", "sequential"):
                    ops = wide(event_inputs(WIDE_D, 32, K, opt, dtype, False,
                                            31, dev), "ring", "g")
                    compare(ops, UpdateSpec(opt), mode, False,
                            f"ring_apply {opt}/{mode}/{dtype}/K={K}"
                            f"/D={WIDE_D}")
                    n += 1
    for opt in ("sgd", "momentum", "adagrad"):
        for mode in ("combine", "sequential"):
            ops = wide(ps_inputs(WIDE_D, 32, opt, 32, dev), "w", "g")
            ps_compare(ops, UpdateSpec(opt), mode,
                       f"ps_apply {opt}/{mode}/D={WIDE_D}")
            n += 1
    log(f"  ring_apply, ps_apply at D={WIDE_D} (4-wide loads), c=32, K 3 "
        f"and 1, every optimizer, mode and ring dtype: {n} launches, "
        f"max|kernel-plain| = 0.0")
    for opt in ("momentum", "adagrad"):          # sequential at c 128
        for dtype in ("fp32", "bf16"):
            ops = event_inputs(WIDE_D, 128, 2, opt, dtype, False, 33, dev)
            compare(ops, UpdateSpec(opt), "sequential", False,
                    f"ring_apply sequential c=128 {opt}/{dtype}")
        del ops
        ops = ps_inputs(WIDE_D, 128, opt, 34, dev)
        ps_compare(ops, UpdateSpec(opt), "sequential",
                   f"ps_apply sequential c=128 {opt}")
        del ops
    for dtype in ("fp32", "bf16"):               # 16-B, not 128-B, aligned
        ops = wide(offset_ring(event_inputs(WIDE_D, 32, 3, "momentum",
                                            dtype, False, 35, dev), 16),
                   "ring", "g")
        compare(ops, UpdateSpec("momentum"), "combine", False,
                f"ring_apply ring view 16 mod 128 {dtype}")
    log(f"  sequential at c=128 (momentum, adagrad; fp32, bf16 rings and "
        f"ps_apply) and a ring view 16 bytes past 128 (fp32, bf16), "
        f"D={WIDE_D}: max|kernel-plain| = 0.0")
    n = 0
    for D in (LANES_D, CHECK_D):
        for K in (3, 1):
            for opt in ("sgd", "momentum", "adagrad"):
                for dtype in ("fp32", "bf16"):
                    for mode, masked in (("combine", False),
                                         ("sequential", False),
                                         ("combine", True)):
                        ops = lane_inputs(3, D, 32, K, opt, dtype, masked,
                                          36, dev)
                        lanes_compare(ops, UpdateSpec(opt), mode,
                                      f"ring_apply lanes {opt}/{mode}/"
                                      f"{dtype}/masked {masked}/K={K}/D={D}")
                        n += 1
    for masked in (False, True):                 # the paper's ragged width
        ops = lane_inputs(4, 2_762, 30, 2, "momentum", "fp32", masked, 37,
                          dev)
        lanes_compare(ops, UpdateSpec("momentum"), "combine",
                      f"ring_apply lanes paper shape masked {masked}")
        n += 1
    log(f"  ring_apply's lane axis: 3 lanes of D={LANES_D} (4-wide) and of "
        f"D={CHECK_D} (1-wide), K 3 and 1, every optimizer and ring dtype, "
        f"combine, sequential and masked per-lane coef; 4 lanes at the "
        f"paper's D=2762, c=30: {n} launches, max|kernel-plain| = 0.0")


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
    counts["ring_apply_lane_events"] = replay_ring.lane_events["ring_apply"]
    return res, secs, counts


class LaneGroups:
    """While active, records each ``replay_batch`` call the experiment
    driver makes — (lanes, events, the ring body its runs resolve to) — so
    a cell's ``ring_apply`` launches can be reckoned: one per event of a
    batched group on the kernel body (the lane axis), one per event and
    record otherwise."""

    def __enter__(self):
        from repro_torch.experiments import driver
        from repro_torch.optim import backends, spec_from_run
        self.calls, self._orig = [], driver.replay_batch

        def recorded(traces, runs, **kw):
            self.calls.append((len(traces), traces[0].steps,
                               backends.resolve_ring_impl(
                                   runs[0].ring_impl,
                                   spec_from_run(runs[0]))))
            return self._orig(traces, runs, **kw)
        driver.replay_batch = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.experiments import driver
        driver.replay_batch = self._orig

    def launches(self, lane_events: int) -> int:
        """The launches that apply ``lane_events``: a kernel group's B lanes
        share each of its events' one launch."""
        return lane_events - sum((b - 1) * steps for b, steps, impl
                                 in self.calls if impl == "kernel")

    def check(self, env, what) -> str:
        """Raise unless the groups are the envelope's batched records (as
        many lanes, as many events); returns a note for the log."""
        upd = [r["runtime"]["updates"] for r in env["records"]
               if r["runtime"]["replay_path"] == "batched"]
        lanes = sum(b for b, _, _ in self.calls)
        events = sum(b * steps for b, steps, _ in self.calls)
        if (lanes, events) != (len(upd), sum(upd)):
            raise AssertionError(f"{what}: batch groups {self.calls} hold "
                                 f"{lanes} lanes and {events} lane events, "
                                 f"the envelope {len(upd)} batched records "
                                 f"of {sum(upd)} updates")
        return (f"{len(self.calls)} batched groups of "
                f"{sorted({b for b, _, _ in self.calls})} lanes")


def drive(spec, dev):
    """driver.run on the card, counted (see :func:`counted`)."""
    from repro_torch.experiments import run
    return counted(lambda: run(spec, device=dev))


def expect(counts, what, **want):
    """Raise unless the launches are ``want`` (every other kernel 0).
    ``ring_apply_lane_events`` defaults to the ``ring_apply`` launches (one
    lane each)."""
    full = {"ring_apply": 0, "ring_apply_whatif": 0, "ps_apply": 0,
            "flash_attention": 0, "flash_sm90": 0, "flash_tf32x3": 0,
            "ssm_scan": 0, "wkv6": 0,
            "ring_apply_lane_events": want.get("ring_apply", 0), **want}
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
    return steady_ms(fn, reps), diff


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
    ms = steady_ms(lambda: run_kernel(ops, spec, mode, whatif), reps)
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
    ms = steady_ms(lambda: ps_kernel(ops, spec, mode), reps)
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


def time_copy(dev, nbytes=4 * 128 * WIDE_D, reps=10):
    """The card's practical memory rate: a device-to-device copy of
    ``nbytes`` (the wide lanes' g), (bytes read + written) / time."""
    import torch
    src = torch.empty(nbytes // 4, device=dev)
    dst = torch.empty_like(src)
    ms = steady_ms(lambda: dst.copy_(src), reps)
    rate = 2 * nbytes / (ms * 1e-3)
    log(f"  copy of {nbytes / 1e9:.2f} GB: {ms:.4f} ms, {rate / 1e12:.3f} "
        f"TB/s read + written ({rate / PEAK_BYTES_PER_S:.3f} of the data "
        f"sheet's {PEAK_BYTES_PER_S / 1e12} TB/s)")
    del src, dst
    torch.cuda.empty_cache()
    return rate


def time_paper_shape(dev, lanes=4, reps=500):
    """``ring_apply`` at the paper shape (D 2 762, c 30, momentum, fp32):
    one launch of one ring (its 1-wide loads), and ``lanes`` lanes in one
    launch against ``lanes`` launches.  Each held bitwise against the plain
    version first."""
    from repro_torch.optim import UpdateSpec
    spec = UpdateSpec("momentum")
    out = {}
    one = event_inputs(2_762, 30, 2, "momentum", "fp32", False, 41, dev)
    compare(one, spec, "combine", False, "ring_apply at the paper shape")
    out["one ring"] = cuda_ms(
        lambda: run_kernel(one, spec, "combine", False), reps, warmup=10)
    ops = lane_inputs(lanes, 2_762, 30, 2, "momentum", "fp32", False, 42,
                      dev)
    lanes_compare(ops, spec, "combine",
                  "ring_apply lanes at the paper shape")
    from repro_torch.kernels import replay_ring
    out[f"{lanes} lanes, one launch"] = cuda_ms(
        lambda: replay_ring.ring_apply(
            ops["ring"], ops["s"], ops["res"], ops["g"], ops["coef"],
            ops["lrs"], ops["idx"], spec=spec), reps, warmup=10)

    def per_lane():
        for b in range(lanes):
            replay_ring.ring_apply(ops["ring"][b], ops["s"][b], None,
                                   ops["g"][b], ops["coef"], ops["lrs"][b],
                                   ops["idx"], spec=spec)
    out[f"{lanes} lanes, {lanes} launches"] = cuda_ms(per_lane, reps,
                                                      warmup=10)
    log("  ring_apply at the paper shape (D 2762, c 30, momentum, fp32), "
        "per call: " + "; ".join(f"{k} {v * 1e3:.2f} us"
                                 for k, v in out.items()))
    return out


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
    (2, 1000, 1000, 10, 2, 128, True, 0, False),      # G 5: llama4, qwen3
    (2, 1000, 1000, 14, 2, 128, True, 0, False),      # G 7: arctic
    (2, 1000, 1000, 18, 2, 128, True, 0, False),      # G 9: starcoder2
    (2, 1000, 1000, 4, 4, 128, False, 0, False),      # G 1 non-causal
)
# bf16 only (the sm90 kernel; the fp32 kernel is not built for D 80):
# hubert_xlarge's attention, 16 heads of D 80, non-causal
FLASH_CELLS_BF16 = ((2, 1000, 1000, 16, 16, 80, False, 0, False),)


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
    cells = ([(c, (torch.float32, torch.bfloat16)) for c in FLASH_CELLS]
             + [(c, (torch.bfloat16,)) for c in FLASH_CELLS_BF16])
    for (B, Sq, Sk, H, KV, D, causal, window, bkgsd), dtypes in cells:
        for dtype in dtypes:
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


def time_zamba2_instruct(dev):
    """Rows 4″, 5′ and 7: a layer of Zamba2-7B-Instruct
    (``configs/zamba2_7b_instruct.py``) at the ``zamba2_7b.prefill`` cell's
    shapes.  The sm90 kernel at head 224 (B 8, S 4 096, 32 heads, causal,
    the model's scale (224/2)^-½) and ``ssm_scan`` with B / C in 2 groups
    (B 8, S 4 096, 112 heads, P = N = 64, chunk 256, B / C bf16 column
    slices of one tensor, as the model passes them), each held to its plain
    version (``flash_check``, ``scan_check``) and timed beside it, the scan
    also at G 1 on group 0's operands; bounds from
    ``portbench/reference/prefill_cost.py``.  Then one prefill of the
    published model at full width and depth (B 1, S 4 096, weights drawn on
    the card) with the launch counters zeroed just before it: one sm90
    launch per hybrid layer (13), one ``ssm_scan``, ``mamba_in`` and
    ``mamba_out`` per layer (81 each), and ``rms_norm`` 108 times (each
    layer's input norm, the shared blocks' two norms at 13 layers, the
    final norm).  Row 7 is :func:`time_mamba_glue`'s, row 8
    :func:`time_rms_norm`'s.  Returns the six rows of the ``kernels``
    line."""
    import torch
    import torch.nn.functional as F
    from portbench.reference import prefill_cost as pc
    from repro_torch.config import RunConfig
    from repro_torch.configs import zamba2_7b_instruct as zi
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_glue as mg
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssm_scan as sk
    from repro_torch.models import init_model
    from repro_torch.serve.engine import prefill_step
    pub = json.loads((ROOT / "portbench/configs/zamba2_7b.json").read_text())
    cfg = zi.CONFIG
    B, S, H, D, scale = 8, 4096, cfg.n_heads, cfg.d_head, cfg.attn_scale
    q, k, v = flash_inputs(B, S, S, H, H, D, torch.bfloat16, 26, dev)
    kb, vb = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    def view(t):
        return t.reshape(B, S, H, 1, D).permute(0, 2, 3, 1, 4)

    def kern():
        return fa.flash_attention(q, k, v, causal=True, scale=scale)

    def plain():
        return fa.flash_attention_bkgsd_plain(
            view(q), kb, vb, causal=True, blk_q=128,
            blk_k=fa.SM90_WIDE_BLK_K, scale=scale)

    err, share = flash_check(view(kern()), plain(), vb,
                             "flash_attention at head 224")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash = {"ms": cuda_ms(kern, 5), "plain_ms": cuda_ms(plain, 1, 0),
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, scale=scale), 5),
             "bound_ms": pc.flash_least_s(pub, B, S) * 1e3,
             "bound_by": "operations", "max_abs_err": err}
    log(f"  flash_attention B={B} S={S} H={H} D={D} causal scale "
        f"(D/2)^-1/2, bf16 sm90 wide kernel: {flash['ms']:.4f} ms (plain "
        f"{flash['plain_ms']:.4f} ms; scaled_dot_product_attention "
        f"{flash['library_ms']:.4f} ms; bound {flash['bound_ms']:.4f} ms, "
        f"{flash['bound_ms'] / flash['ms']:.3f} of it); max |kernel - "
        f"plain| {err} ({share:.4f} of the bf16 bound)")
    del q, k, v, kb, vb, qt, kt, vt
    torch.cuda.empty_cache()

    G, N, P, Q = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim, \
        cfg.ssm_chunk
    x, a, Bm, Cm = ssm_inputs(B, S, cfg.ssm_n_heads, P, G * N,
                              torch.bfloat16, 27, dev)
    Bm, Cm = Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
    y, st = sk.ssm_scan(x, a, Bm, Cm, chunk=Q)
    py, pst = sk.ssm_scan_plain(x, a, Bm, Cm, chunk=Q)
    span = decay_span(a, Q)
    err = max(scan_check(y, py, span, "ssm_scan at G 2")[0],
              scan_check(st, pst, span, "ssm_scan's state at G 2")[0])
    del y, st, py, pst
    scan = {"ms": cuda_ms(lambda: sk.ssm_scan(x, a, Bm, Cm, chunk=Q), 5),
            "plain_ms": cuda_ms(lambda: sk.ssm_scan_plain(
                x, a, Bm, Cm, chunk=Q), 1, 0),
            "library_ms": None,
            "bound_ms": pc.ssm_scan_least_s(pub, B, S) * 1e3,
            "bound_by": "operations", "max_abs_err": err}
    g1_ms = cuda_ms(lambda: sk.ssm_scan(x, a, Bm[:, :, 0], Cm[:, :, 0],
                                        chunk=Q), 5)
    log(f"  ssm_scan B={B} S={S} H={cfg.ssm_n_heads} P={P} N={N} G={G} "
        f"chunk={Q}: {scan['ms']:.4f} ms (G 1 on group 0's operands "
        f"{g1_ms:.4f} ms; plain {scan['plain_ms']:.4f} ms; bound "
        f"{scan['bound_ms']:.4f} ms, {scan['bound_ms'] / scan['ms']:.3f} of "
        f"it); max |kernel - plain| {err}")
    del x, a, Bm, Cm
    torch.cuda.empty_cache()
    glue = time_mamba_glue(cfg, B, S, dev)
    norm = time_rms_norm(cfg, B, S, dev)

    params = init_model(cfg, 28, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             28))
    fa.reset_launches()
    sk.reset_launches()
    mg.reset_launches()
    rn.reset_launches()
    with torch.inference_mode():
        logits = prefill_step(cfg, RunConfig(attn_impl="pallas",
                                             use_pallas=True), params,
                              {"tokens": toks})
    counts = {"flash_sm90": fa.launches_by_path["sm90"],
              "ssm_scan": sk.launches["ssm_scan"], **mg.launches,
              **rn.launches}
    finite = bool(torch.isfinite(logits).all())
    del params, logits
    torch.cuda.empty_cache()
    want = {"flash_sm90": len(cfg.hybrid_layer_ids),
            "ssm_scan": cfg.n_layers, "mamba_in": cfg.n_layers,
            "mamba_out": cfg.n_layers,
            "rms_norm": 2 * len(cfg.hybrid_layer_ids) + cfg.n_layers + 1}
    log(f"  one prefill of the published model (B 1, S {S}): launches "
        f"{counts} (expected {want}), logits finite: {finite}")
    if counts != want or not finite:
        raise AssertionError(f"zamba2_7b_instruct prefill: launches "
                             f"{counts}, expected {want}; finite {finite}")
    flash["launches"] = counts["flash_sm90"]
    scan["launches"] = counts["ssm_scan"]
    for name in glue:
        glue[name]["launches"] = counts[name]
    for row in norm.values():
        row["launches"] = counts["rms_norm"]
    return {"flash_attention_d224": flash, "ssm_scan_g2": scan, **glue,
            **norm}


def glue_inputs(cfg, B, S, seed, dev):
    """One Mamba2 layer's operands of the glue kernels at ``cfg``'s widths,
    bf16 as the model passes them: the fused projection's z, x B C and dt
    column views of one (B, S, Din + C + H) tensor (dt about softplus's
    threshold 20 at every 97th position), the layer's convolution,
    dt_bias and A_log as ``init_params`` draws them but conv_b,
    gate_norm and D random, and the scan's y."""
    import torch
    from repro_torch.models import hybrid
    gen = torch.Generator(device=dev).manual_seed(seed)
    Din, H, P, _, _, C = hybrid._mamba_widths(cfg)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    zxbcdt = randn(B, S, Din + C + H)
    zxbcdt[:, ::97, Din + C:] += 25.0
    zxbcdt = zxbcdt.to(torch.bfloat16)
    p = hybrid._init_layer(gen, cfg, False, torch.bfloat16, dev)
    return dict(
        z=zxbcdt[..., :Din], xbc=zxbcdt[..., Din:Din + C],
        dt=zxbcdt[..., Din + C:], conv_w=p["conv_w"],
        conv_b=(randn(C) * 0.1).to(torch.bfloat16), dt_bias=p["dt_bias"],
        A_log=p["A_log"], D=randn(H), y=randn(B, S, H, P),
        gate_norm=(1.0 + 0.1 * randn(Din)).to(torch.bfloat16))


def bf16_ulp_gap(got, want):
    """(elements of ``got`` more than one bf16 ulp of the larger of the
    two from ``want``, the share of elements that differ at all)."""
    import torch
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(
        torch.maximum(g.abs(), w.abs()))[1] - 8)
    diff = (g - w).abs()
    return int((diff > ulp).sum()), float((diff > 0).float().mean())


def time_mamba_glue(cfg, B, S, dev):
    """Row 7: the Mamba2 layer's prologue and epilogue kernels
    (``kernels/mamba_glue.py``) at ``cfg``'s layer (B, S), each held to its
    plain version — the prologue bitwise, the epilogue within one bf16 ulp
    on at most 1e-3 of its elements — and timed beside it; the bound is
    each kernel's least traffic at 3.35 TB/s."""
    import torch
    from repro_torch.kernels import mamba_glue as mg
    g = glue_inputs(cfg, B, S, 29, dev)
    P, G = cfg.ssm_head_dim, cfg.ssm_groups
    H, C = g["dt"].shape[-1], g["xbc"].shape[-1]

    def pro():
        return mg.mamba_in(g["xbc"], g["dt"], g["conv_w"], g["conv_b"],
                           g["dt_bias"], g["A_log"], head_dim=P)

    def pro_plain():
        return mg.mamba_in_plain(g["xbc"], g["dt"], g["conv_w"],
                                 g["conv_b"], g["dt_bias"], g["A_log"],
                                 head_dim=P)
    got, want = pro(), pro_plain()
    torch.cuda.synchronize()
    for name, a, b in zip(("x B C", "xdt", "a"), got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            diff = float((a.float() - b.float()).abs().max())
            raise AssertionError(f"mamba_in's {name}: not bitwise the plain "
                                 f"version, max |diff| {diff}")
    xs = got[0][..., :H * P].unflatten(-1, (H, P))
    del got, want

    def epi():
        return mg.mamba_out(g["y"], xs, g["z"], g["D"], g["gate_norm"],
                            groups=G, eps=cfg.norm_eps)

    def epi_plain():
        return mg.mamba_out_plain(g["y"], xs, g["z"], g["D"], g["gate_norm"],
                                  groups=G, eps=cfg.norm_eps)
    out, plain = epi(), epi_plain()
    over, share = bf16_ulp_gap(out, plain)
    err = float((out.float() - plain.float()).abs().max())
    del out, plain
    if over or share > 1e-3:
        raise AssertionError(f"mamba_out: {over} elements over one bf16 ulp "
                             f"of the plain version, {share} differ")
    rows = {}
    for name, fn, plain, nbytes, err in (
            ("mamba_in", pro, pro_plain, mg.in_bytes(B, S, C, H, P), 0.0),
            ("mamba_out", epi, epi_plain, mg.out_bytes(B, S, H, P), err)):
        rows[name] = {"ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(plain, 5),
                      "library_ms": None,
                      "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "max_abs_err": err}
        r = rows[name]
        log(f"  {name} B={B} S={S} H={H} P={P} C={C} G={G} bf16: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms by {nbytes / 1e9:.3f} GB, "
            f"{r['bound_ms'] / r['ms']:.3f} of it)")
    log(f"  mamba_in bitwise the plain version; mamba_out differs from it "
        f"on {share:.2e} of its elements, none by more than one bf16 ulp")
    return rows


def time_rms_norm(cfg, B, S, dev):
    """Row 8: the RMSNorm kernel (``kernels/rms_norm.py``) at the
    ``zamba2_7b.prefill`` cell's B · S rows, over d_model (the Mamba2
    layers' input norm, the pre-MLP and final norms) and over two pieces
    of d_model each (the shared block's input norm on x and e, never
    concatenated), bf16 as the model runs it: each held to its plain
    version (within one bf16 ulp, on at most 1e-3 of its elements) and
    timed beside it; the bound is each row read and written once at
    3.35 TB/s."""
    import torch
    from repro_torch.kernels import rms_norm as rn
    gen = torch.Generator(device=dev).manual_seed(30)
    M = cfg.d_model

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    x, e = (randn(B * S, M).to(torch.bfloat16) for _ in range(2))
    rows = {}
    for name, tail in (("rms_norm", None), ("rms_norm_cat", e)):
        W = M if tail is None else 2 * M
        scale = (1.0 + 0.1 * randn(W)).to(torch.bfloat16)

        def kern():
            return rn.rms_norm(x, scale, cfg.norm_eps, tail=tail)

        def plain():
            return rn.rms_norm_plain(x, scale, cfg.norm_eps, tail=tail)
        out, want = kern(), plain()
        over, share = bf16_ulp_gap(out, want)
        err = float((out.float() - want.float()).abs().max())
        del out, want
        if over or share > 1e-3:
            raise AssertionError(f"{name}: {over} elements over one bf16 "
                                 f"ulp of the plain version, {share} "
                                 f"differ")
        nbytes = rn.nbytes(B * S, W)
        rows[name] = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 5),
                      "library_ms": None,
                      "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "max_abs_err": err}
        r = rows[name]
        log(f"  {name} rows={B * S} W={W} bf16: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
            f"{nbytes / 1e9:.3f} GB, {r['bound_ms'] / r['ms']:.3f} of it); "
            f"differs from the plain version on {share:.2e} of its "
            f"elements, none by more than one bf16 ulp")
    return rows


def time_granite_moe(dev):
    """Rows 9 and 10: the dropless MoE's dispatch and combine
    (``kernels/moe_route.py``) at one layer of the
    ``granite_4_0_h_small.prefill_16k`` cell (T 16 384 rows of 4 096, 72
    experts, top-10, bf16), each held to its plain version (the dispatch's
    experts, counts, ends, rows and gathered x bitwise, its gates within
    4 fp32 ulps, there and with the routing skewed so one expert gets no
    row and one most of them; the combine bitwise), its largest
    difference from it kept in its row, and timed beside it; the bounds
    are ``portbench/reference/granite_cost.py``'s bytes at 3.35 TB/s.
    Then the grouped expert product (``torch._grouped_mm``) against one product a
    expert there and at the cell's routing, and one prefill of the
    published model (B 1, S 16 384, weights drawn on the card) with the
    launch counters zeroed just before it: flash 4, ``ssm_scan``,
    ``mamba_in`` and ``mamba_out`` 36 each, ``rms_norm`` 81, the dispatch
    and the combine 40 each.  Returns the two rows of the ``kernels``
    line."""
    import torch
    from portbench.reference import granite_cost as gc
    from repro_torch.config import RunConfig
    from repro_torch.configs import granite_4_0_h_small as gs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_glue as mg
    from repro_torch.kernels import moe_route as mr
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssm_scan as sk
    from repro_torch.models import granite, init_model
    from repro_torch.serve.engine import prefill_step
    pub = json.loads((ROOT / "portbench/configs/granite_4_0_h_small.json")
                     .read_text())
    cfg = gs.CONFIG
    T, M, E, k = 16384, cfg.d_model, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    x = randn(T, M).to(torch.bfloat16)
    w_r = (randn(M, E) * 0.02).to(torch.bfloat16)
    logits = x.float() @ w_r.float()

    def check_dispatch(lg, what):
        got, want = mr.moe_dispatch(lg, x, k), mr.moe_dispatch_plain(lg, x, k)
        for name in ("experts", "counts", "ends", "pos", "xs"):
            if not torch.equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"moe_dispatch {what}: {name} differs "
                                     f"from the plain version")
        diff = (got.gates - want.gates).abs()
        ulps = float((diff / torch.finfo(torch.float32).eps
                      / want.gates.abs()).max())
        if ulps > 4:
            raise AssertionError(f"moe_dispatch {what}: gates {ulps} ulps "
                                 f"from the plain version")
        return got, ulps, float(diff.max())
    routed, ulps, err = check_dispatch(logits, "at the cell's routing")
    # expert 5 gets no row, expert 3 one of every token's
    skew = logits.clone()
    skew[:, 5] = -1e4
    skew[:, 3] += 1e4
    skewed, ulps_s, err_s = check_dispatch(skew, "skewed")
    counts = skewed.counts
    if int(counts[5]) != 0 or int(counts[3]) != T \
            or int(counts.sum()) != T * k:
        raise AssertionError(f"skewed routing counts {counts.tolist()}")
    rows = {}
    nbytes = gc.dispatch_bytes(pub, 1, T)
    rows["moe_dispatch"] = {
        "ms": cuda_ms(lambda: mr.moe_dispatch(logits, x, k), 20),
        "plain_ms": cuda_ms(lambda: mr.moe_dispatch_plain(logits, x, k), 5),
        "library_ms": None, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "max_abs_err": max(err, err_s)}
    r = rows["moe_dispatch"]
    log(f"  moe_dispatch T={T} M={M} E={E} k={k} bf16: {r['ms']:.4f} ms "
        f"(plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
        f"{nbytes / 1e9:.3f} GB, {r['bound_ms'] / r['ms']:.3f} of it); "
        f"rows bitwise the plain version, gates within "
        f"{max(ulps, ulps_s):.2f} ulps (max |diff| {r['max_abs_err']:.3e}), "
        f"skewed routing included; rows an expert "
        f"{int(routed.counts.min())}-{int(routed.counts.max())}")

    y = randn(T * k, M).to(torch.bfloat16)
    shared, resid = (randn(T, M).to(torch.bfloat16) for _ in range(2))
    args = (y, routed.gates, routed.pos, shared, resid,
            cfg.residual_multiplier)
    got, want = mr.moe_combine(*args), mr.moe_combine_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError("moe_combine differs from the plain version")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    nbytes = gc.combine_bytes(pub, 1, T)
    rows["moe_combine"] = {
        "ms": cuda_ms(lambda: mr.moe_combine(*args), 20),
        "plain_ms": cuda_ms(lambda: mr.moe_combine_plain(*args), 5),
        "library_ms": None, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "max_abs_err": err}
    r = rows["moe_combine"]
    log(f"  moe_combine T={T} M={M} k={k} bf16: {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
        f"{nbytes / 1e9:.3f} GB, {r['bound_ms'] / r['ms']:.3f} of it); "
        f"bitwise the plain version")
    del y, shared, resid, args

    w_in = (randn(E, M, 2 * cfg.moe_d_ff) * 0.02).to(torch.bfloat16)
    for what, rt in (("the cell's routing", routed), ("skewed", skewed)):
        grouped = granite._grouped(rt.xs, w_in, rt.ends, rt.counts)
        loop = granite._grouped(rt.xs.float(), w_in.float(), rt.ends,
                                rt.counts)
        share = float(((grouped.float() - loop).abs()
                       > 2 ** -7 * loop.abs() + 1e-3).float().mean())
        if share > 1e-4:
            raise AssertionError(f"grouped product {what}: {share} of its "
                                 f"elements off the fp32 product")
        g_ms = cuda_ms(lambda: granite._grouped(rt.xs, w_in, rt.ends,
                                                rt.counts), 5)
        sizes = rt.counts.tolist()

        def per_expert():
            out = torch.empty_like(grouped)
            s = 0
            for e, n in enumerate(sizes):
                if n:
                    torch.matmul(rt.xs[s:s + n], w_in[e], out=out[s:s + n])
                s += n
            return out
        l_ms = cuda_ms(per_expert, 5)
        flops = 2.0 * T * k * M * 2 * cfg.moe_d_ff
        log(f"  grouped gate/up product, {what}: {g_ms:.4f} ms "
            f"({flops / g_ms / 1e9:.1f} TFLOP/s), one product an expert "
            f"{l_ms:.4f} ms; {share:.2e} of its elements beyond bf16 of "
            f"the fp32 product")
    del x, logits, skew, routed, skewed, w_in, grouped, loop
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, 28, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             28))
    run = RunConfig(attn_impl="pallas", use_pallas=True)
    with torch.inference_mode():
        prefill_step(cfg, run, params, {"tokens": toks})
    for mod in (fa, sk, mg, rn, mr):
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = prefill_step(cfg, run, params, {"tokens": toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"flash_sm90": fa.launches_by_path["sm90"],
              "ssm_scan": sk.launches["ssm_scan"], **mg.launches,
              **rn.launches, **mr.launches}
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated()
    del params, logits
    torch.cuda.empty_cache()
    n_attn, L = len(cfg.attention_layer_ids), cfg.n_layers
    want = {"flash_sm90": n_attn, "ssm_scan": L - n_attn,
            "mamba_in": L - n_attn, "mamba_out": L - n_attn,
            "rms_norm": 2 * L + 1, "moe_dispatch": L, "moe_combine": L}
    log(f"  one prefill of the published model (B 1, S {T}) in "
        f"{secs:.3f} s ({gc.prefill_flops(pub, 1, T) / secs / 989e12:.3f} "
        f"of the bf16 peak), peak {peak / 2**30:.2f} GiB: launches {counts} "
        f"(expected {want}), logits finite: {finite}")
    if counts != want or not finite:
        raise AssertionError(f"granite prefill: launches {counts}, expected "
                             f"{want}; finite {finite}")
    for name in rows:
        rows[name]["launches"] = counts[name]
    return rows


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
    tree has eight: five token-shift mixes, mu_ck, decay_w0, ln_x_scale),
    no qk-norm scales (the tree has two of d_head per attention block)
    and no frontend projection (the tree has M × M)."""
    M = cfg.d_model
    per_unit = 0
    for b in cfg.block_pattern:
        if b == "mamba":
            per_unit += cfg.ssm_d_inner + 2 * cfg.ssm_state - M
        elif b == "rwkv":
            per_unit += M
        elif cfg.qk_norm:                                # q_norm, k_norm
            per_unit += 2 * cfg.d_head
    front = M * M if cfg.frontend != "none" else 0     # frontend_proj
    return (cfg.param_count() + 2 * (cfg.padded_vocab - cfg.vocab_size) * M
            + M + cfg.n_units * per_unit + front)


def forward_launches(cfg) -> dict:
    """Kernel launches of one prefill forward: one flash_attention per
    attention layer (zamba2's shared ones and the MoE blocks' too) — all
    through the sm90 kernel in bf16, the 3×TF32 one in fp32 —, one
    ssm_scan per mamba layer, one wkv6 per rwkv layer."""
    def n(*types):
        return cfg.n_units * sum(b in types for b in cfg.block_pattern)
    attn = n("attn", "shared_attn", "moe", "moe_dense")
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


def phase_cells(dev, launches, keep):
    """Phase 11: the elastic, topology and serve cells through
    ``campaign.run_cell`` at their default params, each record held
    against the reference's committed envelope; their card envelopes are
    copied to ``keep`` (phase 13's table3_4 folds them)."""
    import shutil
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
            with LaneGroups() as groups:
                derived, secs, counts = counted(lambda: campaign.run_cell(
                    name, results_dir=str(card_dir), device=dev))
            env = registry.load_envelope(cell, str(card_dir))
            group_note = groups.check(env, f"phase 11 {name}")
            shutil.copy(registry.results_path(cell, str(card_dir)), keep)
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
            expect(counts, f"phase 11 {name}",
                   ring_apply=groups.launches(events),
                   ring_apply_lane_events=events)
            paths = {}
            for r in env["records"]:
                p = r["runtime"]["replay_path"]
                paths[p] = paths.get(p, 0) + 1
            log(f"  {name}: {len(env['records'])} records ({paths}), every "
                f"record's schedule side equal to the envelope's; claims "
                f"ok {sorted(claims)}; ring_apply launches "
                f"{counts['ring_apply']} (reckoned "
                f"{groups.launches(events)}: {group_note}, one launch per "
                f"event), lane events {events}; {secs:.1f} s, "
                f"{events / secs:.1f} events/s")
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
# worker processes for the CPU twins, one torch thread each (started after
# phase 7, they run beside phases 8-12; the longest, table3_4's, takes
# about as long as fig6_7's and table2's together)
CPU_TWIN_WORKERS = 3
# run order: sim_engine before table3_4, whose summary folds it in;
# bench_guard runs in phase 13, after the distributed cell it measures too
PHASE12_CELLS = ANALYTIC_CELLS + ("fig4",) + REPLAY_CELLS + (
    "baselines", "sim_engine", "table3_4", "kernels")
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
    """The lane events a spec cell's records reckon: one per replayed event
    and record (each record is a lane)."""
    return sum(r["runtime"]["updates"] for r in env["records"]
               if r["runtime"]["replay_path"] != "measure")


def start_cpu_twins(tmp):
    """Phase 12's CPU twins in ``CPU_TWIN_WORKERS`` worker processes, the
    longest first, each into a directory of its own under ``tmp``; started
    after phase 7's timings, so that the card's phases 8-12 seldom wait
    for them: (the pool, {cell: future})."""
    twins = sorted((n for n in PHASE12_CELLS
                    if n not in TIMING_CELLS and n != "fig4"),
                   key=lambda n: n not in ("table3_4", "fig6_7"))
    pool = ProcessPoolExecutor(
        max_workers=CPU_TWIN_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {n: pool.submit(cpu_twin, n, str(Path(tmp) / n))
                  for n in twins}


def phase_paper_cells(dev, launches, keep, cpu_runs):
    """Phase 12: the rest of the paper campaign and the smoke campaign
    through ``campaign.run_cell`` on the card (see the module docstring),
    each cell held against its CPU twin from ``cpu_runs``; sim_engine's
    card envelope is copied to ``keep``."""
    import tempfile

    from repro_torch.experiments import campaign, registry

    with tempfile.TemporaryDirectory(prefix="results_torch_") as tmp:
        def on_card(name, **kw):
            with LaneGroups() as groups:
                _, secs, counts = counted(lambda: campaign.run_cell(
                    name, results_dir=str(Path(tmp) / "card"), device=dev,
                    **kw))
            return (registry.load_envelope(name, str(Path(tmp) / "card")),
                    secs, counts, groups)

        phase12_loop(dev, launches, keep, tmp, on_card, cpu_runs)


def cpu_twin(name, results_dir):
    """One phase-12 cell on the CPU, in a worker process with one torch
    thread (the twins share the host with the card's process):
    (its envelope, seconds)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.experiments import campaign, registry
    t0 = time.perf_counter()
    campaign.run_cell(name, results_dir=results_dir, device="cpu")
    return (registry.load_envelope(name, results_dir),
            time.perf_counter() - t0)


def phase12_loop(dev, launches, keep, tmp, on_card, cpu_runs):
    """Phase 12's cells on the card, all of them first, then each held
    against its CPU twin from ``cpu_runs`` (futures: the card never waits
    for a twin while it has a cell to run), then the smoke campaign."""
    import shutil

    from repro_torch.experiments import campaign, registry
    from repro_torch.experiments.cells import bench_guard
    ran = {}
    for name in PHASE12_CELLS:
        if name in TIMING_CELLS:
            timing_cell(name, on_card, launches, bench_guard)
            if name == "sim_engine":
                shutil.copy(registry.results_path(
                    registry.get_cell(name), str(Path(tmp) / "card")), keep)
            continue
        ran[name] = on_card(name)
    for name, (env, secs, counts, groups) in ran.items():
        cell = registry.get_cell(name)
        ref = json.loads((ROOT / "benchmarks" / "results"
                          / f"{cell.result}.json").read_text())
        cpu_env = cpu_secs = None
        if name != "fig4":
            cpu_env, cpu_secs = cpu_runs[name].result()
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
            group_note = groups.check(env, f"phase 12 {name}")
            expect(counts, f"phase 12 {name}",
                   ring_apply=groups.launches(events),
                   ring_apply_lane_events=events)
            launches["ring_apply"] += counts["ring_apply"]
            paths = {}
            for r in env["records"]:
                p = r["runtime"]["replay_path"]
                paths[p] = paths.get(p, 0) + 1
            note = (f"{len(env['records'])} records ({paths}), schedule "
                    f"sides equal to the envelope's; ring_apply "
                    f"{counts['ring_apply']} (reckoned "
                    f"{groups.launches(events)}: {group_note}, one launch "
                    f"per event), lane events {events}, "
                    f"{events / secs:.1f} events/s; max "
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
    env, secs, counts = on_card(name, quick=name == "sim_engine")[:3]
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
            raise AssertionError("bench_guard: nothing trips at "
                                 "--floor-scale 100")
        if set(m) != set(bench_guard.FLOOR_MARGINS):
            raise AssertionError(f"phase 13 bench_guard measured {sorted(m)}"
                                 f", not every guarded metric")
        log(f"  bench_guard: all {len(m)} floors hold at scale 1 ("
            + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
            + f"); at --floor-scale 100 {len(tripped)} of {len(m)} trip")
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


# ---------------------------------------------------------------------------
# phase 13: the ring cell, SPMD placement, the distributed cell
# ---------------------------------------------------------------------------
# DESIGN.md §13's tolerance for the staged SPMD bodies against the single
# placement (with L > 1 the learner ranks' partial sums reorder the fp32
# combine); what-if SPMD and the ppermute assembly are held bitwise
SPMD_ATOL = 1e-5
SPMD_WORLD = 4                 # ranks of each world: S·L with c = 4 slots
SPMD_STEPS = 24
SPMD_SHARDS = (1, 2, 4)
WHATIF_SPMD_D = 1_000_003      # ragged: S = 4 slices of 250 001
# name → (problem, RunConfig overrides, spmd_assembly); the mlp cases run
# mlp_teacher at its paper width (D 2 762)
SPMD_CASES = {
    "mlp_kernel": ("mlp", dict(ring_impl="pallas"), "all_gather"),
    "mlp_kernel_ppermute": ("mlp", dict(ring_impl="pallas"), "ppermute"),
    "mlp_fused": ("mlp", dict(ring_impl="fused"), "all_gather"),
    "mlp_kernel_bf16": ("mlp", dict(ring_impl="pallas", ring_dtype="bf16"),
                        "all_gather"),
    "mlp_kernel_sequential": ("mlp", dict(ring_impl="pallas",
                                          lr_policy="per_gradient"),
                              "all_gather"),
    "whatif_kernel": ("whatif", dict(ring_impl="pallas"), "all_gather"),
    "whatif_kernel_bf16": ("whatif", dict(ring_impl="pallas",
                                          ring_dtype="bf16"), "all_gather"),
    "whatif_fused": ("whatif", dict(ring_impl="fused"), "all_gather"),
}
# the cells' own checks: table3_4 at its quick budget (its default takes
# 70-76 s on the card, phase 12 runs it there); its deps' envelopes come
# from phases 11-13
TABLE3_4_DEPS = {"topology": "topology_scaling", "elastic": "elastic_churn",
                 "serve": "train_while_serve",
                 "distributed": "distributed_replay",
                 "sim_engine": "sim_engine"}


def spmd_run_config(shards, overrides):
    from repro_torch.config import RunConfig
    kw = dict(protocol="softsync", n_softsync=4, n_learners=16, minibatch=4,
              base_lr=0.05, lr_policy="staleness_inverse",
              optimizer="momentum", seed=7, shards=shards)
    kw.update(overrides)
    return RunConfig(**kw)


def spmd_case(name, shards, placement, dev):
    """One SPMD_CASES replay on ``dev`` at ``placement``."""
    from repro_torch.core import replay
    from repro_torch.core.trace import schedule_cached
    from repro_torch.experiments.problems import MLPProblem, QuadraticProblem
    problem, overrides, assembly = SPMD_CASES[name]
    cfg = spmd_run_config(shards, overrides)
    trace = schedule_cached(cfg, SPMD_STEPS)
    prob = (MLPProblem() if problem == "mlp"
            else QuadraticProblem(d=WHATIF_SPMD_D))
    kw = dict(grad_fn=prob.grad_fn, init_params=prob.init(dev),
              batches=prob.stage_minibatches(trace.learner, trace.mb_index,
                                             cfg.minibatch), device=dev)
    if problem == "whatif":
        kw["flat_grad"] = prob.flat_grad(dev)
    if placement == "spmd":
        kw["spmd_assembly"] = assembly
    return replay(trace, cfg, placement=placement, **kw)


def spmd_world(device):
    """A rank of phase 13b's world: every SPMD case at every shard count.
    Each rank zeroes its launch counts just before a case and reads them
    just after; rank 0 gets every rank's counts, its seconds and the
    parameters."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import replay_ring
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for shards in SPMD_SHARDS:
        for name in SPMD_CASES:
            sync()
            replay_ring.reset_launches()
            t0 = time.perf_counter()
            res = spmd_case(name, shards, "spmd", dev)
            sync()
            secs = time.perf_counter() - t0
            counts = [None] * dist.get_world_size()
            dist.all_gather_object(counts, dict(replay_ring.launches))
            out[shards, name] = (None if res is None else
                                 {k: v.cpu() for k, v in res.params.items()},
                                 counts, secs)
    return out


def params_close(a, b, atol, what) -> float:
    worst = max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)
    if not worst <= atol:
        raise AssertionError(f"{what}: max |spmd - single| {worst} > {atol}")
    return worst


def spmd_expected(name, shards):
    """Per-rank launches of a case: every rank on the mesh applies its
    slice once per event (the learner ranks of a shard hold copies of its
    slice); the what-if body runs on S ranks, the fused one launches
    nothing."""
    problem, overrides, _ = SPMD_CASES[name]
    if overrides["ring_impl"] == "fused":
        return [{"ring_apply": 0, "ring_apply_whatif": 0}] * SPMD_WORLD
    if problem == "whatif":
        return ([{"ring_apply": 0, "ring_apply_whatif": SPMD_STEPS}] * shards
                + [{"ring_apply": 0, "ring_apply_whatif": 0}]
                * (SPMD_WORLD - shards))
    return [{"ring_apply": SPMD_STEPS, "ring_apply_whatif": 0}] * SPMD_WORLD


def phase_spmd(dev, launches):
    """Phase 13b: SPMD replay on the card against the single placement at
    S = 1, 2, 4 (one world of SPMD_WORLD ranks), then once through
    ``driver.run`` with ``placement="spmd"`` (the replay spawns its own
    world)."""
    import dataclasses as dc

    from repro_torch.experiments import ExperimentSpec, run
    from repro_torch.launch import mesh
    mesh.ensure_host_devices(SPMD_WORLD)
    t0 = time.perf_counter()
    got = mesh.shard_map(spmd_world, SPMD_WORLD, str(dev))
    log(f"  one world of {SPMD_WORLD} ranks, every case at S = "
        f"{SPMD_SHARDS}: {time.perf_counter() - t0:.1f} s with its start")
    for shards in SPMD_SHARDS:
        rows = []
        for name in SPMD_CASES:
            params, counts, secs = got[shards, name]
            want = spmd_expected(name, shards)
            if counts != want:
                raise AssertionError(f"phase 13 spmd S={shards} {name}: "
                                     f"launches per rank {counts}, expected "
                                     f"{want}")
            for c in counts:
                for k in ("ring_apply", "ring_apply_whatif"):
                    launches[k] += c[k]
            single = spmd_case(name, shards, "single", dev).params
            what = f"phase 13 spmd S={shards} {name}"
            if name.startswith("whatif"):
                params_bitwise(params, {k: v.cpu() for k, v in
                                        single.items()}, what)
                diff = "bitwise"
            else:
                diff = f"{params_close(params, single, SPMD_ATOL, what):.3g}"
            if name == "mlp_kernel_ppermute":
                params_bitwise(params, got[shards, "mlp_kernel"][0],
                               f"{what} against all_gather")
                diff += ", bitwise all_gather's"
            per_rank = [c["ring_apply"] + c["ring_apply_whatif"]
                        for c in counts]
            rows.append(f"{name} {secs:.2f} s, {SPMD_STEPS / secs:.1f} "
                        f"updates/s, launches per rank {per_rank}, "
                        f"|spmd - single| {diff}")
        log(f"  S={shards}:")
        for r in rows:
            log(f"    {r}")

    # the user's entry: driver.run spawns the replay's own world
    base = ExperimentSpec(run=spmd_run_config(2, dict(ring_impl="pallas")),
                          problem="mlp_teacher", steps=SPMD_STEPS,
                          eval_every=8)
    spmd_spec = dc.replace(base, run=base.run.replace(placement="spmd"))
    res, secs, counts = counted(lambda: run(spmd_spec, device=dev))
    single = run(base, device=dev)
    from repro_torch.kernels import replay_ring
    expect(counts, "phase 13 driver.run spmd",
           ring_apply=SPMD_WORLD * SPMD_STEPS)
    launches["ring_apply"] += counts["ring_apply"]
    params_close(res.params, single.params, SPMD_ATOL,
                 "phase 13 driver.run spmd")
    if abs(res.metrics["test_error"] - single.metrics["test_error"]) > \
            CARD_VS_CPU_TOL or [r["update"] for r in res.curve] != [8, 16, 24]:
        raise AssertionError(f"phase 13 driver.run spmd: {res.metrics}, "
                             f"{res.curve} against {single.metrics}")
    log(f"  driver.run placement='spmd' (S=2, L=2, ring_impl='pallas'): "
        f"{secs:.1f} s with its world's start; ring_apply per rank "
        f"{[c['ring_apply'] for c in replay_ring.rank_launches]}; "
        f"test_error {res.metrics['test_error']} (single "
        f"{single.metrics['test_error']})")


def phase_ring_distributed(dev, launches, keep):
    """Phase 13: the ring cell, SPMD placement on the card, the
    distributed cell, table3_4 with all five deps, bench_guard (see the
    module docstring)."""
    from repro_torch.experiments import campaign, registry
    from repro_torch.experiments.cells import bench_guard, ring_feasibility

    def on_card(name, **kw):
        _, secs, counts = counted(lambda: campaign.run_cell(
            name, results_dir=str(keep), device=dev, **kw))
        return registry.load_envelope(name, str(keep)), secs, counts

    # 13a: the ring cell, held to the reference's envelope
    ref = json.loads((ROOT / "benchmarks" / "results"
                      / "ring_feasibility.json").read_text())["derived"]
    env, secs, _ = on_card("ring")
    d = json.loads(json.dumps(env["derived"]))
    for k in ("configs_table", "analytic"):
        if d[k] != ref[k]:
            raise AssertionError(f"phase 13 ring: {k} differs from the "
                                 f"envelope's")
    trials = d["rlimit_demo"]["trials"]
    if [t["feasible"] for t in trials] != [
            t["feasible"] for t in ref["rlimit_demo"]["trials"]] or \
            d["rlimit_demo"]["demonstrated_gain"] != ">=10x" or \
            not all(c["ok"] for c in env["campaign"]["claims"].values()):
        raise AssertionError(f"phase 13 ring: {d['rlimit_demo']}, claims "
                             f"{env['campaign']['claims']}")
    log(f"  ring: {secs:.1f} s; configs_table and analytic equal to the "
        f"envelope's; cap {trials[0]['cap_bytes']} bytes "
        f"({d['rlimit_demo']['cap_gb']} GiB of device memory); claims ok")
    for t in trials:
        peak = ring_feasibility.peak_bytes(t)
        log(f"    {t['label']} D={t['d']}: "
            + (f"feasible, peak {peak} bytes = {peak / t['d']:.2f} B/param"
               if t["feasible"] else f"infeasible: {t['detail']}"))

    log("phase 13b: SPMD replay on the card against the single placement")
    t0 = time.perf_counter()
    phase_spmd(dev, launches)
    log(f"  phase 13b in {time.perf_counter() - t0:.1f} s")

    env, secs, counts = on_card("distributed")
    expect(counts, "phase 13 distributed")       # ring_impl="fused"
    claims = held_claims("distributed", env)
    d = env["derived"]
    log(f"  distributed: {secs:.1f} s; claims {claims}; updates/s "
        + ", ".join(f"{k} {v:.1f} ({d['ranks'][k]} ranks)"
                    for k, v in d["updates_per_s"].items())
        + f"; scaling_s4_over_s1 {d['scaling_s4_over_s1']:.3f}; devices "
        f"{d['devices']}, cpu_count {d['cpu_count']}, card {d['card']}")

    # table3_4 again, now with its five deps' envelopes beside it
    cell = registry.get_cell("table3_4")
    if cell.deps != tuple(TABLE3_4_DEPS):
        raise AssertionError(f"table3_4 deps {cell.deps}")
    env, secs, counts = on_card("table3_4", quick=True)
    claims = held_claims("table3_4", env)
    missing = [k for k in TABLE3_4_DEPS.values() if k not in env["derived"]]
    want = sys.modules[cell.compute.__module__].ps_updates(
        **cell.resolved_params(quick=True))
    expect(counts, "phase 13 table3_4", ps_apply=want)
    launches["ps_apply"] += counts["ps_apply"]
    if missing:
        raise AssertionError(f"phase 13 table3_4: deps not folded {missing}")
    log(f"  table3_4 (quick, epochs 3): {secs:.1f} s; claims {claims}; "
        f"all five deps folded; ps_apply {counts['ps_apply']} (reckoned "
        f"{want})")

    timing_cell("bench_guard", on_card, launches, bench_guard)


# ---------------------------------------------------------------------------
# phase 14: the training engines, checkpoints, the train CLI, the cnn cell
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen2_1_5b"
TRAIN_B, TRAIN_S = 8, 1024               # 8 192 tokens a round
TRAIN_CASES = (("sequential", "softsync", 3), ("fused", "softsync", 3),
               ("hardsync", "hardsync", 2))
# 14b, one round on the card against the same round on the CPU: each
# leaf's new velocity within this share of its largest magnitude, and its
# new weights within this share of its largest update plus one fp32 ulp of
# its largest weight (an update far below a weight's ulp, as a norm
# scale's is, flips that weight's last rounding on a difference of the
# update of a few ulps) — fp32 sums in other orders (cuBLAS against the
# CPU's BLAS, the embedding backward's atomics) through a 2-layer backward
# and a 151 936-wide softmax, with the naive attention (the chunked one's
# bf16 P·V product flips a probability's rounding now and then, a 2⁻⁸
# step)
FIDELITY_REL = 1e-3
FID_B, FID_S = 8, 16
# sgd fused ≡ sequential and a hardsync engine step ≡ simulate's hardsync
# update over λ learners: the reference's own bounds on its toy problems
# (tests/test_system.py:109, tests/test_cross_validation.py), absolute
FUSED_ATOL = 1e-6
SIM_ATOL = 1e-6
# 14e: the cnn cell at a reduced budget on the card beside the CPU.  On
# the CPU, one-ulp changes of every initial weight (16 seeded draws,
# ``python tests/test_torch_cnn.py N``) move its test errors by up to 0,
# 0, 2, 4 and 28 of the 512 test samples at 20, 30, 40, 60 and 100
# updates: const sits on its plateau, staleness_inverse leaves it and
# turns chaotic.  The card rounds every convolution differently, more than
# those draws (3 samples apart at 40 updates), so the comparison runs at
# 30, each policy within its spread + 2.
CNN_REDUCED = 30
CNN_SPREAD = {"const": 0 + 2, "staleness_inverse": 0 + 2}


def flat_tree(tree, prefix=""):
    """A nested dict of tensors as one level {"a/b/c": tensor} (the host
    PS flattens one level of keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest_tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def rel_leaf_diff(a, b, base=None) -> float:
    """max over leaves of max|a − b| / scale, the scale max|b| or, with
    ``base``, max|b − base| (the update) + one fp32 ulp of max|b|
    over ``FIDELITY_REL``; computed on ``a``'s device."""
    import numpy as np
    worst = 0.0
    fa, fb = flat_tree(a), flat_tree(b)
    fbase = flat_tree(base) if base is not None else None
    for k in fb:
        x = fa[k]
        y = fb[k].to(x.device)
        scale = float(y.abs().max())
        if fbase is not None:
            upd = float((y - fbase[k].to(x.device)).abs().max())
            scale = upd + float(np.spacing(np.float32(scale))) / FIDELITY_REL
        err = float((x - y).abs().max())
        worst = max(worst, err / scale if scale else (0.0 if err == 0
                                                      else math.inf))
    return worst


def abs_leaf_diff(a, b) -> float:
    fa, fb = flat_tree(a), flat_tree(b)
    return max(float((fa[k] - fb[k].to(fa[k].device)).abs().max())
               for k in fb)


def train_case(cfg, run, engine, rounds, params, dev):
    """``train.loop.train`` for ``rounds`` rounds on the card, counted; the
    time of each round (synchronised after it), peak memory, losses."""
    import torch
    from repro_torch.train.loop import train
    stamps = []

    def stamp(_params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return {}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, secs, counts = counted(lambda: train(
        cfg, run, steps=rounds, batch=TRAIN_B, seq=TRAIN_S, engine=engine,
        eval_every=1, eval_fn=stamp, params=params, device=dev))
    ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    return res, ms, torch.cuda.max_memory_allocated(), counts


def phase_train_full(dev):
    """14a: qwen2_1_5b at full width and depth through train.loop.train;
    returns the fused case's (params, velocity) for 14c."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_model
    cfg = get_config(TRAIN_ARCH)
    params = init_model(cfg, 0, device=dev)
    run = RunConfig(protocol="softsync", n_softsync=4, n_learners=8,
                    minibatch=TRAIN_B // 8, base_lr=0.01,
                    lr_policy="staleness_inverse", optimizer="momentum",
                    remat=True, attn_q_chunk=TRAIN_S, attn_kv_chunk=TRAIN_S)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.dtype}, "
        f"{count_params(params)} parameters; batch {TRAIN_B} x seq "
        f"{TRAIN_S}, n 4, lambda 8, momentum, staleness_inverse, remat, "
        f"attn_impl {run.attn_impl!r}")
    kept = None
    for engine, protocol, rounds in TRAIN_CASES:
        res, ms, peak, counts = train_case(
            cfg, dataclasses.replace(run, protocol=protocol), engine,
            rounds, params, dev)
        expect(counts, f"phase 14a {engine}")
        losses = [h["loss"] for h in res.history]
        if len(losses) != rounds or not all(map(math.isfinite, losses)):
            raise AssertionError(f"phase 14a {engine}: losses {losses}")
        steady = sum(ms[1:]) / len(ms[1:])
        log(f"  14a {engine}: {rounds} rounds, ms per round "
            f"{', '.join(f'{m:.1f}' for m in ms)} (the first with its "
            f"warm-up); {steady:.1f} ms per round after it, "
            f"{TRAIN_B * TRAIN_S / steady * 1e3:.1f} tokens/s; peak "
            f"{peak} bytes = {peak / 2**30:.2f} GiB; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; launches 0")
        if engine == "fused":
            kept = (res.params, res.opt_state)
        del res
    del params
    return kept


def phase_checkpoints(params, opt_state, dev):
    """14c: 14a's fused params (bf16, stored as fp32) and velocity saved
    and reloaded into fresh trees, bitwise."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
    from repro_torch.optim.flatten import tree_map
    with tempfile.TemporaryDirectory(prefix="ckpt_") as d:
        log(f"  free disk where checkpoints go: "
            f"{shutil.disk_usage(d).free / 2**30:.1f} GiB")
        for name, tree in (("params", params), ("velocity", opt_state)):
            path = os.path.join(d, f"{name}.npz")
            t0 = time.perf_counter()
            save_checkpoint(path, tree, step=3)
            t1 = time.perf_counter()
            fresh = tree_map(torch.empty_like, tree)
            got, step = load_checkpoint(path, fresh)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            a, b = flat_tree(tree), flat_tree(got)
            same = all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                       and b[k].device == a[k].device for k in a)
            if not same or step != 3 or sorted(a) != sorted(b):
                raise AssertionError(f"phase 14c {name}: reload differs")
            log(f"  14c {name}: {len(a)} leaves, {os.path.getsize(path)} "
                f"bytes on disk; save {t1 - t0:.1f} s, load {t2 - t1:.1f} "
                f"s; reloaded bitwise (dtype and device kept)")
            os.remove(path)
            del got, fresh


def phase_fidelity(dev, launches):
    """14b: qwen2_1_5b's width at 2 layers in fp32 — each engine's round
    on the card against the CPU, sgd fused against sequential, and a
    hardsync engine step against simulate's hardsync update."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.core import (init_opt_state, make_hardsync_step,
                                  make_train_step, simulate)
    from repro_torch.core.distributed import grad_with_accum
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import init_model, model_loss
    from repro_torch.optim.flatten import tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, n_units=2,
                              dtype="float32")
    cpu_p = init_model(cfg, 1, device="cpu")
    card_p = tree_map(lambda t: t.to(dev), cpu_p)
    batch = make_batch_fn(cfg, FID_B, FID_S, seed=0)(0)
    on = {"cpu": {k: torch.from_numpy(v) for k, v in batch.items()},
          "cuda": {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}}
    base = dict(n_softsync=4, n_learners=8, minibatch=1, base_lr=0.01,
                lr_policy="staleness_inverse", optimizer="momentum",
                attn_impl="naive")

    def step_on(run, engine, params, where):
        loss = lambda p, b, sample_weights=None: model_loss(
            cfg, run, p, b, sample_weights=sample_weights)
        step = make_train_step(run, loss, engine)
        out, secs, counts = counted(lambda: step(
            params, init_opt_state(run, params), on[where]))
        if where == "cuda":
            expect(counts, f"phase 14b {engine}")
        return out, secs

    log(f"  14b.1 one round, card against CPU, {cfg.n_layers} layers, d "
        f"{cfg.d_model}, fp32, batch {FID_B} x {FID_S}: tolerance "
        f"{FIDELITY_REL} of each leaf's largest update (+ one ulp of its "
        f"largest weight) and velocity")
    for engine, protocol in (("hardsync", "hardsync"),
                             ("sequential", "softsync"),
                             ("fused", "softsync")):
        run = RunConfig(protocol=protocol, **base)
        (pc, oc, _), csecs = step_on(run, engine, cpu_p, "cpu")
        (pg, og, _), gsecs = step_on(run, engine, card_p, "cuda")
        dp = rel_leaf_diff(pg, pc, cpu_p)
        dv = rel_leaf_diff(og, oc)
        log(f"    {engine}: max |card - CPU| / (max |update| + ulp / "
            f"{FIDELITY_REL}) = {dp:.3e} (params), / max |velocity| = "
            f"{dv:.3e}, tolerance {FIDELITY_REL}; card "
            f"{gsecs:.2f} s, CPU {csecs:.2f} s")
        if not dp <= FIDELITY_REL or not dv <= FIDELITY_REL:
            raise AssertionError(f"phase 14b {engine}: card against CPU "
                                 f"{dp}, {dv} > {FIDELITY_REL}")
        del pc, oc, pg, og

    sgd = RunConfig(protocol="softsync", **dict(base, optimizer="sgd"))
    (pf, _, _), _ = step_on(sgd, "fused", card_p, "cuda")
    (ps, _, _), _ = step_on(sgd, "sequential", card_p, "cuda")
    d = abs_leaf_diff(pf, ps)
    log(f"  14b.2 sgd fused against sequential on the card: max |diff| = "
        f"{d:.3e}, tolerance {FUSED_ATOL}")
    if not d <= FUSED_ATOL:
        raise AssertionError(f"phase 14b sgd fused vs sequential {d}")
    del pf, ps

    hard = RunConfig(protocol="hardsync", **dict(base, optimizer="sgd",
                                                 lr_policy="const"))
    loss = lambda p, b: model_loss(cfg, hard, p, b)
    eng, _, counts = counted(lambda: make_hardsync_step(hard, loss)(
        card_p, init_opt_state(hard, card_p), on["cuda"]))
    expect(counts, "phase 14b hardsync engine")

    def grad_fn(p, b):
        return flat_tree(grad_with_accum(loss, nest_tree(p), b, 1)[2])

    sim, secs, counts = counted(lambda: simulate(
        hard, steps=1, grad_fn=grad_fn, init_params=flat_tree(card_p),
        batch_fn=lambda l, s: {k: v[l:l + 1] for k, v in batch.items()},
        device=dev))
    expect(counts, "phase 14b simulate", ps_apply=1)
    launches["ps_apply"] += 1
    d = abs_leaf_diff(nest_tree(sim.params), eng[0])
    log(f"  14b.3 hardsync: one engine step over the batch against "
        f"simulate's one update over lambda 8 learners (one ps_apply over "
        f"{sum(v.numel() for v in sim.params.values())} parameters): max "
        f"|diff| = {d:.3e}, tolerance {SIM_ATOL}; simulate {secs:.2f} s")
    if not d <= SIM_ATOL:
        raise AssertionError(f"phase 14b simulate vs engine {d}")


def phase_train_cli(dev):
    """14d: the train CLI at full width as a subprocess; its checkpoint
    loads here."""
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint.io import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.flatten import tree_map
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="train_cli_") as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen2-1.5b", "--steps", "2", "--batch", str(TRAIN_B),
               "--seq", str(TRAIN_S), "--engine", "fused", "--ckpt", d]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=600, cwd=str(ROOT))
        secs = time.perf_counter() - t0
        for ln in out.stdout.splitlines():
            log(f"    | {ln}")
        if out.returncode != 0:
            raise AssertionError(f"phase 14d: exit {out.returncode}\n"
                                 f"{out.stderr[-4000:]}")
        m = re.search(r"^protocol=softsync .*expected<sigma>=(\S+)",
                      out.stdout, re.M)
        if m is None:
            raise AssertionError("phase 14d: no staleness line")
        cfg = get_config(TRAIN_ARCH)
        template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                  device=dev),
                            init_params(cfg, None, "meta"))
        t1 = time.perf_counter()
        got, step = load_checkpoint(os.path.join(d, "checkpoint.npz"),
                                    template)
        finite = all(bool(torch.isfinite(v).all())
                     for v in flat_tree(got).values())
        if step != 2 or not finite:
            raise AssertionError(f"phase 14d: checkpoint step {step}, "
                                 f"finite {finite}")
        log(f"  14d: the CLI in {secs:.1f} s (exit 0; its staleness line: "
            f"expected <sigma> {m.group(1)}, a measure-mode schedule, no "
            f"kernel); its checkpoint "
            f"loaded here in {time.perf_counter() - t1:.1f} s, step 2, "
            f"every leaf finite")
        del got, template


def phase_cnn(dev, launches, keep):
    """14e: the cnn cell at its defaults on the card, then at a reduced
    budget on the card and on the CPU.  cuDNN runs its deterministic
    algorithms here: the cell's staleness_inverse record is chaotic, and
    a convolution backward that sums with atomics would move it from run
    to run (on one H100: 0.0645 to 0.8789 at the defaults, against
    const's 0.8984)."""
    import torch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _phase_cnn(dev, launches, keep)
    finally:
        torch.backends.cudnn.deterministic = prev


def _phase_cnn(dev, launches, keep):
    from repro_torch.experiments import campaign, registry
    from repro_torch.experiments.cells import cnn_fig5
    cell = registry.get_cell("cnn")
    updates = cell.params["updates"]
    derived, secs, counts = counted(lambda: campaign.run_cell(
        "cnn", results_dir=str(keep), device=dev))
    claims = held_claims("cnn", registry.load_envelope("cnn", str(keep)))
    expect(counts, "phase 14e cnn", ps_apply=len(cnn_fig5.POLICIES)
           * updates)
    launches["ps_apply"] += counts["ps_apply"]
    log(f"  14e cnn (defaults: {updates} updates a policy): {secs:.1f} s; "
        f"test errors const {derived['const']:.4f}, staleness_inverse "
        f"{derived['staleness_inverse']:.4f}; claims {claims}; ps_apply "
        f"{counts['ps_apply']}")
    (_, card), csecs, counts = counted(lambda: cnn_fig5.compute(
        updates=CNN_REDUCED, device=dev))
    expect(counts, "phase 14e cnn reduced",
           ps_apply=len(cnn_fig5.POLICIES) * CNN_REDUCED)
    launches["ps_apply"] += counts["ps_apply"]
    t0 = time.perf_counter()
    _, cpu = cnn_fig5.compute(updates=CNN_REDUCED, device="cpu")
    for policy in cnn_fig5.POLICIES:
        moved = round(abs(card[policy] - cpu[policy]) * 512)
        log(f"  14e at {CNN_REDUCED} updates, {policy}: card "
            f"{card[policy]:.4f}, CPU {cpu[policy]:.4f}: {moved} of 512 "
            f"test samples apart, tolerance {CNN_SPREAD[policy]}")
        if moved > CNN_SPREAD[policy]:
            raise AssertionError(f"phase 14e {policy}: card {card[policy]}"
                                 f", CPU {cpu[policy]}")
    log(f"  14e reduced: card {csecs:.1f} s, CPU "
        f"{time.perf_counter() - t0:.1f} s")


def phase_training(dev, launches, keep):
    """Phase 14 (see the module docstring)."""
    import torch
    log(f"  times on {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{smi_line()}")
    t = time.perf_counter()
    log("phase 14a: qwen2_1_5b at full width and depth through "
        "train.loop.train")
    params, opt_state = phase_train_full(dev)
    log(f"  14a in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log("phase 14c: checkpoints of 14a's params and velocity")
    phase_checkpoints(params, opt_state["velocity"], dev)
    del params, opt_state
    torch.cuda.empty_cache()
    log(f"  14c in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log("phase 14b: fidelity at qwen2_1_5b's width, 2 layers, fp32")
    phase_fidelity(dev, launches)
    torch.cuda.empty_cache()
    log(f"  14b in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log("phase 14d: python -m repro_torch.launch.train --arch qwen2-1.5b "
        "--steps 2 --batch 8 --seq 1024 --engine fused --ckpt <tmp>")
    phase_train_cli(dev)
    log(f"  14d in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log("phase 14e: the cnn cell")
    phase_cnn(dev, launches, keep)
    log(f"  14e in {time.perf_counter() - t:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: MoE and the modality frontends at full width, the dry-run
# ---------------------------------------------------------------------------
# 15a / 15b: the MoE configs at full width, cut in depth to fit one card
# (llama4: one unit, a dense attention block and an MoE block, 18.4 G
# parameters; two units would be 69.5 GB before activations.  arctic: two
# moe_dense layers, 27.7 G parameters); 15c / 15d: full width and depth.
# (phase, architecture, depth cut or None, what runs: "serve" the prefill,
# generate and continuous batching; "generate" without the batching (15c:
# the script ran past 1 050 s with it, see the module docstring);
# "forward" the prefill alone)
PHASE15 = (("15a", "llama4_maverick_400b_a17b", 1, "serve"),
           ("15b", "arctic_480b", 2, "serve"),
           ("15c", "qwen3_14b", None, "generate"),
           ("15c", "starcoder2_7b", None, "generate"),
           ("15d", "hubert_xlarge", None, "forward"),
           ("15d", "internvl2_2b", None, "forward"))
# 15e, the MoE configs at a reduced width in fp32 on the card against the
# same calls on the CPU (plain versions).  A token is ambiguous when its
# router logits' gap between the k-th and (k+1)-th expert is under
# ROUTER_TOL — fp32 sums in another order move a router logit by ~1e-6 at
# these widths, so a gap of 1e-4 cannot flip; a greedy token is ambiguous
# when its top-two logits are within LOGIT_TOL.  Rows before the first
# ambiguity of their batch row (and, in decode, of the step: one routing
# group holds the whole batch) are held within LOGIT_TOL, every routing
# difference must fall on an ambiguous token, and held greedy tokens must
# be equal.  Written before the first run; the seed is not chosen.
ROUTER_TOL = 1e-4
LOGIT_TOL = 1e-3
REDUCED = {   # d_head 64 keeps each config's grouping G (5 and 7)
    "llama4_maverick_400b_a17b": dict(
        d_model=640, n_heads=10, n_kv_heads=2, d_head=64, d_ff=1024,
        moe_d_ff=512, vocab_size=8192, n_layers=2, n_units=1),
    "arctic_480b": dict(
        d_model=896, n_heads=14, n_kv_heads=2, d_head=64, d_ff=1024,
        moe_d_ff=512, vocab_size=8192, n_layers=2, n_units=2),
}
PREFILL_S = 8192


def phase15_cfg(arch, units):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if units is not None:
        cfg = dataclasses.replace(
            cfg, n_units=units, n_layers=units * len(cfg.block_pattern))
    return cfg


class MoeRecorder:
    """Wraps ``models.moe.moe_forward`` while active: each call's routing
    (experts, keep, the router logits' k-th to (k+1)-th gap; on the host)
    and its dropped fraction, in call order.  Reading them syncs, so
    timed runs go without it."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe.moe_forward

        def wrapped(cfg, p, x):
            import torch
            r = moe.route(cfg, p, x)
            k = cfg.top_k
            top = torch.topk(r["logits"], k + 1, dim=-1).values
            out, aux = orig(cfg, p, x)
            self.calls.append({
                "shape": tuple(x.shape[:2]), "idx": r["idx"].cpu(),
                "keep": r["keep"].cpu(),
                "gap": (top[..., k - 1] - top[..., k]).cpu(),
                "dropped": float(aux["dropped_fraction"])})
            return out, aux
        moe.moe_forward = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_forward = self._orig


def phase15_inputs(cfg, gen, dev, S):
    """A prefill batch of S positions from ``gen``: frames (audio), 256
    patches + S − 256 tokens (vision), or tokens."""
    import torch
    from repro_torch.models.layers import dtype_of
    dt = dtype_of(cfg.dtype)
    if cfg.frontend == "audio":
        return {"frames": torch.randn((1, S, cfg.d_model), generator=gen,
                                      device=dev, dtype=dt)}
    n = S - cfg.n_prefix_embeds if cfg.frontend == "vision" else S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(
            (1, cfg.n_prefix_embeds, cfg.d_model), generator=gen,
            device=dev, dtype=dt)
    return batch


def phase15_model(phase, arch, units, what, dev, launches):
    """One model of 15a–15d: init from a seeded generator on the card,
    prefill_step at 8 192 positions (flash launches exact), then, unless
    ``what`` is "forward", the bf16 prefill-vs-decode check (dense models)
    and ``generate``, and for "serve" ``ContinuousBatchingEngine``; peak
    memory.  Returns its numbers."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.models import count_params, init_model
    from repro_torch.serve.engine import generate, prefill_step
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    cfg = phase15_cfg(arch, units)
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
        raise AssertionError(f"phase {phase} {arch}: {n} parameters, "
                             f"expected {expected_params(cfg)}")
    nbytes = sum(t.numel() * t.element_size() for t in flat_tree(
        params).values())
    init_peak = torch.cuda.max_memory_allocated()
    log(f"  {arch}: {cfg.n_layers} layers {cfg.block_pattern} x "
        f"{cfg.n_units}{' (depth cut)' if units else ''}, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads} over {cfg.n_kv_heads} (G "
        f"{cfg.n_heads // cfg.n_kv_heads}), d_ff {cfg.d_ff}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}, moe_d_ff "
           f"{cfg.moe_d_ff}" if cfg.n_experts else "")
        + f", vocab {cfg.padded_vocab} (padded), causal {cfg.causal}, "
        f"frontend {cfg.frontend}: {n} parameters, {nbytes} bytes, drawn "
        f"in {time.perf_counter() - t0:.2f} s (peak {init_peak / 2**30:.2f}"
        f" GiB); flash launches per prefill forward "
        f"{per_forward['flash_attention']}")
    out = {"arch": arch, "params": n, "param_bytes": nbytes}

    # 1. prefill at 8 192 positions, after a short warm-up
    prefill_step(cfg, run, params, phase15_inputs(cfg, gen, dev, 512))
    batch = phase15_inputs(cfg, gen, dev, PREFILL_S)
    secs_all = []
    for rep in range(2):
        logits, secs, counts = counted(lambda: prefill_step(cfg, run, params,
                                                            batch))
        add_launches(launches, counts)
        expect(counts, f"phase {phase} {arch} prefill", **per_forward)
        if tuple(logits.shape) != (1, PREFILL_S, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
            raise AssertionError(f"phase {phase} {arch}: bad prefill logits")
        secs_all.append(secs)
        log(f"  prefill_step B=1 S={PREFILL_S} (run {rep + 1}): {secs:.4f} "
            f"s, {PREFILL_S / secs:.1f} tokens/s; flash launches "
            f"{counts['flash_attention']} (sm90 {counts['flash_sm90']}); "
            f"logits finite, {tuple(logits.shape)}")
        del logits
    out["prefill_s"] = min(secs_all)
    if cfg.n_experts:
        with MoeRecorder() as rec:
            prefill_step(cfg, run, params, batch)
        log(f"  dropped_fraction per MoE layer at S={PREFILL_S}: "
            f"{[round(c['dropped'], 6) for c in rec.calls]}")
    del batch
    torch.cuda.empty_cache()
    out["prefill_peak"] = torch.cuda.max_memory_allocated()
    if what == "forward":
        peak = torch.cuda.max_memory_allocated()
        log(f"  encoder / forward only: no decode; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        out["peak"] = peak
        del params
        torch.cuda.empty_cache()
        return out

    def tokens(B, S):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev, dtype=torch.int32)

    if not cfg.n_experts:
        # prefill vs decode replay vs the plain versions, as phase 8 (bf16,
        # reported; an MoE model routes a prefill and a decode step in
        # other groups by design, so 15e holds those against the CPU)
        consistency(cfg, params, tokens(2, 64), launches, dev, "bf16",
                    phase)

    # 2. greedy generation: B 4, 16 prompt tokens, 32 new
    prompt = tokens(4, 16)
    gout, gsecs, counts = counted(lambda: generate(cfg, run, params, prompt,
                                                   32))
    expect(counts, f"phase {phase} {arch} generate")
    if tuple(gout.shape) != (4, 32) or not bool(
            ((gout >= 0) & (gout < cfg.vocab_size)).all()):
        raise AssertionError(f"phase {phase} {arch}: bad generated tokens")
    out["decode_tps"] = 4 * 48 / gsecs
    log(f"  generate B=4, 16 + 32 tokens: {gsecs:.3f} s for 48 decode "
        f"steps, {4 * 48 / gsecs:.1f} tokens/s decoded; first row "
        f"{gout[0, :8].tolist()}")

    # 3. continuous batching: 6 requests into 4 slots
    def serve_batch():
        eng = ContinuousBatchingEngine(cfg, run, params, max_batch=4,
                                       max_len=64)
        rids = [eng.submit(list(range(2 + i, 10 + i)), max_new_tokens=8)
                for i in range(6)]
        return rids, eng.run_until_done()
    if what == "serve":
        (rids, done), csecs, counts = counted(serve_batch)
        expect(counts, f"phase {phase} {arch} continuous batching")
        if set(done) != set(rids) or any(
                not done[r].done or len(done[r].generated) != 8
                for r in rids):
            raise AssertionError(f"phase {phase} {arch}: a request did not "
                                 f"complete")
        log(f"  ContinuousBatchingEngine: 6 requests in 4 slots, 8 new "
            f"tokens each, all complete in {csecs:.3f} s ({48 / csecs:.1f} "
            f"new tokens/s incl. the batch-1 prefills)")
    peak = torch.cuda.max_memory_allocated()
    if peak >= 80e9:
        raise AssertionError(f"phase {phase} {arch}: peak {peak} bytes")
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    out["peak"] = peak
    del params
    torch.cuda.empty_cache()
    return out


def held_prefix(calls_card, calls_cpu, what):
    """Routing of one run on the card against the same run on the CPU,
    call by call: every difference must fall on an ambiguous token (a
    router gap under ROUTER_TOL on either side).  Returns, per MoE call,
    the (B, S) mask of ambiguous tokens and the counts."""
    import torch
    if len(calls_card) != len(calls_cpu):
        raise AssertionError(f"{what}: {len(calls_card)} MoE calls on the "
                             f"card, {len(calls_cpu)} on the CPU")
    masks, routed, amb, moved = [], 0, 0, 0
    for a, b in zip(calls_card, calls_cpu):
        B, S = b["shape"]
        G, T, k = b["idx"].shape
        ambiguous = torch.minimum(a["gap"], b["gap"]) < ROUTER_TOL
        differs = (a["idx"] != b["idx"]).any(-1) | (
            a["keep"] != b["keep"]).reshape(G, T, k).any(-1)
        flips = (a["idx"] != b["idx"]).any(-1)
        if bool((flips & ~ambiguous).any()):
            raise AssertionError(f"{what}: a token with router gap >= "
                                 f"{ROUTER_TOL} routes differently")
        # a flip moves the later slots of its group: from the first
        # ambiguous token of a group on, nothing is held
        bad = ambiguous | differs
        first = torch.where(bad.any(-1), bad.int().argmax(-1),
                            torch.full((G,), T))
        later = torch.arange(T)[None, :] >= first[:, None]
        masks.append(later.reshape(B, S) if B * S == G * T else later)
        routed += G * T
        amb += int(ambiguous.sum())
        moved += int(flips.sum())
    return masks, routed, amb, moved


def phase15_card_vs_cpu(dev):
    """15e: each MoE config at a reduced width in fp32 through
    prefill_step (B 2 × S 512) and generate (B 4, 16 + 16 tokens) on the
    card and, with the same weights and tokens, on the CPU."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import engine
    from repro_torch.serve.engine import generate, prefill_step
    run = RunConfig(attn_impl="pallas", use_pallas=True)
    cpu = torch.device("cpu")
    for arch, kw in REDUCED.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **kw)
        params = init_model(cfg, 1, device=dev)
        host = nest_tree({k: t.to(cpu) for k, t in flat_tree(params).items()})
        gen = torch.Generator().manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                             dtype=torch.int32)
        res = {}
        for side, p, d in (("card", params, dev), ("cpu", host, cpu)):
            with MoeRecorder() as rec:
                logits = prefill_step(cfg, run, p, {"tokens": toks.to(d)})
            res[side] = (logits.cpu(), rec.calls)
        masks, routed, amb, moved = held_prefix(
            res["card"][1], res["cpu"][1], f"15e {arch} prefill")
        held = ~torch.stack(masks).any(0)          # (B, S) positions held
        # causal: a position is held only while every earlier one is
        held = torch.cumprod(held.int(), dim=1).bool()
        v = cfg.vocab_size
        diff = (res["card"][0] - res["cpu"][0])[..., :v].abs().amax(-1)
        worst = float(diff[held].max()) if bool(held.any()) else 0.0
        log(f"  {arch} reduced (d {cfg.d_model}, G "
            f"{cfg.n_heads // cfg.n_kv_heads}, {cfg.n_experts} experts "
            f"top-{cfg.top_k}, {cfg.n_layers} layers, fp32) prefill B=2 "
            f"S=512: {routed} routed tokens over {len(masks)} MoE calls, "
            f"{amb} ambiguous (router gap < {ROUTER_TOL}), {moved} routed "
            f"differently; {int(held.sum())} of {held.numel()} positions "
            f"held, max |card - cpu| over them {worst} (tolerance "
            f"{LOGIT_TOL}); dropped "
            f"{[round(c['dropped'], 4) for c in res['card'][1]]}")
        if worst > LOGIT_TOL or int(held.sum()) == 0:
            raise AssertionError(f"15e {arch} prefill: card and CPU differ "
                                 f"by {worst} on held positions")

        # generate: the lm logits of every decode call recorded too
        prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                               dtype=torch.int32)
        gres = {}
        orig = engine.model_decode_step
        for side, p, d in (("card", params, dev), ("cpu", host, cpu)):
            lg = []

            def rec_step(*a, **k):
                out = orig(*a, **k)
                lg.append(out[0][:, 0, :v].cpu())
                return out
            engine.model_decode_step = rec_step
            try:
                with MoeRecorder() as rec:
                    toks_out = generate(cfg, run, p, prompt.to(d), 16)
            finally:
                engine.model_decode_step = orig
            gres[side] = (toks_out.cpu(), rec.calls, lg)
        n_layers = len(gres["cpu"][1]) // len(gres["cpu"][2])
        bad_call = len(gres["cpu"][2])
        for c, (a, b) in enumerate(zip(gres["card"][2], gres["cpu"][2])):
            calls = slice(c * n_layers, (c + 1) * n_layers)
            m, _, namb, _ = held_prefix(gres["card"][1][calls],
                                        gres["cpu"][1][calls],
                                        f"15e {arch} generate call {c}")
            # the prompt's calls feed given tokens: only a generated
            # token's argmax can tie
            top = torch.topk(b, 2, dim=-1).values
            tie = c >= 15 and bool(((top[:, 0] - top[:, 1])
                                    < LOGIT_TOL).any())
            if namb or tie or bool(torch.stack(m).any()):
                bad_call = c
                break
            d = float((a - b).abs().max())
            if d > LOGIT_TOL:
                raise AssertionError(f"15e {arch} generate call {c}: card "
                                     f"and CPU logits differ by {d}")
        # generated token j comes from call 15 + j's logits
        n_held = max(0, min(16, bad_call - 15))
        same = torch.equal(gres["card"][0][:, :n_held],
                           gres["cpu"][0][:, :n_held])
        log(f"  {arch} reduced generate B=4, 16 + 16: {len(gres['cpu'][2])}"
            f" decode calls, the first ambiguous one "
            f"{bad_call if bad_call < len(gres['cpu'][2]) else 'none'}; "
            f"{n_held} of 16 generated tokens held, equal {same}")
        if not same:
            raise AssertionError(f"15e {arch} generate: held tokens differ")
        del params, host
        torch.cuda.empty_cache()


def phase15_dryrun(dev, llama4):
    """15f: the dry-run CLI as a subprocess, then its one-device
    prediction for 15a's own prefill beside what 15a measured."""
    import os
    import torch
    from repro_torch.config import InputShape
    from repro_torch.launch import mesh
    from repro_torch.launch.dryrun import dryrun_one
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama4-maverick-400b-a17b", "--shape", "prefill_32k"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"15f dry-run exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    rows = json.loads(next(ln for ln in proc.stdout.splitlines()
                           if ln.startswith("[{")))
    if rows[0]["status"] != "ok":
        raise AssertionError(f"15f dry-run: {rows}")
    log(f"  python -m repro_torch.launch.dryrun --arch "
        f"llama4-maverick-400b-a17b --shape prefill_32k: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; {json.dumps(rows[0])}")
    cfg = phase15_cfg("llama4_maverick_400b_a17b", 1)
    one = dryrun_one("llama4-maverick-400b-a17b", "prefill_8k", cfg=cfg,
                     shape=InputShape("prefill_8k", PREFILL_S, 1, "prefill"),
                     mesh=mesh.make_debug_mesh(1, 1), verbose=False)
    router = cfg.n_units * cfg.d_model * cfg.n_experts   # fp32 leaves
    if one["param_bytes"] != llama4["param_bytes"] or \
            one["param_bytes"] != llama4["params"] * 2 + router * 2:
        raise AssertionError(f"15f: dry-run parameter bytes "
                             f"{one['param_bytes']}, the card's tree "
                             f"{llama4['param_bytes']}")
    log(f"  dry-run of 15a's prefill on a 1 x 1 mesh: parameter bytes "
        f"{one['param_bytes']} = count_params {llama4['params']} x 2 + the "
        f"fp32 router's {router} x 2, equal to the tree on the card; "
        f"argument bytes {one['arg_bytes']}, temporaries "
        f"{one['temp_bytes']}, in all {one['bytes_per_device']} bytes "
        f"({one['bytes_per_device'] / 2**30:.2f} GiB) against the prefill's "
        f"measured peak {llama4['prefill_peak']} bytes "
        f"({llama4['prefill_peak'] / 2**30:.2f} GiB); "
        f"{one['hlo_flops_per_dev'] / 1e12:.3f} Tflop traced "
        f"(MODEL_FLOPS {one['model_flops'] / 1e12:.3f}): t_compute "
        f"{one['t_compute_s'] * 1e3:.2f} ms, t_memory "
        f"{one['t_memory_s'] * 1e3:.2f} ms at H100 SXM rates, against the "
        f"measured {llama4['prefill_s'] * 1e3:.2f} ms on "
        f"{torch.cuda.get_device_name(0)}")


def phase_moe_frontends(dev, launches):
    """Phase 15 (see the module docstring)."""
    import torch
    log(f"  times on {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{smi_line()}")
    results = {}
    for phase, arch, units, what in PHASE15:
        t = time.perf_counter()
        log(f"phase {phase}: {arch}, full width"
            + (f", {units} unit(s)" if units else " and depth")
            + ", bf16, attn_impl='pallas', use_pallas=True")
        results[arch] = phase15_model(phase, arch, units, what, dev,
                                      launches)
        log(f"  {phase} {arch} in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log(f"phase 15e: the MoE configs at a reduced width in fp32, card "
        f"against CPU (router tolerance {ROUTER_TOL}, logits {LOGIT_TOL})")
    phase15_card_vs_cpu(dev)
    log(f"  15e in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log("phase 15f: the dry-run")
    phase15_dryrun(dev, results["llama4_maverick_400b_a17b"])
    log(f"  15f in {time.perf_counter() - t:.1f} s")


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
    ptxas_by_kernel(libs["replay_ring"], ("ring_apply_whatif_kernel",
                                          "simple_kernel"))
    ptxas_by_kernel(libs["ps_update"], ("simple_kernel",))
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
    time_copy(dev)
    time_paper_shape(dev)
    t_flash = time_flash(dev, 32768)
    if max(r["ms"] for r in t_flash.values()) > 2000:
        log("  over 2 s per launch at S = 32768: timed at S = 8192 instead")
        t_flash = time_flash(dev, 8192)
    time_flash(dev, 8192, H=32, KV=32, D=112)    # zamba2_7b's attention
    t_ssm, t_wkv = time_scans(dev)
    t_zamba2 = time_zamba2_instruct(dev)    # rows 4″, 5′, 7 and 8
    t_granite = time_granite_moe(dev)       # rows 9 and 10
    log(f"  phase 7 in {time.perf_counter() - t7:.1f} s")

    # phase 12's CPU twins run beside the card from here on (phases 8-12),
    # after every kernel timing of phase 7
    import tempfile
    twins_dir = tempfile.TemporaryDirectory(prefix="cpu_twins_")
    twin_pool, cpu_runs = start_cpu_twins(twins_dir.name)
    log(f"  phase 12's {len(cpu_runs)} CPU twins started in "
        f"{CPU_TWIN_WORKERS} worker processes")

    def stop_twins():
        twin_pool.shutdown(cancel_futures=True)
        twins_dir.cleanup()

    try:
        for phase, arch, fp32_limit in SERVING:
            log(f"phase {phase}: serving — {arch}, full width and depth, "
                f"bf16, attn_impl='pallas', use_pallas=True")
            tp = time.perf_counter()
            phase_serving(phase, arch, fp32_limit, dev, launches)
            log(f"  phase {phase} in {time.perf_counter() - tp:.1f} s")

        with tempfile.TemporaryDirectory(prefix="results_torch_") as keep:
            log("phase 11: the paper cells elastic, topology and serve at "
                "their default params through campaign.run_cell, against "
                "benchmarks/results/*.json")
            t11 = time.perf_counter()
            phase_cells(dev, launches, keep)
            log(f"  phase 11 in {time.perf_counter() - t11:.1f} s")
            log("phase 12: the rest of the paper campaign (table1, fig8, "
                "fig4, fig5, fig6_7, table2, baselines, sim_engine, "
                "table3_4, kernels) and the smoke campaign through "
                "campaign.run_cell, against benchmarks/results/*.json and "
                "the same cells on the CPU")
            t12 = time.perf_counter()
            phase_paper_cells(dev, launches, keep, cpu_runs)
            stop_twins()
            log(f"  phase 12 in {time.perf_counter() - t12:.1f} s")
            log("phase 13: the ring cell, SPMD placement, the distributed "
                "cell, table3_4 with five deps and bench_guard")
            t13 = time.perf_counter()
            phase_ring_distributed(dev, launches, Path(keep))
            log(f"  phase 13 in {time.perf_counter() - t13:.1f} s")
            log("phase 14: the training engines at qwen2_1_5b's full "
                "width, fidelity, checkpoints, the train CLI, the cnn cell")
            t14 = time.perf_counter()
            phase_training(dev, launches, Path(keep))
            log(f"  phase 14 in {time.perf_counter() - t14:.1f} s")
    finally:
        stop_twins()
    log("phase 15: MoE and the modality frontends at full width "
        "(llama4_maverick one unit, arctic 2 layers, qwen3_14b, "
        "starcoder2_7b, hubert_xlarge, internvl2_2b), card against CPU, "
        "the dry-run")
    t15 = time.perf_counter()
    phase_moe_frontends(dev, launches)
    log(f"  phase 15 in {time.perf_counter() - t15:.1f} s")

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
    for name, source, replaces in (
            ("flash_attention_d224",
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:123"),
            ("ssm_scan_g2", "src/repro_torch/kernels/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan.py:85"),
            ("mamba_in", "src/repro_torch/kernels/csrc/mamba_glue.cu", None),
            ("mamba_out", "src/repro_torch/kernels/csrc/mamba_glue.cu",
             None),
            ("rms_norm", "src/repro_torch/kernels/csrc/rms_norm.cu", None),
            ("rms_norm_cat", "src/repro_torch/kernels/csrc/rms_norm.cu",
             None)):
        t = t_zamba2[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, **t})
    for name, t in t_granite.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/moe_route.cu",
                        "replaces": None, **t})
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
