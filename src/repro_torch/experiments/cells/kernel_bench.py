"""Cell ``kernels`` of the port (counterpart of
``repro/experiments/cells/kernel_bench.py``) — kernel-level benchmark on
``device``: chunked vs naive attention and chunked vs recurrent SSD (plain
PyTorch on either device), the fused ``ps_apply`` against the unfused
chain with its analytic HBM-traffic saving, and the ``ring_apply`` event
against the stock gather → update → row-write chain, fp32 and bf16.  On
the card the fused rows time the CUDA kernels; on the CPU their plain
versions.

Timings are real and so non-deterministic: the cell re-times on every
execution; only the correctness booleans and the analytic traffic model
are claim-checked.  ``skip_quick`` because the timings are already tiny.
"""

from __future__ import annotations

import time

from repro_torch.experiments.registry import Cell, Claim, emit, register_cell


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _time(fn, *args, dev, reps: int = 5) -> float:
    fn(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e6   # µs


def compute(device="cuda", **params):
    import torch

    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    out = {}

    # --- attention: naive vs chunked (memory-bound difference) -------------
    from repro_torch.models.attention import chunked_attention, naive_attention
    B, S, H, KV, D = 1, 1024, 8, 4, 64
    q, k, v = normal(B, S, H, D), normal(B, S, KV, D), normal(B, S, KV, D)
    t_naive = _time(lambda q, k, v: naive_attention(q, k, v, causal=True),
                    q, k, v, dev=dev)
    t_chunk = _time(lambda q, k, v: chunked_attention(
        q, k, v, causal=True, q_chunk=256, kv_chunk=256), q, k, v, dev=dev)
    out["attention"] = {"naive_us": t_naive, "chunked_us": t_chunk}
    emit("kernel/attention_naive", f"{t_naive:.0f}us", f"S={S}")
    emit("kernel/attention_chunked", f"{t_chunk:.0f}us",
         "peak-mem O(S*chunk) vs O(S^2)")

    # --- ssd: chunked vs recurrent ------------------------------------------
    from repro_torch.kernels.ref import ssm_ref
    from repro_torch.models.ssm import ssd_chunked
    Bt, Ss, Hs, P, N = 2, 2048, 4, 32, 32
    x = normal(Bt, Ss, Hs, P) * 0.3
    a = -normal(Bt, Ss, Hs).abs() * 0.1
    Bm = normal(Bt, Ss, N) * 0.3
    Cm = normal(Bt, Ss, N) * 0.3
    t_rec = _time(lambda *t: ssm_ref(*t)[0], x, a, Bm, Cm, dev=dev)
    t_chk = _time(lambda *t: ssd_chunked(*t, chunk=128)[0], x, a, Bm, Cm,
                  dev=dev)
    out["ssd"] = {"recurrent_us": t_rec, "chunked_us": t_chk,
                  "speedup": t_rec / t_chk}
    emit("kernel/ssd_recurrent", f"{t_rec:.0f}us", f"S={Ss}")
    emit("kernel/ssd_chunked", f"{t_chk:.0f}us",
         f"speedup={t_rec/t_chk:.1f}x")

    # --- ps_update fused traffic model --------------------------------------
    # Unfused PS applyUpdate: read W, read V, read each of c grads, write
    # partial sums (c-1 round trips), write V, write W
    #   = (2c + 3) * model_bytes   (sum materialized between each add)
    # Fused kernel: read W, V, c grads once; write W, V once
    #   = (c + 4) * model_bytes
    for c in (2, 4, 8, 15, 30):
        unfused = 2 * c + 3
        fused = c + 4
        out[f"ps_update_c={c}"] = {"unfused_passes": unfused,
                                   "fused_passes": fused,
                                   "traffic_reduction": unfused / fused}
        emit(f"kernel/ps_update_c={c}/traffic_reduction",
             f"{unfused/fused:.2f}x",
             f"{unfused}->{fused} model-size HBM passes")

    # the seed API's momentum wrapper against the plain reference update
    # (the CUDA kernel on the card; the key keeps the reference's name)
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    Dp = 1 << 16
    w = normal(Dp)
    vv = torch.zeros(Dp, device=dev)
    g = normal(4, Dp)
    coef = torch.tensor([1.0, 0.5, 0.33, 0.25], device=dev)
    w2, v2 = ops.ps_update(w, vv, g, coef, momentum=0.9, lr=0.1)
    w2r, v2r = kref.ps_update_ref(w, vv, g, coef, momentum=0.9, lr=0.1)
    ok = bool(torch.allclose(w2, w2r, atol=1e-5))
    emit("kernel/ps_update_interpret_allclose", ok, "")
    out["ps_update_allclose"] = ok

    # --- ps_update fused vs unfused: TIMED ----------------------------------
    # unfused = the seed's semantics: materialize each partial sum of the
    # staleness-weighted reduction, then the optimizer step (2c+3 model-size
    # passes).  fused = one ps_apply launch over the same flat buffer.
    from repro_torch.kernels import ps_update as _psu
    from repro_torch.optim import UpdateSpec
    Db, cb = 1 << 18, 8
    wb = normal(Db)
    vb = torch.zeros(Db, device=dev)
    gb = normal(cb, Db) * 0.1
    coefb = normal(cb).abs() + 0.1
    lrsb = torch.full((cb,), 0.05, device=dev)
    spec = UpdateSpec(optimizer="momentum")

    def unfused(w, v, g, coef):
        acc = torch.zeros_like(w)
        for i in range(cb):                  # c materialized partial sums
            acc = acc + coef[i] * g[i]
        v = spec.momentum * v + acc
        return w - 0.05 * v, v

    def fused(w, v, g, coef, lrs):
        return _psu.ps_apply(w, v, g, coef, lrs, spec=spec, mode="combine")

    wu, vu = unfused(wb, vb, gb, coefb)
    wf, vf = fused(wb, vb, gb, coefb, lrsb)
    match = bool(torch.allclose(wu, wf, atol=1e-5)
                 and torch.allclose(vu, vf, atol=1e-5))
    t_unfused = _time(unfused, wb, vb, gb, coefb, dev=dev)
    t_fused = _time(fused, wb, vb, gb, coefb, lrsb, dev=dev)
    out["ps_update_timed"] = {
        "D": Db, "c": cb, "unfused_us": t_unfused, "fused_us": t_fused,
        "cpu_ratio": t_unfused / t_fused, "allclose": match,
        "note": f"{dev.type} wall clock (key name kept from the reference: "
                f"the unfused/fused ratio on this device)"}
    emit("kernel/ps_update_unfused", f"{t_unfused:.0f}us",
         f"D=2^18 c={cb} multi-pass")
    emit("kernel/ps_update_fused", f"{t_fused:.0f}us",
         f"one ps_apply launch, allclose={match}")

    # --- the ring event vs the stock chain (DESIGN.md §12) -----------------
    # One fused ring-read -> combine -> optimizer update -> ring-write event
    # (kernels/replay_ring.ring_apply, in place) vs the stock chain: gather
    # row, apply_event_flat, row write.  Also the bf16 compressed ring with
    # its error-feedback residue (half the ring traffic; the fp32 master
    # chain stays exact).
    from repro_torch.kernels import replay_ring
    from repro_torch.launch.roofline import ring_bytes as _ring_bytes
    from repro_torch.optim import apply_event_flat
    spec_mk = UpdateSpec(optimizer="momentum")
    Kr, cr = 8, 8
    Dr = 1 << 18                # a whole number of the reference's tiles
    ring0 = normal(Kr, Dr)
    s_mk = torch.zeros(Dr, device=dev)
    g_mk = normal(cr, Dr) * 0.1
    coef_mk = torch.full((cr,), 1.0 / cr, device=dev)
    lrs_mk = torch.full((cr,), 0.05, device=dev)
    idx_mk = torch.tensor([2, 3], dtype=torch.int32, device=dev)

    def stock_event(ring, s):
        w, s2 = apply_event_flat(spec_mk, ring[2], s, g_mk, coef_mk, lrs_mk,
                                 "combine")
        ring[3] = w
        return ring, s2

    def mega_event(ring, s):
        ring2, s2, _ = replay_ring.ring_apply(
            ring, s, None, g_mk, coef_mk, lrs_mk, idx_mk, spec=spec_mk,
            mode="combine")
        return ring2, s2

    rs_, ss_ = stock_event(ring0.clone(), s_mk.clone())
    rm_, sm_ = mega_event(ring0.clone(), s_mk.clone())
    mk_bitwise = bool(torch.equal(rs_, rm_) and torch.equal(ss_, sm_))
    t_stock = _time(stock_event, ring0.clone(), s_mk.clone(), dev=dev)
    t_mega = _time(mega_event, ring0.clone(), s_mk.clone(), dev=dev)

    ring_bf = ring0.to(torch.bfloat16)
    res0 = ring0[2] - ring_bf[2].to(torch.float32)

    def mega_event_bf16(ring, s, res):
        return replay_ring.ring_apply(
            ring, s, res, g_mk, coef_mk, lrs_mk, idx_mk, spec=spec_mk,
            mode="combine")
    rb_, sb_, resb_ = mega_event_bf16(ring_bf.clone(), s_mk.clone(),
                                      res0.clone())
    # master chain: bf16 row + residue reconstructs the exact fp32 update
    master = rb_[3].to(torch.float32) + resb_
    bf16_exact = bool(torch.equal(master, rs_[3]))
    t_bf16 = _time(mega_event_bf16, ring_bf.clone(), s_mk.clone(),
                   res0.clone(), dev=dev)

    out["replay_megakernel"] = {
        "D": Dr, "K": Kr, "c": cr,
        "stock_us": t_stock, "megakernel_us": t_mega, "bf16_us": t_bf16,
        "fp32_bitwise": mk_bitwise, "bf16_master_exact": bf16_exact,
        "ring_bytes_fp32": _ring_bytes(Kr, Dr, "fp32",
                                       "momentum")["total_bytes"],
        "ring_bytes_bf16": _ring_bytes(Kr, Dr, "bf16",
                                       "momentum")["total_bytes"],
        "note": f"{dev.type} wall clock; megakernel = one ring_apply "
                f"launch (key names kept from the reference)"}
    emit("kernel/replay_megakernel_fp32", f"{t_mega:.0f}us",
         f"stock={t_stock:.0f}us bitwise={mk_bitwise} D=2^18 c={cr} K={Kr}")
    emit("kernel/replay_megakernel_bf16", f"{t_bf16:.0f}us",
         f"master_exact={bf16_exact} ring_bytes "
         f"{out['replay_megakernel']['ring_bytes_fp32']}"
         f"->{out['replay_megakernel']['ring_bytes_bf16']}")
    return [], out


register_cell(Cell(
    name="kernels", result="kernel_bench",
    title="Kernel bench: attention/SSD plain paths + fused ps_apply, "
          "ring_apply",
    compute=compute, skip_quick=True,
    claims=(
        Claim("ps_update_interpret_allclose",
              lambda d: d["ps_update_allclose"]),
        Claim("ps_update_fused_allclose",
              lambda d: d["ps_update_timed"]["allclose"]),
        Claim("megakernel_fp32_bitwise",
              lambda d: d["replay_megakernel"]["fp32_bitwise"]),
        Claim("megakernel_bf16_master_exact",
              lambda d: d["replay_megakernel"]["bf16_master_exact"]),
        Claim("fused_traffic_model_monotone",
              lambda d: (d["ps_update_c=30"]["traffic_reduction"]
                         > d["ps_update_c=2"]["traffic_reduction"])),
    )))
