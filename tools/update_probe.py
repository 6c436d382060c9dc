#!/usr/bin/env python3
"""What holds ``ring_apply`` and ``ps_apply`` short of their bytes bound,
measured on one NVIDIA card at the wide lanes' shape (D 10 000 004, c 128).

    python3 tools/update_probe.py [--parent DIR] [--whatif] [--heat S]
        [--reps N] [--out PATH]

Times, with CUDA events (``chip_smoke.cuda_ms``), each in turn and then in
reverse order:

* the update kernels in the four instances ``chip_smoke.py`` phase 7
  times (``ring_apply`` fp32 sgd combine, ``ring_apply`` bf16 sgd combine
  with its residue, ``ps_apply`` sgd and momentum combine) on each
  schedule — the kernels' own (``csrc/update_event.cuh``'s
  ``simple_kernel``, 4-wide) and a bulk-copy pipeline that only this
  probe builds (``tools/update_probe_pipelined.cuh``, the same per-element
  operands ``RingOp`` / ``PsOp``) — each with its ptxas registers (the
  instance's own line of the build log);
* a read-only kernel built from the same headers: the slot-order sum
  Σⱼ coefⱼ·gⱼ of the (c, D) gradients, written as D floats (no w, no
  state), on each schedule, over g as it is and over a g whose row stride
  is padded to 128 bytes (rows 16 mod 128 bytes apart at D 10 000 004);
  on the pipelined schedule also with the plan's constants set by ``-D``
  flags (``SUM_VARIANTS``: the first design, spans in place of dealt
  tiles, unaligned copies, other tiles, stages and blocks per SM,
  evict-first L2 hints); then both schedules at 1 to 16 tiles per SM;
* ``torch.addmv`` computing the sgd combine (w − lr·gᵀcoef), ``g.sum(0)``
  (a PyTorch reduction reading the same 5.12 GB) and a device-to-device
  copy of 5.12 GB: the card's practical rate, (bytes read + written) /
  time, beside the 3.35 TB/s of the data sheet;
* ``--heat S``: the instances and the yardsticks again after S seconds of
  bf16 matmuls (clocks, temperatures and power printed);
* ``--whatif``: the same after one ``ring_apply_whatif`` timing at D
  1 777 086 464, as phase 7 times it, on fresh operands;
* the paper shape (D 2 762, c 30, momentum): one ``ring_apply`` launch on
  one ring and 4 lanes in one launch, through the wrapper and called
  directly, on the host clock and as device time (100 launches in a CUDA
  graph).

``--parent DIR``: a directory holding an older ``replay_ring.cu``,
``ps_update.cu`` and ``update_event.cuh`` with the older C interface (no
lane axis): its four instances and its paper-shape launches (4 lanes as 4
launches) are timed beside this tree's, in turns.

Every kernel's output is held against its plain version first (bitwise).
Prints one line per measurement (``--out PATH``: also as JSON).  Exits
nonzero without a card.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
TOOLS = ROOT / "tools"
OUT = ROOT / "build" / "update_probe"
D, C = 10_000_004, 128
PAPER_D, PAPER_C, PAPER_LANES = 2_762, 30, 4
# the schedules this probe launches: the kernels' own with 1- and 4-wide
# loads, and update_probe_pipelined.cuh's
SIMPLE1, SIMPLE4, PIPELINED = 0, 1, 2
PIPE_TILE = 4096                 # its tile in columns (PIPE_T) by default

# the read-only slot-order sum, on either schedule
SUM_SOURCE = r'''
#include "update_probe_pipelined.cuh"
using namespace update_math;
namespace {
struct SumOp {
  float* out;
  template <int V>
  __device__ __forceinline__ void load(int, int64_t, float* w,
                                       float* s) const {
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = s[v] = 0.f;
  }
  template <int V>
  __device__ __forceinline__ void store(int, int64_t e, const float* w,
                                        const float*) const {
    st<V>(out + e, w);
  }
  __device__ __forceinline__ void event(float& w, float&, float g, float,
                                        float, float) const {
    w = g;
  }
};
}  // namespace
extern "C" int probe_sum(const void* g, const void* coef, void* out,
                         long long D, long long ldg, int c, int path,
                         void* stream) {
  const EventArgs a{static_cast<const float*>(g),
                    static_cast<const float*>(coef),
                    static_cast<const float*>(coef), D, ldg, 1, c, 0, 0,
                    0.f, 0.f};
  const SumOp op{static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(path == 2 ? update_probe::launch_pipelined<SumOp, false>(
                               op, a, st)
                         : launch_events<SumOp, false>(op, a, path, st));
}
extern "C" const char* probe_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
'''

# the instances on the pipelined schedule: the kernels' own sources with
# their per-element operands, and a combine launch through the probe's
# header (sgd and momentum)
RING_SOURCE = r'''
#include "replay_ring.cu"
#include "update_probe_pipelined.cuh"
using namespace update_math;
namespace {
template <typename T, int OPT, bool EF>
cudaError_t ring_pipe(void* ring, void* s, void* res, const void* idx,
                      int64_t D, int K, const EventArgs& a,
                      cudaStream_t st) {
  const RingOp<T, OPT, EF> op{static_cast<T*>(ring), static_cast<float*>(s),
                              static_cast<float*>(res),
                              static_cast<const int32_t*>(idx), D, K};
  return update_probe::launch_pipelined<RingOp<T, OPT, EF>, false>(op, a,
                                                                    st);
}
template <typename T>
cudaError_t ring_opt(int opt, int ef, void* ring, void* s, void* res,
                     const void* idx, int64_t D, int K, const EventArgs& a,
                     cudaStream_t st) {
  if (opt == OPT_SGD)
    return ef ? ring_pipe<T, OPT_SGD, true>(ring, s, res, idx, D, K, a, st)
              : ring_pipe<T, OPT_SGD, false>(ring, s, res, idx, D, K, a, st);
  return ef ? ring_pipe<T, OPT_MOMENTUM, true>(ring, s, res, idx, D, K, a, st)
            : ring_pipe<T, OPT_MOMENTUM, false>(ring, s, res, idx, D, K, a,
                                                st);
}
}  // namespace
extern "C" int probe_ring_pipelined(void* ring, int ring_bf16, void* s,
                                    void* res, const void* g,
                                    const void* coef, const void* lrs,
                                    const void* idx, long long D, int K,
                                    int c, int opt, float momentum,
                                    float eps, void* stream) {
  const EventArgs a{static_cast<const float*>(g),
                    static_cast<const float*>(coef),
                    static_cast<const float*>(lrs), D, D, 1, c, 0, c,
                    momentum, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  return (int)(ring_bf16 ? ring_opt<__nv_bfloat16>(opt, ef, ring, s, res,
                                                   idx, D, K, a, st)
                         : ring_opt<float>(opt, ef, ring, s, res, idx, D, K,
                                           a, st));
}
'''

PS_SOURCE = r'''
#include "ps_update.cu"
#include "update_probe_pipelined.cuh"
using namespace update_math;
namespace {
template <int OPT>
cudaError_t ps_pipe(const void* w, const void* s, void* w_out, void* s_out,
                    const EventArgs& a, cudaStream_t st) {
  const PsOp<OPT> op{static_cast<const float*>(w),
                     static_cast<const float*>(s), static_cast<float*>(w_out),
                     static_cast<float*>(s_out)};
  return update_probe::launch_pipelined<PsOp<OPT>, false>(op, a, st);
}
}  // namespace
extern "C" int probe_ps_pipelined(const void* w, const void* s,
                                  const void* g, const void* coef,
                                  const void* lrs, void* w_out, void* s_out,
                                  long long D, int c, int opt,
                                  float momentum, float eps, void* stream) {
  const EventArgs a{static_cast<const float*>(g),
                    static_cast<const float*>(coef),
                    static_cast<const float*>(lrs), D, D, 1, c, 0, 0,
                    momentum, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(opt == OPT_SGD
                   ? ps_pipe<OPT_SGD>(w, s, w_out, s_out, a, st)
                   : ps_pipe<OPT_MOMENTUM>(w, s, w_out, s_out, a, st));
}
'''

# the sum's variants: (name, {macro: value}) — the pipelined plan's
# constants (tools/update_probe_pipelined.cuh: PROBE_PIPE_*)
SUM_VARIANTS = {
    "sum": {},                               # the plan as it is
    # the first design: spans of the B * D columns, unaligned copies,
    # tiles of 1 024 columns, 6 stages of 8 rows
    "sum_first": dict(INTERLEAVE=0, ALIGN=0, VECS=1, R=8, STAGES=6,
                      MAX_SLOTS=4096),
    "sum_spans": dict(INTERLEAVE=0),
    "sum_unaligned": dict(ALIGN=0),
    "sum_t1024_r8": dict(VECS=1, R=8),
    "sum_t2048_r4": dict(VECS=2, R=4),
    "sum_t4096_r4": dict(R=4, MAX_SLOTS=2048),
    "sum_t8192_r1": dict(VECS=8, R=1),
    "sum_s2": dict(STAGES=2),
    "sum_s4": dict(STAGES=4),
    "sum_s6": dict(STAGES=6, MAX_SLOTS=2048),
    "sum_2_blocks": dict(BLOCKS=2, MAX_SLOTS=1024),
    "sum_evict_first": dict(EVICT_FIRST=1),
}


def clocks() -> str:
    """The card's clocks, temperatures and power draw now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "temperature.memory,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _start(cu: Path, so: Path, includes, flags):
    from repro_torch.kernels import build
    so.parent.mkdir(parents=True, exist_ok=True)
    incs = [a for d in includes for a in ("-I", str(d))]
    return subprocess.Popen(
        [build.nvcc(), *flags, *incs, "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc, what: str) -> str:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {what}:\n{log}")
    return log


def registers(log: str, cufilt: Path) -> dict:
    """{demangled entry function: registers} from ptxas's -v lines."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = subprocess.run([str(cufilt), m.group(1)],
                                 capture_output=True, text=True,
                                 check=True).stdout.strip()
            continue
        r = re.search(r"Used (\d+) registers", ln)
        if r and cur is not None:
            out[cur] = int(r.group(1))
    return out


def _norm(name: str) -> str:
    for old, new in (("(bool)0", "false"), ("(bool)1", "true"),
                     ("(int)", ""), (" ", "")):
        name = name.replace(old, new)
    return name


def instance_regs(regs: dict, pattern: str, parent: bool = False):
    """The registers of the one instance whose demangled name holds
    ``pattern`` (spaces and casts ignored), of this tree's libraries or
    the parent's, or None."""
    hit = [v for k, v in regs.items() if _norm(pattern) in _norm(k)
           and k.startswith("parent ") == parent]
    if len(hit) != 1:
        head = pattern.split("<")[0]
        print(f"  ({len(hit)} ptxas instances match {pattern!r}; e.g. "
              f"{[k for k in regs if head in k][:2]})", flush=True)
        return None
    return hit[0]


def build_all(parent):
    """Every library this probe times, one nvcc each, all started
    together: {name: (CDLL, ptxas log)}."""
    from repro_torch.kernels import build
    flags = build.flags("replay_ring")
    jobs = {}       # name: (source, library, include dirs, extra flags)
    for name in ("replay_ring", "ps_update"):
        jobs[name] = (CSRC / f"{name}.cu", OUT / f"{name}.so", [CSRC], [])
    for name, text in (("probe_ring", RING_SOURCE), ("probe_ps", PS_SOURCE),
                       *((n, SUM_SOURCE) for n in SUM_VARIANTS)):
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "probe.cu").write_text(text)
        defs = [f"-DPROBE_PIPE_{k}={v}" for k, v in
                SUM_VARIANTS.get(name, {}).items()]
        jobs[name] = (d / "probe.cu", d / "probe.so", [CSRC, TOOLS], defs)
    if parent is not None:
        for name in ("replay_ring", "ps_update"):
            jobs[f"parent_{name}"] = (parent / f"{name}.cu",
                                      OUT / f"parent_{name}.so", [parent],
                                      [])
    procs = {n: _start(cu, so, inc, [*flags, *defs])
             for n, (cu, so, inc, defs) in jobs.items()}
    out = {}
    for n, p in procs.items():
        try:
            log = _finish(p, n)
        except RuntimeError as err:     # a variant that does not build
            if n not in SUM_VARIANTS or n == "sum":
                raise
            print(f"  {n}: not built, {str(err)[-300:]}", flush=True)
            continue
        out[n] = (ctypes.CDLL(str(jobs[n][1])), log)
    return out


def declare(libs) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    for name, (lib, _) in libs.items():
        if name == "replay_ring":
            lib.ring_apply.argtypes = [p, i, p, p, p, p, p, p, ll, i, i, i,
                                       i, i, i, f, f, i, p]
        elif name == "parent_replay_ring":
            lib.ring_apply.argtypes = [p, i, p, p, p, p, p, p, ll, i, i, i,
                                       f, f, i, p]
        elif name.endswith("ps_update"):
            lib.ps_apply.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, f, f,
                                     i, p]
        elif name == "probe_ring":
            lib.probe_ring_pipelined.argtypes = [p, i, p, p, p, p, p, p, ll,
                                                 i, i, i, f, f, p]
        elif name == "probe_ps":
            lib.probe_ps_pipelined.argtypes = [p, p, p, p, p, p, p, ll, i, i,
                                               f, f, p]
        else:
            lib.probe_sum.argtypes = [p, p, p, ll, ll, i, i, p]
        for fn in ("ring_apply", "ps_apply", "probe_sum",
                   "probe_ring_pipelined", "probe_ps_pipelined"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = i


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("update_probe.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--whatif", action="store_true",
                    help="then one ring_apply_whatif timing as phase 7's, "
                         "and the instances, the sum and the yardsticks on "
                         "fresh operands")
    ap.add_argument("--heat", type=float, default=0.0,
                    help="then seconds of bf16 matmuls, and the four "
                         "instances, addmv and the copy again")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.optim import UpdateSpec, backends

    dev = torch.device("cuda")
    smi = cs.smi_line()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = build_all(args.parent)
    print(f"clocks, temperatures, power: {clocks()}", flush=True)
    declare(libs)
    cufilt = Path(build.nvcc()).with_name("cu++filt")
    stream = torch.cuda.current_stream().cuda_stream
    P = PIPELINED
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def record(name, ms, nbytes, extra=None):
        row = {"name": name, "ms": ms, "bytes": nbytes,
               "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3,
               "TB_per_s": nbytes / (ms * 1e-3) / 1e12, **(extra or {})}
        row["share_of_bound"] = row["bound_ms"] / ms
        rows.append(row)
        print(f"  {name:44s} {ms:.4f} ms  {row['TB_per_s']:.3f} TB/s  "
              f"{row['share_of_bound']:.3f} of the bound"
              + (f"  {extra}" if extra else ""), flush=True)

    def check(rc, lib):
        if rc:
            raise RuntimeError(lib.probe_error_string(rc).decode()
                               if hasattr(lib, "probe_error_string")
                               else f"launch failed ({rc})")

    # ---- the four instances, on each schedule (and the parent's) ----------
    ring_lib, ring_log = libs["replay_ring"]
    ps_lib, ps_log = libs["ps_update"]
    regs = {**registers(ring_log, cufilt), **registers(ps_log, cufilt)}
    regs.update({k: v for n in ("probe_ring", "probe_ps")
                 for k, v in registers(libs[n][1], cufilt).items()
                 if "pipelined_kernel" in k})
    if args.parent is not None:
        regs.update({f"parent {k}": v for n in ("parent_replay_ring",
                                                "parent_ps_update")
                     for k, v in registers(libs[n][1], cufilt).items()})
    KEYS = (("ring fp32 sgd", "ring", "fp32", "sgd"),
            ("ring bf16 sgd+res", "ring", "bf16", "sgd"),
            ("ps sgd", "ps", "fp32", "sgd"),
            ("ps momentum", "ps", "fp32", "momentum"))

    def make_instances():
        """Each instance's operands, drawn as chip_smoke.py phase 7 draws
        them (K 2): {key: (kind, dtype, opt, operands, bytes)}."""
        out = {}
        for key, kind, dtype, opt in KEYS:
            if kind == "ring":
                ops = cs.event_inputs(D, C, 2, opt, dtype, False, 21, dev)
                nbytes = cs.event_cost(ops, opt, "combine", False)[0]
            else:
                ops = cs.ps_inputs(D, C, opt, 22, dev)
                nbytes = cs.ps_cost(ops, opt, "combine")[0]
            out[key] = (kind, dtype, opt, ops, nbytes)
        return out

    def launcher(inst, key, path, parent=False):
        """(one launch, the outputs it writes out of place or None)."""
        kind, dtype, opt, ops, _ = inst[key]
        code = build.OPT_CODES[opt]
        if path == P:
            return pipelined_launcher(inst, key)
        lib = libs[("parent_" if parent else "")
                   + ("replay_ring" if kind == "ring" else "ps_update")][0]
        if kind == "ring":
            ring = ops["ring"]
            tail = ((D, C, code, 0, 0.9, 1e-8, 1, stream) if parent else
                    (D, 2, 1, C, 0, code, 0, 0.9, 1e-8, path, stream))
            return (lambda: check(lib.ring_apply(
                ring.data_ptr(), int(dtype == "bf16"), build.ptr(ops["s"]),
                build.ptr(ops["res"]), ops["g"].data_ptr(),
                ops["coef"].data_ptr(), ops["lrs"].data_ptr(),
                ops["idx"].data_ptr(), *tail), lib)), None
        w_out = torch.empty_like(ops["w"])
        s_out = None if ops["s"] is None else torch.empty_like(ops["s"])
        last = 1 if parent else path
        return (lambda: check(lib.ps_apply(
            ops["w"].data_ptr(), build.ptr(ops["s"]), ops["g"].data_ptr(),
            ops["coef"].data_ptr(), ops["lrs"].data_ptr(), w_out.data_ptr(),
            build.ptr(s_out), D, C, code, 0, 0.9, 1e-8, last, stream),
            lib)), (w_out, s_out)

    def pipelined_launcher(inst, key):
        """:func:`launcher` on update_probe_pipelined.cuh's schedule."""
        kind, dtype, opt, ops, _ = inst[key]
        code = build.OPT_CODES[opt]
        if kind == "ring":
            lib = libs["probe_ring"][0]
            ring = ops["ring"]
            return (lambda: check(lib.probe_ring_pipelined(
                ring.data_ptr(), int(dtype == "bf16"), build.ptr(ops["s"]),
                build.ptr(ops["res"]), ops["g"].data_ptr(),
                ops["coef"].data_ptr(), ops["lrs"].data_ptr(),
                ops["idx"].data_ptr(), D, 2, C, code, 0.9, 1e-8, stream),
                lib)), None
        lib = libs["probe_ps"][0]
        w_out = torch.empty_like(ops["w"])
        s_out = None if ops["s"] is None else torch.empty_like(ops["s"])
        return (lambda: check(lib.probe_ps_pipelined(
            ops["w"].data_ptr(), build.ptr(ops["s"]), ops["g"].data_ptr(),
            ops["coef"].data_ptr(), ops["lrs"].data_ptr(), w_out.data_ptr(),
            build.ptr(s_out), D, C, code, 0.9, 1e-8, stream),
            lib)), (w_out, s_out)

    def held(inst, key, fn, outs):
        """One launch, held bitwise against the plain version."""
        kind, dtype, opt, ops, _ = inst[key]
        spec = UpdateSpec(opt)
        if kind == "ring":
            kept = {k: None if v is None else v.clone() for k, v in
                    ops.items() if k in ("ring", "s", "res")}
            fn()
            want = backends.apply_event_ring(
                spec, kept["ring"], kept["s"], kept["res"], ops["g"],
                ops["coef"], ops["lrs"], ops["idx"][0], ops["idx"][1])
            cs.assert_bitwise([ops["ring"], ops["s"], ops["res"]], want, key)
        else:
            fn()
            cs.assert_bitwise(list(outs), cs.ps_plain(ops, spec, "combine"),
                              key)

    def regs_of(key, path, parent):
        kind, _, opt = next((k, d, o) for n, k, d, o in KEYS if n == key)
        if parent:
            return instance_regs(
                regs, "ring_apply_kernel<float,0,false,false,4>"
                if key == "ring fp32 sgd" else
                "ring_apply_kernel<__nv_bfloat16,0,false,true,4>"
                if kind == "ring" else
                f"ps_apply_kernel<{build.OPT_CODES[opt]},false,4>",
                parent=True)
        op = ("RingOp<float,0,false>" if key == "ring fp32 sgd"
              else "RingOp<__nv_bfloat16,0,true>" if kind == "ring"
              else f"PsOp<{build.OPT_CODES[opt]}>")
        return instance_regs(
            regs, f"pipelined_kernel<<unnamed>::{op},false>" if path == P
            else f"simple_kernel<<unnamed>::{op},false,4>")

    variants = [("simple", SIMPLE4, False),
                ("pipelined", P, False)]
    if args.parent is not None:
        variants.insert(0, ("parent", None, True))

    def time_instances(inst, prefix=""):
        for vname, path, parent in variants + variants[::-1]:
            for key in inst:
                fn, outs = launcher(inst, key, path, parent)
                held(inst, key, fn, outs)
                record(f"{prefix}{vname} {key}", cs.cuda_ms(fn, args.reps),
                       inst[key][4],
                       {"registers": regs_of(key, path, parent)})

    print(f"the four instances at D {D}, c {C} (bytes bound at "
          f"{cs.PEAK_BYTES_PER_S / 1e12} TB/s)", flush=True)
    instances = make_instances()
    time_instances(instances)

    # ---- the read-only slot-order sum --------------------------------------
    coef = torch.full((C,), 1.0 / C, device=dev)
    ld_pad = -(-D // 32) * 32

    def time_sums(g, prefix="", names=tuple(SUM_VARIANTS), padded=True):
        g_pad = None
        if padded:
            g_pad = torch.empty(C, ld_pad, device=dev)
            g_pad[:, :D] = g
        out = torch.empty(D, device=dev)
        want = backends.combine(g, coef)
        sums = []
        for name in names:
            if name not in libs:
                continue
            lib = libs[name][0]
            for geom, path in (("simple", SIMPLE4), ("pipelined", P)):
                if name != "sum" and path != P:
                    continue
                strides = [("", g, D)] + ([(" rows on 128 B", g_pad,
                                             ld_pad)] if padded else [])
                for stride, gg, ld in strides:
                    def fn(lib=lib, gg=gg, ld=ld, path=path):
                        check(lib.probe_sum(gg.data_ptr(), coef.data_ptr(),
                                            out.data_ptr(), D, ld, C, path,
                                            stream), lib)
                    sums.append((f"{prefix}{name} {geom}{stride}", fn))
        for name, fn in sums + sums[::-1]:
            out.zero_()
            fn()
            cs.assert_bitwise([out], [want], name)
            record(name, cs.cuda_ms(fn, args.reps), 4 * C * D + 4 * D)

    print(f"the read-only sum of g (c {C}, D {D}) into D floats", flush=True)
    g = instances["ps sgd"][3]["g"]
    time_sums(g)
    print(f"the sum on each schedule at smaller D (c {C}): where the "
          f"pipelined path starts to pay (its tile {PIPE_TILE} "
          f"columns, {sms} SMs)", flush=True)
    for tiles_per_sm in (1, 2, 4, 8, 16):
        d = tiles_per_sm * sms * PIPE_TILE
        gd = torch.randn(C, d, device=dev)
        od = torch.empty(d, device=dev)
        want_d = backends.combine(gd, coef)
        lib = libs["sum"][0]
        for geom, path in (("simple", SIMPLE4), ("pipelined", P),
                           ("simple", SIMPLE4)):
            def fn(path=path):
                check(lib.probe_sum(gd.data_ptr(), coef.data_ptr(),
                                    od.data_ptr(), d, d, C, path, stream),
                      lib)
            fn()
            cs.assert_bitwise([od], [want_d], f"sum D {d}")
            record(f"sum {geom} D {d} ({tiles_per_sm} tiles per SM)",
                   cs.cuda_ms(fn, args.reps), 4 * C * d + 4 * d)
        del gd, od

    # ---- PyTorch yardsticks and the copy rate ------------------------------
    ops = instances["ps sgd"][3]
    lr = float(ops["lrs"][0])

    def yardsticks(prefix=""):
        record(f"{prefix}torch.addmv (sgd combine)", cs.cuda_ms(
            lambda: cs.library_addmv(ops["w"], g, coef, lr), args.reps),
            4 * C * D + 8 * D)
        record(f"{prefix}g.sum(0)", cs.cuda_ms(lambda: g.sum(0), args.reps),
               4 * C * D + 4 * D)
        dst = torch.empty_like(g)
        record(f"{prefix}copy 5.12 GB (read + write)", cs.cuda_ms(
            lambda: dst.copy_(g), args.reps), 2 * 4 * C * D)
        del dst

    print("PyTorch calls", flush=True)
    for _ in range(2):
        yardsticks()

    # ---- the same after the card has worked hard --------------------------
    if args.heat:
        print(f"before heat: {clocks()}", flush=True)
        a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.heat:
            for _ in range(50):
                a @ a
            torch.cuda.synchronize()
        del a
        print(f"after {args.heat} s of bf16 matmuls: {clocks()}", flush=True)
        time_instances(instances, "heated ")
        yardsticks("heated ")
        print(f"after: {clocks()}", flush=True)

    # ---- the same after a what-if event as phase 7 times it -----------------
    if args.whatif:
        del instances, g, ops
        torch.cuda.empty_cache()
        print("one ring_apply_whatif timing at D 1 777 086 464 (chip_smoke "
              "phase 7's), then fresh operands", flush=True)
        cs.time_kernel("ring_apply_whatif", 1_777_086_464, 128, 2, "sgd",
                       "bf16", "combine", True, dev, 5, 1)
        instances = make_instances()
        time_instances(instances, "after what-if ")
        g = instances["ps sgd"][3]["g"]
        ops = instances["ps sgd"][3]
        time_sums(g, "after what-if ", padded=False)
        yardsticks("after what-if ")

    # ---- the paper shape: one launch, and 4 lanes ---------------------------
    del instances, g, ops
    torch.cuda.empty_cache()
    print(f"the paper shape: D {PAPER_D}, c {PAPER_C}, momentum, fp32 "
          f"(host-clock bound through the wrapper; in a CUDA graph: device "
          f"time)", flush=True)
    spec = UpdateSpec("momentum")
    gen = torch.Generator(device=dev).manual_seed(5)
    B = PAPER_LANES
    ring = torch.randn(B, 2, PAPER_D, generator=gen, device=dev)
    s = torch.randn(B, PAPER_D, generator=gen, device=dev).abs()
    gp = torch.randn(B, PAPER_C, PAPER_D, generator=gen, device=dev)
    coefp = torch.full((PAPER_C,), 1.0 / PAPER_C, device=dev)
    lrsp = torch.rand(B, PAPER_C, generator=gen, device=dev) * 0.1
    idx = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    from repro_torch.kernels import replay_ring
    rlib = libs["replay_ring"][0]

    def raw(b, lanes=1):
        """One launch of this tree's library, no wrapper."""
        check(rlib.ring_apply(
            ring[b].data_ptr(), 0, s[b].data_ptr(), None, gp[b].data_ptr(),
            coefp.data_ptr(), lrsp[b].data_ptr(), idx.data_ptr(), PAPER_D,
            2, lanes, PAPER_C, 0, 1, 0, 0.9, 1e-8, SIMPLE1,
            torch.cuda.current_stream().cuda_stream), rlib)
    paper = [("wrapper: one ring", lambda: replay_ring.ring_apply(
        ring[0], s[0], None, gp[0], coefp, lrsp[0], idx, spec=spec)),
        (f"wrapper: {B} lanes, one launch", lambda: replay_ring.ring_apply(
            ring, s, None, gp, coefp, lrsp, idx, spec=spec)),
        ("raw: one ring", lambda: raw(0)),
        (f"raw: {B} lanes, one launch", lambda: raw(0, B))]
    if args.parent is not None:
        plib = libs["parent_replay_ring"][0]

        def parent_lane(b):
            check(plib.ring_apply(
                ring[b].data_ptr(), 0, s[b].data_ptr(), None,
                gp[b].data_ptr(), coefp.data_ptr(), lrsp[b].data_ptr(),
                idx.data_ptr(), PAPER_D, PAPER_C, 1, 0, 0.9, 1e-8, 0,
                torch.cuda.current_stream().cuda_stream), plib)
        paper += [("parent raw: one ring", lambda: parent_lane(0)),
                  (f"parent raw: {B} lanes, {B} launches",
                   lambda: [parent_lane(b) for b in range(B)])]
    nb = B * PAPER_D * (4 * PAPER_C + 16)
    for name, fn in paper + paper[::-1]:
        ms = cs.cuda_ms(fn, 200, warmup=5)
        record(f"paper {name}", ms, nb // (1 if "lanes" in name else B))
    for name, fn in paper + paper[::-1]:      # device time: 100 in a graph
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(100):
                fn()
        ms = cs.cuda_ms(graph.replay, 20, warmup=2) / 100
        record(f"paper graph {name}", ms, nb // (1 if "lanes" in name
                                                 else B))
        del graph

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
             "D": D, "c": C, "rows": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
