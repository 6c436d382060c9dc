#!/usr/bin/env python3
"""Where the fp32 (3×TF32) flash kernel's time goes, by ablation, on one
NVIDIA card.

    python3 tools/flash_ablation.py

Derives variants of ``src/repro_torch/kernels/csrc/flash_attention.cu`` by
text substitution, builds each with the kernel's own ``nvcc`` flags into
``build/ablation/`` (all started together), and times each with CUDA
events at ``chip_smoke.py`` phase 7's two fp32 layers (prefill_32k: B 1,
KV 2, G 6, S 32 768, D 128; zamba2_7b: H = KV = 32, S 8 192, D 112; causal)
beside its max |kernel − plain| over row ranges.  The variants, timed in
the order given and then in reverse:

* ``kernel``: the source as it is;
* ``unpromoted``: P·V accumulated across all of a row's K tiles in the
  wgmma accumulator (O's halves), as the first design of the kernel did;
  its error is what the per-tile promotion removes;
* ``no_convert``: the converter signals each tile without converting it;
* ``s_big_only``: S from the big·big product alone (two of its three
  products dropped);
* ``pv_big_only``: P·V from the big·big product alone;
* ``no_softmax``: the scores go to P as they are (no scale, mask, max or
  exponential).

All but ``kernel`` and ``unpromoted`` compute something else: their times
say what the removed work costs, their errors say nothing.  Exits nonzero
without a card.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "ablation"


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise AssertionError(f"expected {count} of {old[:60]!r} in "
                             f"{SOURCE.name}, found {src.count(old)}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    out = {"kernel": src}
    # P V straight into O's halves, accumulating across tiles
    unp = _sub(src, "mma_pv(ot, &ps[4 * kk], desc(vtb + kk * 32), kk);",
               "mma_pv(ot, &ps[4 * kk], desc(vtb + kk * 32), 1);")
    unp = _sub(unp, "for (int i = 0; i < D / 4; ++i) o[half * (D / 4) + i] "
               "+= ot[i];", "")
    unp, n = re.subn(
        r"issue_pv<D>\(ot, (pb, ps, vhalf\(\w+, L::VTB, (\d)\))",
        lambda m: (f"issue_pv<D>(*reinterpret_cast<float(*)[D / 4]>("
                   f"&o[{m.group(2)} * (D / 4)]), {m.group(1)}"), unp)
    if n != 4:
        raise AssertionError(f"expected 4 issue_pv calls, found {n}")
    out["unpromoted"] = unp
    out["no_convert"] = _sub(
        _sub(src, "      convert_k<D>(", "      if (p.nq < 0) convert_k<D>("),
        "      convert_v<D>(", "      if (p.nq < 0) convert_v<D>(")
    out["s_big_only"] = _sub(src, """#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_s(sc, desc(qs + (kk / 4) * QBOX + (kk % 4) * 32),
          desc(kb + (kk / 4) * KBOX + (kk % 4) * 32), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_s(sc, &qa[4 * kk], desc(ks + (kk / 4) * KBOX + (kk % 4) * 32));""",
                             "  mma_s(sc, desc(qs), desc(kb), 0);")
    out["pv_big_only"] = _sub(src, """#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    mma_pv(ot, &ps[4 * kk], desc(vtb + kk * 32), kk);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    mma_pv(ot, &pb[4 * kk], desc(vts + kk * 32), 1);""",
                              "  mma_pv(ot, &ps[0], desc(vtb), 0);")
    out["no_softmax"] = _sub(
        src, "      softmax_tile(sc, m, l, alpha, p, k0, row0, colq, "
        "edge(k0), pad);", "      alpha[0] = alpha[1] = 1.f;")
    return out


def build_all(srcs: dict, nvcc: str, flags) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and not ln.strip().startswith(
                             "0 bytes stack frame")})
        print(f"  {name}: built; ptxas spill lines {spills}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            f, i, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ablation.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"{cs.smi_line()}; torch {torch.__version__}", flush=True)
    libs = build_all(variants(SOURCE.read_text()), build.nvcc(),
                     build.flags("flash_attention"))
    layers = {"prefill_32k": (32768, 12, 2, 128),
              "zamba2 D 112": (8192, 32, 32, 112)}
    data = {}
    for key, (S, H, KV, D) in layers.items():
        q, k, v = cs.flash_inputs(1, S, S, H, KV, D, torch.float32, 23, dev)
        G = H // KV
        plain = fa.flash_attention_bkgsd_plain(
            q.reshape(1, S, KV, G, D).permute(0, 2, 3, 1, 4),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=True,
            blk_q=fa.BLK_Q, blk_k=fa.TF32X3_BLK_K)
        data[key] = (q, k, v, plain)
    rows = ((0, 128), (128, 1024), (1024, 8192), (8192, 32768))
    order = list(libs) + list(libs)[::-1]
    for name in order:
        lib = libs[name]
        fa._library = lambda lib=lib: lib
        for key, (q, k, v, plain) in data.items():
            B, S, H, D = q.shape
            KV = k.shape[2]
            out = fa.flash_attention(q, k, v, causal=True)
            diff = (out.reshape(B, S, KV, H // KV, D).permute(0, 2, 3, 1, 4)
                    - plain).abs()
            by = [f"{float(diff[..., a:min(b, S), :].max()):.3e}"
                  for a, b in rows if a < S]
            ms = cs.cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                            3)
            print(f"  {name:12s} {key}: {ms:.4f} ms; max |kernel - plain| "
                  f"{float(diff.max()):.3e}, by rows {rows[:len(by)]}: "
                  f"{by}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
