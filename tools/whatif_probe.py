#!/usr/bin/env python3
"""``ring_apply_whatif`` by the pattern of the rows its slots pull, this
tree's kernel beside an older one, on one NVIDIA card.

    python3 tools/whatif_probe.py [--parent DIR] [--reps N] [--out PATH]

At D 1 777 086 464, c 128, a bf16 ring with its fp32 residue and sgd (the
shape ``chip_smoke.py`` phase 7 times), one event per launch, for each
pattern of pulled rows in ``patterns()``: 1 row; 2 rows in 4 runs; 2 rows
in 31 runs; the replay benchmark's 3 rows at 5, 9 and 18 runs (events of
the arrival schedule it replays, 1-softsync, λ 128, ``schedule_seed`` 1,
rows mod K 3); 4 rows alternating every slot; 4 rows whose pairs of slots
take every one of the 16 pair patterns (the walk's whole switch, to show
its instruction-cache cost beside the alternating 4 rows, which take 2).

``--parent DIR``: a directory holding an older ``replay_ring.cu`` and
``update_event.cuh``.  Both sources are built here with the kernels' nvcc
flags (``kernels/build.py``), one nvcc each; the registers and spills of
the instance timed (``<__nv_bfloat16, 0, true, 8>``) and its SASS
instruction count are printed for each.  Per pattern, one launch of each
from the same state is held bitwise against the other (the slot row and
the residue), then each is timed with CUDA events in turns (parent, this,
this, parent, twice), ``--reps`` launches a turn, beside the event's bound
(``chip_smoke.event_cost`` / ``bound_ms``).  A kernel with the device
tally counts its launches by variant there: every pattern here takes the
walk, and the probe exits nonzero unless each does, and unless every
pattern was bitwise.

Prints one line per measurement (``--out PATH``: also as JSON).  Exits
nonzero without a card.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "whatif_probe"
D, C = 1_777_086_464, 128
INSTANCE = re.compile(r"ring_apply_whatif_kernel<__nv_bfloat16,\s*\(?int\)?"
                      r"0,\s*\(?bool\)?(true|1),\s*\(?int\)?8>")


def patterns():
    """[(name, prev, slot, ts)]: one event's ring rows, K 6 at most."""
    import numpy as np
    out = [("1 row", 0, 1, [0] * C),
           ("2 rows in 4 runs", 0, 1, ([0] * 32 + [1] * 32) * 2)]
    rng = np.random.default_rng(3)
    while True:             # 31 runs of 1 to 7 slots, alternating rows
        lens = [int(n) for n in rng.integers(1, 8, 30)]
        if 1 <= C - sum(lens) <= 7:
            break
    lens.append(C - sum(lens))
    out.append(("2 rows in 31 runs", 0, 1,
                [r for i, n in enumerate(lens) for r in [i % 2] * n]))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import RunConfig
    from repro_torch.core import trace
    tr = trace.schedule(RunConfig(protocol="softsync", n_softsync=1,
                                  n_learners=C, minibatch=1, seed=1), 861)
    K = tr.max_staleness + 1
    rows = tr.pulled_ts % K
    runs = 1 + (rows[:, 1:] != rows[:, :-1]).sum(axis=1)
    for n in (5, 9, 18):
        j = next(j for j in range(len(rows))
                 if runs[j] == n and len(set(rows[j].tolist())) == 3)
        out.append((f"benchmark, 3 rows in {n} runs (event {j}, K {K})",
                    j % K, (j + 1) % K, rows[j].tolist()))
    out.append(("4 rows alternating", 4, 5, [i % 4 for i in range(C)]))
    pairs = [(p % 4, p // 4 % 4) for p in range(C // 2)]
    out.append(("4 rows, all 16 pair patterns", 4, 5,
                [k for pair in pairs for k in pair]))
    return out


def build(cu: Path, so: Path, include: Path):
    """Start nvcc on ``cu`` with the kernels' flags."""
    from repro_torch.kernels import build as kbuild
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [kbuild.nvcc(), *kbuild.flags("replay_ring"), "-I", str(include),
         "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def instance_facts(log: str, so: Path) -> dict:
    """Registers and spills (ptxas) and SASS instructions (cuobjdump) of
    the timed instance."""
    from repro_torch.kernels import build as kbuild
    tools = Path(kbuild.nvcc()).parent
    facts, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            continue
        r = re.search(r"Used (\d+) registers", ln)
        if r and cur:
            name = subprocess.run([str(tools / "cu++filt"), cur],
                                  capture_output=True, text=True).stdout
            if INSTANCE.search(name):
                facts["registers"] = int(r.group(1))
                facts["mangled"] = cur
        s = re.search(r"(\d+) bytes spill stores", ln)
        if s and cur and cur == facts.get("mangled"):
            facts["spill_stores"] = int(s.group(1))
    if "mangled" in facts:
        sass = subprocess.run([str(tools / "cuobjdump"), "-sass", "-fun",
                               facts["mangled"], str(so)],
                              capture_output=True, text=True).stdout
        facts["sass_instructions"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/ ",
                                                    sass))
    return facts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("whatif_probe.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sides = {"this": (CSRC / "replay_ring.cu", CSRC)}
    if args.parent is not None:
        sides["parent"] = (args.parent / "replay_ring.cu", args.parent)
    procs = {k: build(cu, OUT / f"{k}_replay_ring.so", inc)
             for k, (cu, inc) in sides.items()}
    libs, record = {}, {"card": card, "D": D, "c": C, "patterns": {}}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {k} source:\n{log}")
        so = OUT / f"{k}_replay_ring.so"
        lib = ctypes.CDLL(str(so))
        # an older kernel without the device tally takes one argument less
        tally = "void* tally" in sides[k][0].read_text()
        lib.ring_apply_whatif.argtypes = (
            [p, i, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, f, f, i]
            + [p] * (2 if tally else 1))
        lib.ring_apply_whatif.restype = i
        libs[k] = (lib, tally)
        facts = instance_facts(log, so)
        record[f"{k}_instance"] = facts
        print(f"{k}: {facts}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(11)
    ring = torch.empty(6, D, device=dev, dtype=torch.bfloat16)
    for r in range(6):
        ring[r] = torch.randn(D, generator=gen, device=dev)
    res = torch.randn(D, generator=gen, device=dev) * 1e-3
    a = torch.rand(D, generator=gen, device=dev) + 0.5
    wstar = torch.randn(D, generator=gen, device=dev)
    coef = torch.full((C,), 1.0 / C, device=dev)
    lrs = torch.rand(C, generator=gen, device=dev) * 0.09 + 0.01
    # per side: its kernel's device tally [walk, slots], its launches
    tally = {k: torch.zeros(2, dtype=torch.int32, device=dev) for k in libs}
    count = dict.fromkeys(libs, 0)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(side, idx):
        count[side] += 1
        lib, has_tally = libs[side]
        extra = [tally[side].data_ptr()] if has_tally else []
        err = lib.ring_apply_whatif(
            ring.data_ptr(), 1, None, res.data_ptr(), a.data_ptr(),
            wstar.data_ptr(), coef.data_ptr(), lrs.data_ptr(),
            idx.data_ptr(), D, C, 0, 0.0, 0.0, 1, *extra, stream)
        if err:
            raise RuntimeError(f"{side}: launch failed ({err})")

    order = ["parent", "this", "this", "parent"] * 2 if "parent" in libs \
        else ["this"] * 4
    for name, prev, slot, ts in patterns():
        idx = torch.tensor([prev, slot, *ts], dtype=torch.int32, device=dev)
        nruns = 1 + sum(x != y for x, y in zip(ts, ts[1:]))
        ops = {"ring": ring, "s": None, "res": res, "coef": coef,
               "lrs": lrs, "idx": idx, "a": a, "wstar": wstar}
        nbytes, nops = cs.event_cost(ops, "sgd", "combine", True)
        bms, by = cs.bound_ms(nbytes, nops)
        row = {"rows": len(set(ts)), "runs": nruns, "bound_ms": bms,
               "bound_by": by, "ms": {k: [] for k in libs}}
        if "parent" in libs:      # one launch of each from the same state
            saved = (ring[slot].clone(), res.clone())
            outs = {}
            for side in ("parent", "this"):
                launch(side, idx)
                torch.cuda.synchronize()
                outs[side] = (ring[slot].clone(), res.clone())
                ring[slot].copy_(saved[0])
                res.copy_(saved[1])
            row["bitwise"] = all(torch.equal(x, y) for x, y in
                                 zip(outs["parent"], outs["this"]))
            del saved, outs
            torch.cuda.empty_cache()
        for side in order:
            row["ms"][side].append(cs.cuda_ms(lambda: launch(side, idx),
                                              args.reps, warmup=2))
        line = "; ".join(
            f"{k} {statistics.mean(v):.3f} ms ({', '.join(f'{x:.3f}' for x in v)}, "
            f"{bms / statistics.mean(v):.3f} of the bound)"
            for k, v in row["ms"].items())
        print(f"{name}: {row['rows']} rows in {nruns} runs; {line}; bound "
              f"{bms:.3f} ms by {by}"
              + (f"; bitwise {row['bitwise']}" if "bitwise" in row else ""),
              flush=True)
        record["patterns"][name] = row
    record["tally"] = {}
    for side, (_, has_tally) in libs.items():
        if has_tally:
            walk, slots = tally[side].tolist()
            record["tally"][side] = {"walk": walk, "slots": slots,
                                     "launches": count[side]}
            print(f"{side} kernel's tally: walk {walk}, slots {slots} of "
                  f"{count[side]} launches", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    ok = all(t["walk"] == t["launches"] and t["slots"] == 0
             for t in record["tally"].values()) and all(
        r.get("bitwise", True) for r in record["patterns"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
