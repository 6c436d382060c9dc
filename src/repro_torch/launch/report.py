"""Aggregate dry-run campaign JSONs into the EXPERIMENTS.md tables
(counterpart of ``repro/launch/report.py``, pure aggregation, ported as
written; the port's results directory by default).

    PYTHONPATH=src python -m repro_torch.launch.report \
        [--dir results_torch/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

ARCH_ORDER = ["internvl2_2b", "hubert_xlarge", "rwkv6_7b", "qwen3_14b",
              "starcoder2_7b", "zamba2_7b", "llama4_maverick_400b_a17b",
              "qwen2_1_5b", "llama3_405b", "arctic_480b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_):
    rows = {}
    for path in glob.glob(os.path.join(dir_, "*.json")):
        with open(path) as f:
            data = json.load(f)
        for r in data:
            key = (r["arch"].replace("-", "_"), r["shape"], r["mesh"],
                   "probe" if r.get("kind") == "probe" else "main")
            rows[key] = r
    return rows


def fmt_ms(x):
    return f"{x*1e3:8.1f}"


def dryrun_table(rows) -> str:
    out = ["| arch | shape | 16x16 | 2x16x16 | GiB/dev | mb | fsdp |",
           "|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            m1 = rows.get((a, s, "16x16", "main"))
            m2 = rows.get((a, s, "2x16x16", "main"))
            if m1 is None:
                continue
            if m1["status"] == "skip":
                out.append(f"| {a} | {s} | SKIP | SKIP | — | — | — |"
                           f" <!-- {m1['reason']} -->")
                continue
            s1 = "OK" if m1["status"] == "ok" else m1["status"].upper()
            s2 = ("OK" if m2 and m2["status"] == "ok"
                  else (m2 or {}).get("status", "?").upper())
            gib = m1.get("bytes_per_device", 0) / 2**30
            out.append(
                f"| {a} | {s} | {s1} ({m1.get('compile_s', 0):.0f}s) "
                f"| {s2} ({(m2 or {}).get('compile_s', 0):.0f}s) "
                f"| {gib:.1f} | {m1.get('num_microbatches', 1)} "
                f"| {'Y' if m1.get('fsdp') else 'N'} |")
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = ["| arch | shape | t_comp | t_mem | t_coll | bound | useful "
           "| MODEL_FLOPS | coll GB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = rows.get((a, s, "16x16", "probe"))
            if r is None:
                continue
            if r["status"] == "skip":
                out.append(f"| {a} | {s} | — | — | — | skip | — | — | — |")
                continue
            out.append(
                f"| {a} | {s} | {fmt_ms(r['t_compute_s'])}ms "
                f"| {fmt_ms(r['t_memory_s'])}ms "
                f"| {fmt_ms(r['t_collective_s'])}ms "
                f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
                f"| {r['model_flops']:.2e} "
                f"| {r['coll_bytes_per_dev']/1e9:.1f} |")
    return "\n".join(out)


def summary_stats(rows):
    ok = skip = 0
    bounds = defaultdict(int)
    worst = []
    for (a, s, mesh, kind), r in rows.items():
        if kind == "main" and mesh == "16x16":
            ok += r["status"] == "ok"
            skip += r["status"] == "skip"
        if kind == "probe" and r["status"] == "ok":
            bounds[r["dominant"]] += 1
            worst.append((r["useful_ratio"], a, s, r["dominant"]))
    worst.sort()
    return ok, skip, dict(bounds), worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results_torch/dryrun")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    rows = load(args.dir)
    ok, skip, bounds, worst = summary_stats(rows)
    print(f"single-pod main: {ok} ok / {skip} skip;  "
          f"probe bound split: {bounds}")
    print("\n== §Dry-run ==\n")
    print(dryrun_table(rows))
    print("\n== §Roofline (single-pod probes) ==\n")
    print(roofline_table(rows))
    print("\nworst useful-FLOPs ratios (hillclimb candidates):")
    for u, a, s, d in worst[:8]:
        print(f"  {u:.3f}  {a} × {s}  ({d}-bound)")


if __name__ == "__main__":
    main()
