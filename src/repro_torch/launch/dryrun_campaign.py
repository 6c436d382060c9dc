"""Dry-run campaign driver (counterpart of
``repro/launch/dryrun_campaign.py``): all (arch × shape) × {main 16x16,
main 2x16x16, probe 16x16} as parallel subprocesses; results land in the
port's own directory, ``results_torch/dryrun/<job>.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_campaign [--workers 5]
        [--modes ...] [--force]

Each job is its own process, so traces run truly in parallel.

Caching is content-addressed, with the experiments campaign layer's
contract (DESIGN.md §15): every job's spec (arch/shape/mode/mesh + the
extra dry-run flags it implies) and the port's backend marker hash to a
``job_hash`` stamped into the result JSON under ``campaign``; a job is
skipped only when its file exists AND the stamp matches.  The marker keeps
the reference's dry-run results and the port's apart.  A result file is
the dry-run's list of rows, so the stamp goes into every row (the
reference stamps the file as a dict, which its list of rows is not).
``--force`` re-runs regardless.  Results without a stamp count as stale.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from repro_torch.experiments.spec_hash import BACKEND, content_hash

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
OUT_DIR = os.path.join(ROOT, "results_torch", "dryrun")

ARCHS = ["internvl2_2b", "hubert_xlarge", "rwkv6_7b", "qwen3_14b",
         "starcoder2_7b", "zamba2_7b", "llama4_maverick_400b_a17b",
         "qwen2_1_5b", "llama3_405b", "arctic_480b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def job_id(arch, shape, mode, multi):
    mesh = "2x16x16" if multi else "16x16"
    return f"{arch}__{shape}__{mode}__{mesh}"


def job_spec(arch, shape, mode, multi) -> dict:
    """Everything that determines the job's output, in canonical form."""
    spec = {"arch": arch, "shape": shape, "mode": mode,
            "mesh": "2x16x16" if multi else "16x16"}
    if mode == "probe":
        spec["q_chunk"] = 4096
        spec["kv_chunk"] = 4096
    return spec


def job_hash(arch, shape, mode, multi) -> str:
    return content_hash({"backend": BACKEND,
                         "job": job_spec(arch, shape, mode, multi)})


def _is_cached(out_json: str, want_hash: str) -> bool:
    try:
        with open(out_json) as f:
            rows = json.load(f)
    except (OSError, ValueError):
        return False
    return isinstance(rows, list) and bool(rows) and all(
        isinstance(r, dict)
        and (r.get("campaign") or {}).get("job_hash") == want_hash
        for r in rows)


def _stamp(out_json: str, arch, shape, mode, multi) -> None:
    """Write the content-address stamp into every row of a fresh result
    file (the dry-run writes a list of rows, which ``launch/report.py``
    reads as it is)."""
    try:
        with open(out_json) as f:
            rows = json.load(f)
    except (OSError, ValueError):
        return   # job "succeeded" without a readable artifact: leave unstamped
    stamp = {"job_hash": job_hash(arch, shape, mode, multi),
             "spec": job_spec(arch, shape, mode, multi)}
    for r in rows:
        r["campaign"] = stamp
    with open(out_json, "w") as f:
        json.dump(rows, f, indent=1, default=float)
        f.write("\n")


def run_job(arch, shape, mode, multi, timeout, force=False):
    jid = job_id(arch, shape, mode, multi)
    out_json = os.path.join(OUT_DIR, jid + ".json")
    if not force and _is_cached(out_json, job_hash(arch, shape, mode, multi)):
        return jid, "cached"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch.replace("_", "-"), "--shape", shape,
           "--mode", mode, "--json", out_json]
    if multi:
        cmd.append("--multi-pod")
    if mode == "probe":
        cmd += ["--q-chunk", "4096", "--kv-chunk", "4096"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
        status = "ok" if p.returncode == 0 else "fail"
        if status == "ok":
            _stamp(out_json, arch, shape, mode, multi)
        else:
            with open(out_json + ".err", "w") as f:
                f.write(p.stdout[-4000:] + "\n---\n" + p.stderr[-6000:])
    except subprocess.TimeoutExpired:
        status = "timeout"
        with open(out_json + ".err", "w") as f:
            f.write(f"timeout after {timeout}s")
    return jid, f"{status} ({time.time() - t0:.0f}s)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=5)
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--modes", default="main,multi,probe")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--force", action="store_true",
                    help="re-run jobs even when their stamp is current")
    args = ap.parse_args()
    os.makedirs(OUT_DIR, exist_ok=True)

    modes = args.modes.split(",")
    jobs = []
    for arch in args.archs.split(","):
        for shape in args.shapes.split(","):
            if "main" in modes:
                jobs.append((arch, shape, "main", False))
            if "multi" in modes:
                jobs.append((arch, shape, "main", True))
            if "probe" in modes:
                jobs.append((arch, shape, "probe", False))

    t0 = time.time()
    done = 0
    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        futs = {ex.submit(run_job, *j, args.timeout, args.force): j
                for j in jobs}
        for fut in as_completed(futs):
            jid, status = fut.result()
            done += 1
            print(f"[{done}/{len(jobs)} {time.time()-t0:.0f}s] {jid}: "
                  f"{status}", flush=True)
    print(f"campaign done in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
