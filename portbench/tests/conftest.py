"""Fixtures of the benchmark's CPU tests: the import path, and a copy of
``portbench/`` with small cells added as files, as a later change would
add them.

    PYTHONPATH=src python -m pytest -q portbench/tests
"""

import copy
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_MODEL = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   vocab_size=300)
SMALL_PORT = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=300)
SMALL_TRAIN = dict(seq=32, attn_q_chunk=32, attn_kv_chunk=32)
SMALL_REPLAY = dict(n_learners=16, warmup_events=8, check_columns=1000)
MIXES = ("train_softsync", "train_hardsync", "whatif_replay")
# The training mixes' cells are held back from BENCHMARK.json (the port's
# bf16 training loses updates; PERF.md §7): their limits, and the metrics
# they will report, as a later change adds them.
HELD = {"train_softsync": "qwen2_1_5b.train_softsync",
        "train_hardsync": "qwen2_1_5b.train_hardsync"}
TRAIN_METRICS = (
    ("end_to_end", {"name": "train_tokens_per_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.03,
                    "source": "host_clock"}),
    ("per_layer", {"name": "train_mfu", "unit": "%", "better": "higher",
                   "source": "device_trace", "layer": "model stack",
                   "moves": "train_tokens_per_s"}),
    ("per_layer", {"name": "gemm_busy_pct.train", "unit": "%",
                   "better": "higher", "source": "device_trace",
                   "layer": "model stack", "moves": "train_tokens_per_s"}),
    ("per_layer", {"name": "device_idle_pct.train", "unit": "%",
                   "better": "lower", "source": "device_trace",
                   "layer": "device", "moves": "train_tokens_per_s"}))


def load(path):
    with open(path) as f:
        return json.load(f)


def dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture
def small(tmp_path):
    return make_small(tmp_path)


def make_small(tmp_path):
    """A copy of the benchmark with a small configuration and one small
    cell per traffic mix ("small.<mix>"), each holding its full-size
    cell's limits; returns (BENCHMARK.json's object, the copy's
    directory).  The small configuration trains in fp32, the port's path
    that agrees with the reference."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = load(bench_dir / "configs" / "qwen2_1_5b.json")
    cfg.update(SMALL_MODEL, torch_dtype="float32")
    cfg["port_model_config"].update(SMALL_PORT, dtype="float32")
    dump(cfg, bench_dir / "configs" / "small.json")
    bench = copy.deepcopy(load(ROOT / "BENCHMARK.json"))
    listed = {w["traffic"]: w["name"] for w in bench["workloads"]}
    small_train = [f"small.{mix}" for mix in HELD]
    for kind, m in TRAIN_METRICS:
        bench[kind].append(dict(m, workloads=list(small_train)))
    for mix in MIXES:
        m = load(bench_dir / "traffic" / f"{mix}.json")
        m["params"].update(SMALL_TRAIN if m["driver"] == "train"
                           else SMALL_REPLAY)
        dump(m, bench_dir / "traffic" / f"small_{mix}.json")
        full = listed.get(mix) or HELD[mix]
        shutil.copy(bench_dir / "workloads" / f"{full}.json",
                    bench_dir / "workloads" / f"small.{mix}.json")
        bench["workloads"].append(
            {"name": f"small.{mix}", "config": "small",
             "traffic": f"small_{mix}", "chips": 1, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if full in m.get("workloads", ()):
                m["workloads"].append(f"small.{mix}")
    return bench, bench_dir


def run_small(small, mix, seed=2 ** 31 + 11, seconds=1.0, trace=False):
    from portbench import harness
    bench, bench_dir = small
    return harness.run_cell(ROOT, f"small.{mix}", seed, seconds, trace, "cpu",
                            time.perf_counter(), bench, bench_dir)
