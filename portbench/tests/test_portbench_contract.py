"""``BENCHMARK.json`` and the files it names, against the benchmark's
rules; and that nothing the benchmark runs loads JAX or the JAX package
(top-level module names compared whole: ``repro_torch`` is not
``repro``)."""

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expan|per_tok|experts_per)", re.IGNORECASE)


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits: 2 + 14·cells runs of run_seconds + 60,
    # 2·90 s of compiling a cell, 1 200 s spare
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 \
        + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_config_as_run_matches_its_published_keys():
    cfg = json.loads((ROOT / "portbench/configs/qwen2_1_5b.json").read_text())
    port = cfg["port_model_config"]
    assert (port["n_layers"], port["d_model"], port["n_heads"],
            port["n_kv_heads"], port["d_ff"], port["vocab_size"]) == (
        cfg["num_hidden_layers"], cfg["hidden_size"],
        cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["intermediate_size"], cfg["vocab_size"])
    assert port["rope_theta"] == cfg["rope_theta"]
    assert port["norm_eps"] == cfg["rms_norm_eps"]
    assert port["tie_embeddings"] == cfg["tie_word_embeddings"]
    assert port["dtype"] == cfg["torch_dtype"]


def test_workloads():
    seen = set()
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        mix = json.loads((ROOT / "portbench/traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench/drivers" / f"{mix['driver']}.py").exists()
        limits = json.loads((ROOT / "portbench/workloads"
                             / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        for cell in _cells_of(m):
            assert cell in _cells_of(e2e[m["moves"]])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in _cells_of(m)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(w["name"] in _cells_of(m) for m in BENCH["per_layer"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        "sys.path[:0] = [%r, %r]\n"
        "from portbench.tests import conftest\n"
        "from portbench import harness\n"
        "import pathlib, tempfile\n"
        "tmp = pathlib.Path(tempfile.mkdtemp())\n"
        "fix = conftest.make_small(tmp)\n"
        "r = conftest.run_small(fix, 'whatif_replay')\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules())\n"
        % (str(ROOT / "src"), str(ROOT)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
