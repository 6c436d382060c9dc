"""On the card only: one short run of each cell through the command the
driver runs, which has to come out correct.

    PYTHONPATH=src python -m pytest -q -m cuda portbench/tests
"""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "4000000007", "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
