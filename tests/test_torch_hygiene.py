"""Package hygiene of the port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything
  of the reference package ``repro`` — not even its pure-numpy modules:
  the port keeps its own copies (an AST walk over every file, plus a fresh
  interpreter that imports the whole package and then looks for them).
* The entry points run on the card unless the caller asks for the CPU:
  without a card, ``driver.run`` / ``driver.execute`` / ``engine.replay``
  called with no ``device=`` raise instead of quietly using the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_file_list_is_complete():
    names = {p.relative_to(PORT).as_posix() for p in FILES[:-1]}
    for expected in ("core/engine.py", "core/trace.py", "optim/backends.py",
                     "kernels/replay_ring.py", "experiments/driver.py",
                     "experiments/carry.py"):
        assert expected in names
    assert (PORT / "kernels" / "csrc" / "replay_ring.cu").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(
    ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_fresh_interpreter_loads_no_jax_and_builds_nothing():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.experiments\n"
            "import repro_torch.kernels.replay_ring, repro_torch.configs\n"
            "from repro_torch.configs import get_config\n"
            "get_config('qwen2_1_5b')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import build\n"
            "assert build.load.cache_info().currsize == 0  # built lazily\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _spec():
    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec
    return ExperimentSpec(
        run=RunConfig(protocol="softsync", n_learners=4, minibatch=4),
        problem="mlp_teacher", problem_args={"hidden": 8}, steps=4)


@pytest.fixture
def no_card(monkeypatch):
    """This host has no card; make that explicit so the test means the
    same on a host that has one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_driver_run_defaults_to_cuda_and_raises_without_card(no_card):
    from repro_torch.experiments import run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(_spec())
    assert run(_spec(), device="cpu").runtime["updates"] == 4


def test_execute_and_replay_raise_without_card(no_card):
    from repro_torch.core import replay, schedule
    from repro_torch.experiments import execute
    from repro_torch.experiments.problems import MLPProblem
    spec = _spec()
    with pytest.raises(RuntimeError, match="is_available"):
        execute(spec.run, steps=4)
    prob = MLPProblem(hidden=8)
    with pytest.raises(RuntimeError, match="is_available"):
        replay(schedule(spec.run, 4), spec.run, grad_fn=prob.grad_fn,
               init_params=prob.init("cpu"), batch_fn=prob.batch_fn_for(4))
