"""Package hygiene of the port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything
  of the reference package ``repro`` — not even its pure-numpy modules:
  the port keeps its own copies (an AST walk over every file, plus a fresh
  interpreter that imports the whole package and then looks for them).
* Every ``tests/test_torch_*.py`` imports ``torch_cpu`` first (an AST
  walk), and importing it in a fresh interpreter caps torch's threads at
  the xdist worker's share of the CPU (``launch.mesh.threads_per_process``).
* The entry points run on the card unless the caller asks for the CPU:
  without a card, ``driver.run`` / ``driver.execute`` / ``engine.replay``
  (and the legacy oracle: ``simulate``, the baselines, ``engine="legacy"``;
  the serving path's ``init_model``, ``init_caches``,
  ``init_serve_state``; the training path's ``train``, the train CLI,
  ``PrefetchIterator`` and the ``cnn`` cell's ``init_cnn`` and
  ``compute``) called with no ``device=`` raise instead of quietly using
  the CPU.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

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
                     "experiments/carry.py", "core/simulator.py",
                     "core/baselines.py", "core/protocols.py",
                     "kernels/ps_update.py", "kernels/ops.py",
                     "kernels/ref.py", "kernels/flash_attention.py",
                     "models/__init__.py", "models/layers.py",
                     "models/attention.py", "models/blocks.py",
                     "models/transformer.py", "serve/engine.py",
                     "serve/scheduler.py", "models/ssm.py", "models/rwkv.py",
                     "kernels/ssm_scan.py", "kernels/wkv6.py",
                     "configs/zamba2_7b.py", "configs/rwkv6_7b.py",
                     "experiments/sweep.py", "experiments/registry.py",
                     "experiments/campaign.py", "experiments/validate.py",
                     "experiments/smoke.py", "experiments/cells/__init__.py",
                     "experiments/cells/elastic_churn.py",
                     "experiments/cells/topology_scaling.py",
                     "experiments/cells/train_while_serve.py",
                     "experiments/cells/fig4_staleness.py",
                     "experiments/cells/table1_overlap.py",
                     "experiments/cells/fig8_speedup.py",
                     "experiments/cells/fig5_lr_modulation.py",
                     "experiments/cells/fig6_7_tradeoff.py",
                     "experiments/cells/table2_mu_lambda.py",
                     "experiments/cells/baselines.py",
                     "experiments/cells/table3_4_summary.py",
                     "experiments/cells/sim_engine_bench.py",
                     "experiments/cells/kernel_bench.py",
                     "experiments/cells/bench_guard.py",
                     "experiments/cells/smoke_cells.py",
                     "launch/__init__.py", "launch/roofline.py",
                     "experiments/bench_guard.py", "launch/mesh.py",
                     "launch/sharding.py",
                     "experiments/cells/ring_feasibility.py",
                     "experiments/cells/distributed_replay.py",
                     "configs/internvl2_2b.py", "configs/hubert_xlarge.py",
                     "configs/qwen3_14b.py", "configs/starcoder2_7b.py",
                     "configs/llama4_maverick_400b_a17b.py",
                     "configs/llama3_405b.py", "configs/arctic_480b.py",
                     "core/distributed.py", "data/pipeline.py",
                     "checkpoint/io.py", "train/loop.py", "launch/train.py",
                     "experiments/cells/cnn_fig5.py", "models/moe.py",
                     "launch/specs.py", "launch/dryrun.py",
                     "launch/report.py", "launch/dryrun_campaign.py",
                     "launch/campaign.py", "kernels/mamba_glue.py",
                     "kernels/rms_norm.py", "kernels/moe_route.py",
                     "models/granite.py"):
        assert expected in names
    for source in ("replay_ring.cu", "ps_update.cu", "update_event.cuh",
                   "flash_attention.cu", "flash_attention_sm90.cu",
                   "ssm_scan.cu", "wkv6.cu", "mamba_glue.cu", "rms_norm.cu",
                   "moe_route.cu", "rows.cuh"):
        assert (PORT / "kernels" / "csrc" / source).is_file()


def test_every_reference_module_has_a_counterpart():
    """The port mirrors the reference's module tree file for file: each
    ``src/repro/**/*.py`` has a namesake under ``src/repro_torch/``."""
    ref = ROOT / "src" / "repro"
    missing = [p.relative_to(ref).as_posix() for p in sorted(ref.rglob("*.py"))
               if not (PORT / p.relative_to(ref)).is_file()]
    assert not missing, missing
    assert len(list(ref.rglob("*.py"))) >= 92


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(
    ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_test_imports_its_cpu_share_first(path):
    """Every port test file's first statement after its docstring is
    ``import torch_cpu``, which caps torch's threads at the xdist worker's
    share of the CPU."""
    body = ast.parse(path.read_text(), filename=str(path)).body
    first = body[1] if isinstance(body[0], ast.Expr) else body[0]
    assert (isinstance(first, ast.Import)
            and [a.name for a in first.names] == ["torch_cpu"]), path.name


@pytest.mark.parametrize("workers", [None, "1", "6"])
def test_torch_cpu_takes_the_worker_share(workers):
    """In a fresh interpreter, importing ``torch_cpu`` under xdist's
    worker count leaves torch the smaller of its default and
    ``max(1, cpu_count // workers)`` threads; without xdist, its
    default."""
    code = ("import os, torch\n"
            "default = torch.get_num_threads()\n"
            "import torch_cpu\n"
            "n = os.environ.get('PYTEST_XDIST_WORKER_COUNT')\n"
            "share = max(1, os.cpu_count() // int(n)) if n else default\n"
            "assert torch.get_num_threads() == min(default, share), "
            "(torch.get_num_threads(), default, share)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = workers
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_fresh_interpreter_loads_no_jax_and_builds_nothing():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.experiments\n"
            "import repro_torch.kernels.replay_ring, repro_torch.configs\n"
            "import repro_torch.kernels.ps_update, repro_torch.kernels.ops\n"
            "import repro_torch.core.baselines\n"
            "import repro_torch.models, repro_torch.serve.scheduler\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.experiments.campaign\n"
            "import repro_torch.experiments.validate\n"
            "import repro_torch.experiments.smoke\n"
            "import repro_torch.core.distributed, repro_torch.train.loop\n"
            "import repro_torch.data.pipeline, repro_torch.checkpoint.io\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.experiments.cells.cnn_fig5\n"
            "import repro_torch.models.moe, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.report, repro_torch.launch.campaign\n"
            "from repro_torch.experiments.registry import cell_names\n"
            "cell_names()\n"
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


def test_driver_run_legacy_defaults_to_cuda_and_raises_without_card(
        no_card):
    from repro_torch.experiments import run
    spec = _spec().replace(engine="legacy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(spec)
    res = run(spec, device="cpu")
    assert res.runtime["updates"] == 4
    assert res.runtime["replay_path"] == "legacy"


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


def test_legacy_entry_points_raise_without_card(no_card):
    from repro_torch.core import simulate
    from repro_torch.core import baselines
    from repro_torch.experiments import execute
    from repro_torch.experiments.driver import per_arrival_grad
    from repro_torch.experiments.problems import MLPProblem
    spec = _spec()
    prob = MLPProblem(hidden=8)
    kw = dict(steps=4, grad_fn=per_arrival_grad(prob.grad_fn),
              init_params=prob.init("cpu"), batch_fn=prob.batch_fn_for(4))
    for call in (lambda: simulate(spec.run, **kw),
                 lambda: simulate(spec.run, steps=4),
                 lambda: execute(spec.run, engine="legacy", **kw),
                 lambda: baselines.simulate_ssp(spec.run, slack=1, **kw),
                 lambda: baselines.simulate_easgd(spec.run, **kw),
                 lambda: baselines.simulate_accrual(spec.run, npush=1,
                                                    **kw)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert simulate(spec.run, device="cpu", **kw).updates == 4


def test_serving_entry_points_raise_without_card(no_card):
    import dataclasses
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_caches, init_model
    from repro_torch.serve.engine import generate, init_serve_state
    cfg = dataclasses.replace(get_smoke("qwen2_1_5b"), dtype="float32")
    others = [get_smoke(a) for a in ("zamba2_7b", "rwkv6_7b")]
    for call in (lambda: init_model(cfg),
                 lambda: init_model(cfg, 0),
                 lambda: init_caches(cfg, 1, 4),
                 lambda: init_serve_state(cfg, 1, 4),
                 *(lambda c=c: init_model(c, 0) for c in others),
                 *(lambda c=c: init_caches(c, 1, 4) for c in others)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # generate runs where the parameters are: here, where it was asked
    params = init_model(cfg, 0, device="cpu")
    out = generate(cfg, RunConfig(), params, [[1, 2, 3]], 2)
    assert out.shape == (1, 2) and out.device.type == "cpu"


def test_sweep_and_campaign_default_to_cuda_and_raise_without_card(
        no_card, tmp_path):
    from repro_torch.experiments import campaign, run_sweep
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sweep([_spec(), _spec().replace(run=_spec().run.replace(
            seed=1))])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        campaign.run_cell("elastic", {"epochs": 0.01},
                          results_dir=str(tmp_path))
    res = run_sweep([_spec()], device="cpu")
    assert res[0].runtime["replay_path"] == "sequential"


def test_training_entry_points_default_to_cuda_and_raise_without_card(
        no_card, tmp_path):
    from repro_torch.config import ModelConfig, RunConfig
    from repro_torch.experiments.cells import cnn_fig5
    from repro_torch.launch import train as train_cli
    from repro_torch.train.loop import train
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
                      dtype="float32")
    run = RunConfig(protocol="hardsync", n_learners=2, minibatch=1)
    for call in (lambda: train(cfg, run, steps=1, batch=2, seq=8),
                 lambda: cnn_fig5.init_cnn(0),
                 lambda: cnn_fig5.compute(updates=1),
                 lambda: train_cli.main(["--arch", "qwen2-1.5b", "--smoke",
                                         "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    res = train(cfg, run, steps=1, batch=2, seq=8, device="cpu")
    assert res.steps == 1
    train_cli.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                    "--protocol", "hardsync", "--steps", "1", "--batch", "2",
                    "--seq", "8", "--ckpt", str(tmp_path)])
    assert (tmp_path / "checkpoint.npz").is_file()
