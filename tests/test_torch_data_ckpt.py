"""The port's data pipeline (``data/pipeline.py``) and checkpoints
(``checkpoint/io.py``) against the reference's.

* Batches: every layout of ``make_batch_fn`` (text, vision prefix, audio
  frames) bitwise the reference's; ``shard_batch_for_learner`` likewise.
* ``PrefetchIterator``: every step in order, numpy without a device,
  tensors on the device it was given.
* Checkpoints: a parameter tree (bf16 leaves, stored as fp32) and
  optimizer states (a momentum velocity tree; adamw's moments and step
  count) written by either package load into the other, bitwise, with the
  same keys and step.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as jload
from repro.checkpoint.io import save_checkpoint as jsave
from repro.configs import get_smoke as jget_smoke
from repro.data.pipeline import make_batch_fn as jmake_batch_fn
from repro.data.pipeline import shard_batch_for_learner as jshard
from repro.models import init_model as jinit_model
from repro.optim import UpdateSpec as JSpec
from repro.optim import init_state as jinit_state
from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import (PrefetchIterator, make_batch_fn,
                                       shard_batch_for_learner)
from repro_torch.experiments.carry import model_params_from_jax, tree_from_jax


@pytest.mark.parametrize("arch", ["internvl2_2b", "hubert_xlarge",
                                  "qwen2_1_5b"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_batch_layouts_bitwise(arch, seed, step):
    ref = jmake_batch_fn(jget_smoke(arch), 2, 32, seed=seed)(step)
    got = make_batch_fn(get_smoke(arch), 2, 32, seed=seed)(step)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_shard_batch_for_learner():
    batch = {"x": np.arange(24).reshape(12, 2)}
    for learner in range(4):
        np.testing.assert_array_equal(
            shard_batch_for_learner(batch, learner, 4)["x"],
            jshard(batch, learner, 4)["x"])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_iterator(device):
    fn = lambda step: {"x": np.full((2,), step, np.int32)}
    got = list(PrefetchIterator(fn, steps=5, device=device))
    assert [int(b["x"][0]) for b in got] == [0, 1, 2, 3, 4]
    kind = np.ndarray if device is None else torch.Tensor
    assert all(isinstance(b["x"], kind) for b in got)


def test_prefetch_iterator_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchIterator(lambda s: {}, steps=1, device="cuda")


def _states():
    """(reference trees, port trees): SMOKE qwen2's bf16 parameters, a
    momentum velocity and an adamw state, nonzero, carried across."""
    jcfg = jget_smoke("qwen2_1_5b")
    cfg = get_smoke("qwen2_1_5b")
    jp = jinit_model(jcfg, jax.random.PRNGKey(0))
    np_p = jax.tree.map(lambda a: np.array(a, copy=True), jp)
    rng = np.random.default_rng(0)
    jv = {"velocity": jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), np_p)}
    ja = jinit_state(JSpec(optimizer="adamw"), jp)
    ja = jax.tree.map(lambda a: np.array(a, copy=True), ja)
    ja["mu"] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), ja["mu"])
    ja["count"] = np.array(7, np.int32)
    ref = {"params": np_p, "velocity": jv, "adamw": ja}
    port = {"params": model_params_from_jax(np_p, cfg, "cpu"),
            "velocity": tree_from_jax(jv, "cpu"),
            "adamw": tree_from_jax(ja, "cpu")}
    return ref, port


def _assert_same(port_tree, ref_tree, path=""):
    if isinstance(ref_tree, dict):
        assert sorted(port_tree) == sorted(ref_tree), path
        for k in ref_tree:
            _assert_same(port_tree[k], ref_tree[k], f"{path}/{k}")
        return
    ref = np.asarray(ref_tree)
    got = port_tree.detach()
    assert str(got.dtype).split(".")[-1] == ref.dtype.name, path
    np.testing.assert_array_equal(got.to(torch.float32).numpy()
                                  if got.is_floating_point() else
                                  got.numpy(), ref.astype(np.float32)
                                  if got.is_floating_point() else ref,
                                  err_msg=path)


@pytest.mark.parametrize("name", ["params", "velocity", "adamw"])
def test_checkpoints_cross_load(tmp_path, name):
    ref, port = _states()
    jtemplate = jax.tree.map(jax.numpy.asarray, ref[name])
    # the port writes, the reference reads
    save_checkpoint(str(tmp_path / "port.npz"), port[name], step=17)
    got, step = jload(str(tmp_path / "port.npz"), jtemplate)
    assert step == 17
    _assert_same(port[name], jax.tree.map(np.asarray, got))
    # the reference writes, the port reads (templates: zeros of the tree)
    jsave(str(tmp_path / "ref.npz"), jtemplate, step=23)
    template = tree_from_jax(jax.tree.map(np.zeros_like, ref[name]), "cpu")
    got, step = load_checkpoint(str(tmp_path / "ref"), template)
    assert step == 23
    _assert_same(got, ref[name])
    # the same keys and manifest
    for f in ("port.npz", "ref.npz"):
        with np.load(tmp_path / f) as data:
            keys = sorted(data.files)
        meta = json.loads((tmp_path / f"{f}.meta.json").read_text())
        assert meta["keys"] == keys
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        if name == "params":
            assert "units/block_0/attn/w_q" in a.files
            assert a["embed"].dtype == np.float32     # bf16 stored as fp32


def test_checkpoint_restores_to_the_template_device_and_checks_keys(
        tmp_path):
    _, port = _states()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, port["velocity"])
    template = dict(port["velocity"])
    template["extra"] = torch.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        load_checkpoint(path, template)
    got, step = load_checkpoint(path, port["velocity"])
    assert step == 0 and os.path.exists(path + ".meta.json")
    _assert_same(got, jax.tree.map(lambda t: t.numpy(), port["velocity"]))
