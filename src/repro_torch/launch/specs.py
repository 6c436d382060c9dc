"""Shape-only stand-ins for every input of a step, and the step callables
the dry-run traces (counterpart of ``repro/launch/specs.py``).

Where the reference builds ``jax.ShapeDtypeStruct``\\ s with a
``NamedSharding``, the port builds tensors on the meta device — shapes and
dtypes, no storage — each wrapped in a :class:`Sharded` with its partition
spec (``launch/sharding.py``) and the mesh.  Nothing is allocated on any
device.  :func:`build_lowerable` returns the step callable (train step,
``prefill_step`` or ``serve_step``) and its argument trees; :func:`values`
unwraps a tree of :class:`Sharded` into the meta tensors the callable
takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.config import InputShape, ModelConfig, RunConfig, \
    validate_pairing
from repro_torch.core.distributed import init_opt_state, make_train_step
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import AbstractMesh, data_axes, n_learners
from repro_torch.models import blocks as B
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_params, model_loss
from repro_torch.serve.engine import prefill_step, serve_step

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A meta tensor (the global shape and dtype) with its partition spec
    on ``mesh``."""

    value: torch.Tensor
    spec: shd.P
    mesh: AbstractMesh

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    def shard_shape(self) -> Tuple[int, ...]:
        return shd.shard_shape(self.shape, self.spec, self.mesh)

    def bytes_per_device(self) -> int:
        n = 1
        for d in self.shard_shape():
            n *= d
        return n * self.value.element_size()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def values(tree):
    """The meta tensors of a tree of :class:`Sharded` (other leaves, such
    as a position, pass through)."""
    return _tree_map(lambda s: s.value if isinstance(s, Sharded) else s,
                     tree)


def leaves(tree):
    """The leaves of nested dicts, tuples and lists, depth first."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def _sds(shape, dtype, mesh: AbstractMesh, spec: shd.P) -> Sharded:
    return Sharded(torch.empty(shape, dtype=dtype, device=META), spec, mesh)


def _model_axis_size(mesh: AbstractMesh) -> int:
    return mesh.shape["model"]


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh: AbstractMesh,
                with_labels: bool = True,
                mode_override: str = None) -> Dict[str, Sharded]:
    """Input batch stand-ins for (cfg, shape) on ``mesh``.
    Sequence-parallel archs shard the seq dim over ``model``."""
    Bt, S = shape.global_batch, shape.seq_len
    mode = mode_override or shd.parallelism_mode(cfg, _model_axis_size(mesh))
    bspec, sspec = shd.batch_spec_for(cfg, mesh, mode, Bt, S)
    dt = dtype_of(cfg.dtype)

    out: Dict[str, Sharded] = {}
    if cfg.frontend == "audio":
        out["frames"] = _sds((Bt, S, cfg.d_model), dt, mesh,
                             shd.P(bspec, sspec, None))
    elif cfg.frontend == "vision":
        npfx = cfg.n_prefix_embeds
        _, pspec = shd.batch_spec_for(cfg, mesh, mode, Bt, npfx)
        _, tspec = shd.batch_spec_for(cfg, mesh, mode, Bt, S - npfx)
        out["patches"] = _sds((Bt, npfx, cfg.d_model), dt, mesh,
                              shd.P(bspec, pspec, None))
        out["tokens"] = _sds((Bt, S - npfx), torch.int32, mesh,
                             shd.P(bspec, tspec))
    else:
        out["tokens"] = _sds((Bt, S), torch.int32, mesh, shd.P(bspec, sspec))
    if with_labels:
        out["labels"] = _sds((Bt, S), torch.int32, mesh, shd.P(bspec, sspec))
        out["loss_mask"] = _sds((Bt, S), torch.float32, mesh,
                                shd.P(bspec, sspec))
    return out


def fsdp_wide(cfg: ModelConfig, mesh: AbstractMesh, fsdp: bool,
              mode: str) -> bool:
    """ZeRO-3: seq-parallel giants shard parameters over data AND model
    (weights otherwise replicated over ``model`` would not fit)."""
    return (mode == "seq" and fsdp and
            cfg.param_count() * 2 / n_learners(mesh) > 8e9)


def params_specs(cfg: ModelConfig, mesh: AbstractMesh, fsdp: bool,
                 mode_override: str = None):
    """The parameter tree as :class:`Sharded` meta tensors."""
    shapes = init_params(cfg, None, META)
    mode = mode_override or shd.parallelism_mode(cfg, _model_axis_size(mesh))
    specs = shd.param_shardings(shapes, mesh, fsdp, mode=mode,
                                fsdp_wide=fsdp_wide(cfg, mesh, fsdp, mode))
    return _zip_map(lambda t, s: Sharded(t, s, mesh), shapes, specs)


def opt_specs(run: RunConfig, pspecs):
    """Optimizer state mirrors the parameters' specs (a state tree such as
    ``velocity/...`` takes the spec of the parameter at the same path);
    scalar counters are replicated."""
    params = values(pspecs)
    state = init_opt_state(run, params)
    flat = {p: s for p, s in shd.leaf_paths(pspecs)}
    mesh = next(iter(flat.values())).mesh

    def assign(path, leaf):
        sub = path.split("/", 1)[1] if "/" in path else path
        s = flat.get(sub)
        if s is None or leaf.dim() == 0:
            return Sharded(leaf, shd.P(), mesh)
        return Sharded(leaf, s.spec, mesh)
    return shd._map_paths(assign, state)


def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode caches of ``models.init_caches`` on the meta device."""
    dtype = dtype_of(cfg.dtype)
    return {f"block_{i}": B.init_block_cache(bt, cfg, batch, max_len, dtype,
                                             META, (cfg.n_units,))
            for i, bt in enumerate(cfg.block_pattern)}


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh: AbstractMesh):
    shapes = init_cache_shapes(cfg, shape.global_batch, shape.seq_len)
    specs = shd.cache_shardings(shapes, mesh, shape.global_batch)
    return _zip_map(lambda t, s: Sharded(t, s, mesh), shapes, specs)


# ---------------------------------------------------------------------------
# the three step callables
# ---------------------------------------------------------------------------
def make_run_config(cfg: ModelConfig, shape: InputShape, mesh: AbstractMesh,
                    protocol: str = "softsync", n_softsync: int = 4,
                    engine: str = "sequential",
                    num_microbatches: int = 0,
                    attn_q_chunk: int = 1024,
                    attn_kv_chunk: int = 1024,
                    seq_par_residual: bool = False,
                    mode_override: str = None) -> Tuple[RunConfig, str]:
    lam = n_learners(mesh)
    mb = num_microbatches or shd.default_microbatches(cfg, shape)
    residual_spec = None
    mode = mode_override or shd.parallelism_mode(cfg, _model_axis_size(mesh))
    if seq_par_residual and shape.kind != "decode" and mode == "head":
        dax = data_axes(mesh)
        residual_spec = (dax if len(dax) > 1 else dax[0], "model", None)
    run = RunConfig(
        residual_spec=residual_spec,
        protocol=protocol if shape.kind == "train" else "hardsync",
        n_softsync=n_softsync,
        n_learners=lam,
        minibatch=max(1, shape.global_batch // lam),
        lr_policy=("staleness_inverse" if protocol == "softsync"
                   else "sqrt_scale"),
        optimizer="momentum",                      # the paper's optimizer
        num_microbatches=mb,
        remat=True,
        fsdp=shd.needs_fsdp(cfg, mesh),
        attn_impl="chunked",
        attn_q_chunk=attn_q_chunk,
        attn_kv_chunk=attn_kv_chunk,
    )
    return run, engine


def build_lowerable(cfg: ModelConfig, shape: InputShape, mesh: AbstractMesh,
                    run: RunConfig, engine: str = "sequential",
                    mode_override: str = None):
    """Returns (step callable, argument trees of :class:`Sharded`); call
    ``fn(*values(args))`` to trace it on the meta device."""
    skip = validate_pairing(cfg, shape)
    if skip:
        raise ValueError(f"({cfg.name} × {shape.name}) skipped: {skip}")

    pspecs = params_specs(cfg, mesh, run.fsdp, mode_override=mode_override)

    if shape.kind == "train":
        def loss_fn(p, b, sample_weights=None):
            return model_loss(cfg, run, p, b, sample_weights=sample_weights)
        step = make_train_step(run, loss_fn, engine=engine)
        ospecs = opt_specs(run, pspecs)
        bspecs = batch_specs(cfg, shape, mesh, mode_override=mode_override)
        return step, (pspecs, ospecs, bspecs)

    if shape.kind == "prefill":
        def pf(params, batch):
            return prefill_step(cfg, run, params, batch)
        bspecs = batch_specs(cfg, shape, mesh, with_labels=False,
                             mode_override=mode_override)
        return pf, (pspecs, bspecs)

    # decode
    def dec(params, tokens, position, caches):
        return serve_step(cfg, run, params, tokens, position, caches)
    cspecs = cache_specs(cfg, shape, mesh)
    Bt = shape.global_batch
    dax = data_axes(mesh)
    dsize = 1
    for a in dax:
        dsize *= mesh.shape[a]
    bspec = (dax if len(dax) > 1 else dax[0]) if Bt % dsize == 0 else None
    tok = _sds((Bt, 1), torch.int32, mesh, shd.P(bspec))
    pos = _sds((), torch.int32, mesh, shd.P())
    return dec, (pspecs, tok, pos, cspecs)
