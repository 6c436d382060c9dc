"""Sharding policy (counterpart of ``repro/launch/sharding.py``): the
partition specs of parameters, inputs and caches on a production mesh, and
the placement specs of the SPMD replay.

A spec is a :class:`P`: per leading dim, the mesh axis it is split over
(a name, a tuple of names, or None: replicated), as jax's
``PartitionSpec``.  Meshes are the abstract ones of ``launch/mesh.py``
(names and sizes); :func:`shard_shape` gives a leaf's per-device block.

Two tensor-parallel modes, chosen per architecture (DESIGN.md §9):

* **head-parallel** (``n_heads % model_axis == 0``, likewise for SSM/RWKV
  head counts): Megatron-style.  Attention Q/O sharded over heads (K/V
  replicated when the GQA kv count does not divide), MLP column→row
  parallel, Mamba/RWKV channel dims sharded on head boundaries.  Used by:
  llama3-405b (128H), internvl2 (16H), hubert (16H), zamba2 (32H attn /
  112 ssm heads), rwkv6 (64 heads).
* **sequence-parallel** (indivisible head counts: qwen2 12H, qwen3 40H,
  starcoder2 36H, arctic 56H, llama4 40H): weights replicated over
  ``model``, activations sharded over the *sequence* dim on ``model``;
  attention gathers K/V (small under GQA).

MoE experts are always expert-parallel over ``model``.  FSDP (≥ 50 B
params, or ≥ 5 B in seq-parallel mode) also shards parameters over the
learner (``data``/``pod``) axes.  The layer-stack axis (dim 0 of every
``units`` leaf) is never sharded.

SPMD replay (DESIGN.md §13): the replay's carry is (ring, state, residue)
with a leading shard axis — (S, K, W) / (S, W) — one slice per "ps" rank.
The trace inputs replicate the small per-event tensors on every rank and
shard only the minibatch leaves — (steps, c, …) — over the "learner" axis
on the slot dim.  The per-shard pulled-row matrix ``sts`` (steps, c, S)
shards its trailing axis over "ps".  The what-if coefficients (a, w*),
packed (S, W), shard over "ps" like the carry; :func:`local_block` cuts a
rank's block out of a full array.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.config import InputShape, ModelConfig
from repro_torch.launch.mesh import AbstractMesh, data_axes
from repro_torch.optim.flatten import tree_map


class P(tuple):
    """Partition spec: one mesh axis name (or None) per leading dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def _axis_size(mesh: AbstractMesh, name: str) -> int:
    return mesh.shape[name]


def _data_size(mesh: AbstractMesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= _axis_size(mesh, a)
    return n


def _dspec(mesh: AbstractMesh):
    dax = data_axes(mesh)
    return dax if len(dax) > 1 else dax[0]


def parallelism_mode(cfg: ModelConfig, model_size: int) -> str:
    """'head' or 'seq' — see the module docstring."""
    from repro_torch import config as C
    if cfg.has_attention and cfg.n_heads % model_size != 0:
        return "seq"
    if C.BLOCK_MAMBA in cfg.block_pattern and \
            cfg.ssm_n_heads % model_size != 0:
        return "seq"
    if C.BLOCK_RWKV in cfg.block_pattern and \
            cfg.rwkv_n_heads % model_size != 0:
        return "seq"
    return "head"


def needs_fsdp(cfg: ModelConfig, mesh: AbstractMesh) -> bool:
    mode = parallelism_mode(cfg, _axis_size(mesh, "model"))
    threshold = 5e9 if mode == "seq" else 5e10
    return cfg.param_count() > threshold


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
def _head_spec(name: str, shape, ms: int, F) -> Optional[tuple]:
    """Per-leaf spec (head-parallel mode).  ``F`` = fsdp axes or None.
    ``name`` is the final path segment with its parent (e.g.
    'attn/w_q')."""
    def div(d):
        return shape[d] % ms == 0 and shape[d] >= ms

    if name.endswith("/w_q"):
        return (F, "model", None) if div(1) else (F, None, None)
    if name.endswith("/w_k") and len(shape) == 3 or \
            name.endswith("/w_v") and len(shape) == 3:
        return (F, "model", None) if div(1) else (F, None, None)
    if name.endswith("/w_o") and len(shape) == 3:
        return ("model", None, F) if div(0) else (None, None, F)
    if name.endswith(("/b_q", "/b_k", "/b_v")):
        return ("model", None) if div(0) else (None, None)
    if name.endswith(("/q_norm", "/k_norm")):
        return (None,)
    # dense MLP (SwiGLU)
    if name.endswith(("mlp/w_gate", "mlp/w_up")):
        return (F, "model") if div(1) else (F, None)
    if name.endswith("mlp/w_down"):
        return ("model", F) if div(0) else (None, F)
    # MoE experts: expert-parallel
    if "/moe/" in name and len(shape) == 3:
        return ("model", F, None) if div(0) else (F, None, None)
    if name.endswith("w_router"):
        return (None, None)
    # Mamba2
    if name.endswith(("/w_z", "/w_x", "/w_dt")):
        return (F, "model") if div(1) else (F, None)
    if name.endswith("/w_bc"):
        return (F, None)
    if name.endswith(("/conv_x",)):
        return (None, "model") if div(1) else (None, None)
    if name.endswith(("/conv_bc",)):
        return (None, None)
    if name.endswith(("/conv_bx", "/A_log", "/D", "/dt_bias",
                      "/norm_scale")):
        return ("model",) if div(0) else (None,)
    if name.endswith("/conv_bbc"):
        return (None,)
    if name.endswith("/w_out"):
        return ("model", F) if div(0) else (None, F)
    # RWKV6
    if name.endswith(("/w_r", "/w_g")) or \
            (name.endswith("/w_k") and len(shape) == 2 and
             "ffn" not in name) or \
            (name.endswith("/w_v") and len(shape) == 2 and "ffn" not in name):
        return (F, "model") if div(1) else (F, None)
    if name.endswith("rwkv/w_o"):
        return ("model", F) if div(0) else (None, F)
    if name.endswith("/decay_A"):
        return (F, None)
    if name.endswith("/decay_B"):
        return (None, "model") if div(1) else (None, None)
    if name.endswith("/bonus_u"):
        return ("model", None) if div(0) else (None, None)
    if name.endswith("ffn/w_k"):
        return (F, "model") if div(1) else (F, None)
    if name.endswith("ffn/w_v"):
        return ("model", F) if div(0) else (None, F)
    return None


def _spec_for_leaf(path: str, shape: Tuple[int, ...], mesh: AbstractMesh,
                   mode: str, fsdp: bool, fsdp_wide: bool = False) -> P:
    ms = _axis_size(mesh, "model")
    ds = _data_size(mesh)
    dspec = _dspec(mesh)

    is_stacked = path.startswith("units/")
    inner = path.split("/", 1)[1] if is_stacked else path
    shp = shape[1:] if is_stacked else shape

    # top-level leaves
    if inner == "embed":                      # (V, M)
        spec = ("model" if shp[0] % ms == 0 else None, None)
    elif inner == "head":                     # (M, V)
        spec = (None, "model" if shp[1] % ms == 0 else None)
    elif inner.startswith("final_norm") or inner.startswith("frontend"):
        spec = (None,) * len(shp)
    elif mode == "head" or inner.split("/")[0] == "shared" or \
            "/moe/" in inner or inner.endswith("w_router"):
        s = _head_spec("/" + inner, shp, ms, None)
        spec = s if s is not None else (None,) * len(shp)
    else:
        # seq-parallel: replicate over model (experts handled above)
        spec = (None,) * len(shp)

    spec = list(spec)
    # FSDP: shard one replicated-so-far dim over the learner axes; for
    # seq-parallel giants (ZeRO-3) over data AND model when the leaf does
    # not already use `model`
    if fsdp:
        wide = fsdp_wide and all(s != "model" for s in spec)
        fspec = ((tuple(data_axes(mesh)) + ("model",)) if wide else dspec)
        fsize = ds * (ms if wide else 1)
        cand = sorted(range(len(shp)), key=lambda d: -shp[d])
        for d in cand:
            if spec[d] is None and shp[d] % fsize == 0 and shp[d] >= fsize:
                spec[d] = fspec
                break
    if is_stacked:
        spec = [None] + spec
    return P(*spec)


def leaf_paths(tree, prefix=()):
    """(path "a/b/c", leaf) of every leaf of a nested dict, depth first in
    key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _map_paths(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def param_shardings(params_shape, mesh: AbstractMesh, fsdp: bool,
                    mode: Optional[str] = None, fsdp_wide: bool = False):
    """The spec of every leaf of a parameter tree (tensors, meta ones
    included: only shapes are read), as a tree of :class:`P`."""
    if mode is None:
        raise ValueError("pass mode explicitly (parallelism_mode(cfg, ...))")
    return _map_paths(lambda path, leaf: _spec_for_leaf(
        path, tuple(leaf.shape), mesh, mode, fsdp, fsdp_wide), params_shape)


# ---------------------------------------------------------------------------
# inputs & caches
# ---------------------------------------------------------------------------
def batch_spec_for(cfg: ModelConfig, mesh: AbstractMesh, mode: str,
                   batch: int, seq: int):
    """(batch_axis_spec, seq_axis_spec) for (B, S)-shaped inputs."""
    ds = _data_size(mesh)
    ms = _axis_size(mesh, "model")
    bspec = _dspec(mesh) if batch % ds == 0 and batch >= ds else None
    sspec = ("model" if mode == "seq" and seq % ms == 0 and seq > ms
             else None)
    return bspec, sspec


def cache_shardings(caches_shape, mesh: AbstractMesh, batch: int):
    """Decode caches (units, B, ...): batch over learners; the context or
    state dim over ``model`` — context-parallel decode (every device holds
    1/16 of the KV history or the head-sharded recurrent state)."""
    ms = _axis_size(mesh, "model")
    ds = _data_size(mesh)
    dspec = _dspec(mesh)

    def leaf_spec(_path, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % ds == 0 and shape[1] >= ds:
            spec[1] = dspec
        # first dim after batch that divides the model axis: for KV caches
        # the context dim C; for SSM/RWKV states the head dim H
        for d in range(2, len(shape)):
            if shape[d] % ms == 0 and shape[d] >= ms:
                spec[d] = "model"
                break
        return P(*spec)
    return _map_paths(leaf_spec, caches_shape)


def replicated(mesh: AbstractMesh) -> P:
    return P()


def shard_shape(shape: Tuple[int, ...], spec: P,
                mesh: AbstractMesh) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` leaf under ``spec`` (each split
    dim divided by the product of its axes' sizes, rounded up)."""
    out = list(shape)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        n = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            n *= _axis_size(mesh, a)
        out[d] = -(-out[d] // n)
    return tuple(out)


def default_microbatches(cfg: ModelConfig, shape: InputShape,
                         data_shards: int = 16, model_shards: int = 16,
                         budget_bytes: float = 10e9) -> int:
    """Gradient-accumulation factor so train activations fit device memory.

    Estimate: remat keeps one residual-stream copy per unit plus ~4x
    transients for the live unit's backward (fp32 intermediates), sharded
    over data (and over model for sequence-parallel archs)."""
    if shape.kind != "train":
        return 1
    mode = parallelism_mode(cfg, model_shards)
    tokens_per_dev = shape.global_batch * shape.seq_len / data_shards
    if mode == "seq":
        tokens_per_dev /= model_shards
    act = tokens_per_dev * cfg.d_model * cfg.n_units * 2 * 5.0
    mb = 1
    while act / mb > budget_bytes and mb < 64:
        mb *= 2
    # each micro-batch must still cover every data shard (and the softsync
    # group split)
    mb = min(mb, max(1, shape.global_batch // (4 * data_shards) * 4))
    while (shape.global_batch // 4) % mb != 0 and mb > 1:
        mb //= 2
    return mb


# ---------------------------------------------------------------------------
# SPMD replay placement specs (DESIGN.md §13)
# ---------------------------------------------------------------------------
def spmd_carry_specs() -> Tuple[P, P, P]:
    """(ring, state, residue): every carry leaf shards dim 0 over "ps"
    (state and residue may be None)."""
    return (P("ps"), P("ps"), P("ps"))


def spmd_xs_specs(keys) -> Dict[str, Any]:
    """Spec per trace-input key (``engine._trace_xs``).  "batch" is a
    prefix: one spec for every leaf of the minibatch tree."""
    specs: Dict[str, Any] = {}
    for key in keys:
        if key == "sts":
            specs[key] = P(None, None, "ps")
        elif key == "batch":
            specs[key] = P(None, "learner")
        else:
            specs[key] = P()
    return specs


def spmd_aux_specs() -> Tuple[P, P]:
    """(a, wstar) what-if coefficients, shard-packed to (S, W): per "ps"."""
    return (P("ps"), P("ps"))


def local_block(x, spec: P, mesh):
    """This rank's block of ``x`` (a tensor, an array or a tree of them)
    under ``spec``: each dim named in the spec is cut into equal contiguous
    blocks, one per index along that mesh axis."""
    def cut(a):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.axis_size(axis)
            if a.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {a.shape[dim]} does not "
                                 f"split into {n} blocks over {axis!r}")
            size = a.shape[dim] // n
            lo = mesh.axis_index(axis) * size
            a = a[(slice(None),) * dim + (slice(lo, lo + size),)]
        return a
    return tree_map(cut, x)
