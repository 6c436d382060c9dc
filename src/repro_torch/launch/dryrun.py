"""Multi-pod dry-run: trace every (architecture × input shape) on the
production meshes without a device and emit roofline terms (counterpart of
``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--protocol softsync --n 4] \\
        [--engine sequential|fused] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Where the reference lowers and compiles each step with XLA on 512 emulated
host devices and reads ``memory_analysis`` / ``cost_analysis``, the port
traces the step once on the meta device (``launch/specs.py``: shapes and
dtypes, no storage; nothing is allocated) under two dispatch modes:

* **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  matmuls, bmm, einsum), divided evenly over the mesh's devices.
* **Bytes accessed** — every op's operands and results (views move
  nothing), each scaled to one device: an argument by its leaf's shard
  fraction under the sharding policy, every other tensor by 1/chips.
* **Temporary bytes** — a live-tensor count: each new storage an op
  creates is added when it appears and taken off when the last tensor
  over it is freed; the peak over the trace, divided by the chips.

Per-device **argument bytes** come from the sharding policy and are exact
(every leaf's shard shape, ``Sharded.bytes_per_device``).  The
**collectives** have no HLO to parse: :func:`step_collectives` reckons
them from the policy (see its docstring), and ``launch/roofline`` sums
their wire bytes with the reference's ring factors.

Every dry-run extrapolates, as the reference's roofline probes do: the
step is traced with 1 and 2 units of the block pattern, hardsync, one
micro-batch (a linear batch split, FLOP- and byte-equivalent), the
chunked attention skipping fully masked chunk pairs (``unroll``), and
    total = probe1 + (U − 1) · (probe2 − probe1),
exact for FLOPs and bytes accessed (the units are identical) and for a
peak that grows per unit; the collectives of the run as configured
(sequential softsync's n gradient reductions a round included) are
reckoned for the full model.  So ``dryrun_one`` and ``probe_roofline``
share one method and differ in their flags and extra fields, as in the
reference's campaign.  The reference's
``XLA_FLAGS`` line has no counterpart: nothing here initialises a device.
"""

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import config as C
from repro_torch.config import INPUT_SHAPES, InputShape, ModelConfig, \
    validate_pairing
from repro_torch.configs import ARCH_IDS, get_config, long_context_variant
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (AbstractMesh, make_production_mesh,
                                     n_chips, n_learners)
from repro_torch.launch.specs import (Sharded, build_lowerable, leaves,
                                      make_run_config, params_specs, values)
from repro_torch.models.moe import capacity, groups


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Tally(TorchDispatchMode):
    """Bytes accessed per device and live bytes of a trace (see the module
    docstring).  ``fractions`` maps an argument's storage to its share on
    one device; other tensors take ``default``."""

    def __init__(self, fractions: Dict[int, float], default: float):
        super().__init__()
        self.fractions = fractions
        self.default = default
        self.accessed = 0.0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, List[int]] = {}

    def _release(self, key: int) -> None:
        entry = self._refs[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def _share(self, t: torch.Tensor) -> float:
        return self.fractions.get(_storage(t), self.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.accessed += sum(t.numel() * t.element_size() * self._share(t)
                                 for t in ins + outs)
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue            # an in-place op returns its operand
            key = _storage(t)
            if key in self.fractions:
                continue            # a view of an argument
            if key not in self._refs:
                self._refs[key] = [t.untyped_storage().nbytes(), 0]
                self.live += self._refs[key][0]
                self.peak = max(self.peak, self.live)
            self._refs[key][1] += 1
            weakref.finalize(t, self._release, key)
        return out


def _trace(cfg: ModelConfig, shape: InputShape, mesh: AbstractMesh, run,
           engine: str, mode_override: Optional[str]) -> dict:
    """One traced step: per-device FLOPs and bytes accessed, the global
    peak of live temporaries and the output bytes."""
    fn, args = build_lowerable(cfg, shape, mesh, run, engine=engine,
                               mode_override=mode_override)
    chips = n_chips(mesh)
    fractions = {}
    for s in leaves(args):
        if isinstance(s, Sharded):
            fractions[_storage(s.value)] = (
                s.bytes_per_device() / max(1, s.value.numel()
                                           * s.value.element_size()))
    tally = _Tally(fractions, 1.0 / chips)
    with FlopCounterMode(display=False) as fc, tally:
        out = fn(*values(args))
    out_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    return {"flops": fc.get_total_flops() / chips, "accessed": tally.accessed,
            "peak": tally.peak, "out_bytes": out_bytes / chips}


def _extrapolate(a: float, b: float, units: int) -> float:
    return a + (units - 1) * (b - a)


def _tokens_per_device(cfg, shape, mesh, mode, seq):
    ds = n_learners(mesh)
    bspec, sspec = shd.batch_spec_for(cfg, mesh, mode, shape.global_batch,
                                      seq)
    b = shape.global_batch // ds if bspec is not None else shape.global_batch
    s = seq // mesh.shape["model"] if sspec is not None else seq
    return b, s


def step_collectives(cfg: ModelConfig, shape: InputShape, mesh: AbstractMesh,
                     run, engine: str, mode: str,
                     pspecs) -> List[rl.Collective]:
    """The collectives one step of ``(cfg, shape)`` issues under the
    sharding policy, per device (activations in the model's dtype):

    * head-parallel: one all-reduce over ``model`` of the block's output
      (tokens × M) after each row-parallel product — attention's ``w_o``,
      a dense MLP's ``w_down``, a mamba ``w_out``, rwkv's ``w_o`` and its
      FFN ``w_v``;
    * sequence-parallel: each attention layer all-gathers K and V over
      ``model`` (prefill and train); a recurrent layer passes its final
      state to the next sequence shard (a collective-permute);
    * MoE (expert-parallel over ``model``): an all-to-all of the (groups,
      E, C, M) dispatch buffer there and one back;
    * decode against a context-parallel cache: each attention layer
      all-reduces its partial output and softmax statistics (fp32);
    * an embedding split over ``model`` on the vocab: one all-reduce of
      the looked-up rows;
    * FSDP: each leaf sharded over the learner axes is all-gathered before
      use (twice in training: forward and the remat recompute) and its
      gradient reduce-scattered;
    * training: forward collectives three times (forward, remat
      recompute, backward), and one all-reduce of every other leaf's
      gradient over the learners (bf16), n of them a round for
      sequential softsync.
    """
    ms = mesh.shape["model"]
    lam = n_learners(mesh)
    it = 2                                        # bf16 activations
    M, E = cfg.d_model, cfg.n_experts
    decode = shape.kind == "decode"
    seq = 1 if decode else shape.seq_len
    b, s = _tokens_per_device(cfg, shape, mesh, mode, seq)
    tok = b * s * it * M
    out: List[rl.Collective] = []
    layers = {bt: cfg.n_units * cfg.block_pattern.count(bt)
              for bt in set(cfg.block_pattern)}
    for bt, n in layers.items():
        attention = bt in (C.BLOCK_ATTN, C.BLOCK_MOE,
                           C.BLOCK_MOE_DENSE_RESIDUAL, C.BLOCK_SHARED_ATTN)
        dense = bt in (C.BLOCK_ATTN, C.BLOCK_MOE_DENSE_RESIDUAL,
                       C.BLOCK_SHARED_ATTN)
        if attention and decode:
            out.append(rl.Collective(
                "all-reduce", b * cfg.n_heads * (cfg.d_head + 2) * 4, ms, n))
        elif attention and mode == "seq":
            kv = b * seq * cfg.n_kv_heads * cfg.d_head * it
            out.append(rl.Collective("all-gather", kv, ms, 2 * n))
        if mode == "head":
            per = {C.BLOCK_MAMBA: 1, C.BLOCK_RWKV: 2}.get(
                bt, int(attention) + int(dense))
            out.append(rl.Collective("all-reduce", tok, ms, per * n))
        elif bt in (C.BLOCK_MAMBA, C.BLOCK_RWKV) and not decode:
            state = (b * cfg.ssm_n_heads * cfg.ssm_head_dim * cfg.ssm_state
                     if bt == C.BLOCK_MAMBA else
                     b * cfg.rwkv_n_heads * cfg.rwkv_head_dim ** 2) * 4
            out.append(rl.Collective("collective-permute", state, ms, n))
        if bt in (C.BLOCK_MOE, C.BLOCK_MOE_DENSE_RESIDUAL):
            G, T = groups(b, s, E)
            buf = G * E * capacity(T, cfg) * M * it
            out.append(rl.Collective("all-to-all", buf, ms, 2 * n))
    embed = next(v for p, v in shd.leaf_paths(pspecs) if p == "embed")
    if embed.spec[0] == "model":
        out.append(rl.Collective("all-reduce", tok, ms))
    if shape.kind == "train":
        out = [dataclasses.replace(c, count=3 * c.count) for c in out]
    n_rounds = (max(1, run.n_softsync) if shape.kind == "train"
                and run.protocol in ("softsync", "async")
                and engine == "sequential" else 1)
    for _, leaf in shd.leaf_paths(pspecs):
        local = leaf.bytes_per_device() // leaf.value.element_size() * it
        group = _fsdp_group(leaf.spec, mesh)
        if group > 1:
            passes = 2 if shape.kind == "train" else 1
            out.append(rl.Collective("all-gather", local * group, group,
                                     passes))
            if shape.kind == "train":
                out.append(rl.Collective("reduce-scatter", local, group,
                                         n_rounds))
        elif shape.kind == "train":
            out.append(rl.Collective("all-reduce", local, lam, n_rounds))
    return out


def _fsdp_group(spec, mesh: AbstractMesh) -> int:
    """The devices a leaf's FSDP shard is spread over: the axes of the dim
    that names a learner axis (1 if none does)."""
    for axes in spec:
        names = axes if isinstance(axes, tuple) else (axes,)
        if any(a in ("data", "pod") for a in names):
            n = 1
            for a in names:
                n *= mesh.shape[a]
            return n
    return 1


def _grad_allreduce_bytes(cfg, mesh, fsdp: bool) -> float:
    """Analytic per-device wire bytes of ONE gradient all-reduce over the λ
    learner groups (ring, bf16 grads), the probe row's ``ar_grad_bytes``
    (a sequential softsync round issues n of them)."""
    pspecs = params_specs(cfg, mesh, fsdp)
    lam = n_learners(mesh)
    total_local = 0
    for leaf in leaves(pspecs):
        n = 1
        for d in leaf.shard_shape():
            n *= d
        total_local += n * 2        # bf16
    return 2.0 * total_local * (lam - 1) / lam


def _resolve(arch: str, shape_name: str, cfg, shape):
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    if shape.name == "long_500k":
        cfg = long_context_variant(cfg)
    return cfg, shape


def _costs(cfg, shape, mesh, protocol, n_softsync, engine, num_microbatches,
           attn_q_chunk, attn_kv_chunk, seq_par_residual, mode_override):
    """The run config, and the step's costs extrapolated from traces of 1
    and 2 units (hardsync, one micro-batch, masked chunk pairs skipped)."""
    run, engine = make_run_config(cfg, shape, mesh, protocol=protocol,
                                  n_softsync=n_softsync, engine=engine,
                                  num_microbatches=num_microbatches,
                                  attn_q_chunk=attn_q_chunk,
                                  attn_kv_chunk=attn_kv_chunk,
                                  seq_par_residual=seq_par_residual,
                                  mode_override=mode_override)
    probes = []
    for u in (1, 2):
        cfg_u = dataclasses.replace(cfg, n_units=u)
        run_u, _ = make_run_config(cfg_u, shape, mesh, protocol="hardsync",
                                   engine="sequential", num_microbatches=1,
                                   attn_q_chunk=attn_q_chunk,
                                   attn_kv_chunk=attn_kv_chunk,
                                   seq_par_residual=seq_par_residual,
                                   mode_override=mode_override)
        run_u = run_u.replace(unroll=True, fsdp=run.fsdp)
        probes.append(_trace(cfg_u, shape, mesh, run_u, "sequential",
                             mode_override))
    U = cfg.n_units
    cost = {k: _extrapolate(probes[0][k], probes[1][k], U)
            for k in probes[0]}
    return run, engine, cost


def _arg_bytes(cfg, shape, mesh, run, engine, mode_override):
    """(all argument bytes, parameter bytes) per device, from the policy."""
    _, args = build_lowerable(cfg, shape, mesh, run, engine=engine,
                              mode_override=mode_override)
    params = sum(s.bytes_per_device() for s in leaves(args[0]))
    total = sum(s.bytes_per_device() for s in leaves(args)
                if isinstance(s, Sharded))
    return total, params, args[0]


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               protocol: str = "softsync", n_softsync: int = 4,
               engine: str = "sequential", num_microbatches: int = 0,
               attn_q_chunk: int = 1024, attn_kv_chunk: int = 1024,
               seq_par_residual: bool = False, mode_override: str = None,
               verbose: bool = True, mesh: Optional[AbstractMesh] = None,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[InputShape] = None) -> dict:
    """One (arch × shape) on a production mesh (or ``mesh``; ``cfg`` and
    ``shape`` override the registry's, e.g. a model cut in depth on a
    1 × 1 mesh).  Returns the reference's result row."""
    cfg, shape = _resolve(arch, shape_name, cfg, shape)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name
    skip = validate_pairing(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": skip}
    t0 = time.time()
    run, engine, cost = _costs(cfg, shape, mesh, protocol, n_softsync,
                               engine, num_microbatches, attn_q_chunk,
                               attn_kv_chunk, seq_par_residual,
                               mode_override)
    t_trace = time.time() - t0
    arg_bytes, param_bytes, pspecs = _arg_bytes(cfg, shape, mesh, run,
                                                engine, mode_override)
    mode = mode_override or shd.parallelism_mode(cfg, mesh.shape["model"])
    colls = step_collectives(cfg, shape, mesh, run, engine, mode, pspecs)
    roof = rl.analyse(arch, shape_name, mesh_name, n_chips(mesh),
                      {"flops": cost["flops"],
                       "bytes accessed": cost["accessed"]},
                      colls, rl.model_flops(cfg, shape))
    temp = int(cost["peak"] / n_chips(mesh))
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "protocol": run.protocol, "n_softsync": run.n_softsync,
        "engine": engine, "num_microbatches": run.num_microbatches,
        "fsdp": run.fsdp,
        # the trace stands where the reference lowers and compiles
        "lower_s": round(t_trace, 1), "compile_s": round(t_trace, 1),
        "bytes_per_device": int(temp + arg_bytes + cost["out_bytes"]),
        "temp_bytes": temp,
        "arg_bytes": int(arg_bytes),
        "param_bytes": int(param_bytes),
        **{k: v for k, v in roof.row().items()
           if k not in ("arch", "shape", "mesh")},
        "coll_breakdown": {k: v for k, v in roof.coll_breakdown.items()
                           if v > 0},
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] OK "
              f"trace {t_trace:.0f}s | "
              f"t_comp {roof.t_compute*1e3:.1f}ms "
              f"t_mem {roof.t_memory*1e3:.1f}ms "
              f"t_coll {roof.t_collective*1e3:.1f}ms "
              f"-> {roof.dominant}-bound | useful "
              f"{roof.useful_flops_ratio:.2f} "
              f"| {result['bytes_per_device']/2**30:.1f} GiB/dev")
        sys.stdout.flush()
    return result


def probe_roofline(arch: str, shape_name: str, *, multi_pod: bool = False,
                   protocol: str = "softsync", n_softsync: int = 4,
                   engine: str = "sequential",
                   attn_q_chunk: int = 1024, attn_kv_chunk: int = 1024,
                   seq_par_residual: bool = False, mode_override: str = None,
                   verbose: bool = True) -> dict:
    """The roofline row of the reference's probe: the same extrapolated
    trace as :func:`dryrun_one` at one micro-batch, with the per-unit and
    fixed parts of the collectives and one gradient all-reduce's bytes."""
    cfg, shape = _resolve(arch, shape_name, None, None)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name
    skip = validate_pairing(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": skip}
    t0 = time.time()
    run, engine, cost = _costs(cfg, shape, mesh, protocol, n_softsync,
                               engine, 1, attn_q_chunk, attn_kv_chunk,
                               seq_par_residual, mode_override)
    mode = mode_override or shd.parallelism_mode(cfg, mesh.shape["model"])
    pspecs = params_specs(cfg, mesh, run.fsdp, mode_override=mode_override)
    per_unit = []
    for u in (1, 2):
        cfg_u = dataclasses.replace(cfg, n_units=u)
        per_unit.append(rl.collective_bytes(step_collectives(
            cfg_u, shape, mesh, run, engine, mode,
            params_specs(cfg_u, mesh, run.fsdp,
                         mode_override=mode_override)))["total"])
    colls = step_collectives(cfg, shape, mesh, run, engine, mode, pspecs)
    G = n_softsync if (protocol in ("softsync", "async")
                       and shape.kind == "train") else 1
    roof = rl.analyse(arch, shape_name, mesh_name, n_chips(mesh),
                      {"flops": cost["flops"],
                       "bytes accessed": cost["accessed"]},
                      colls, rl.model_flops(cfg, shape))
    breakdown = {k: v for k, v in roof.coll_breakdown.items()
                 if v > 0 and k != "total"}
    coll_per_unit = per_unit[1] - per_unit[0]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "kind": "probe",
              "protocol": protocol, "n_softsync": G,
              "probe_seconds": round(time.time() - t0, 1),
              "ar_grad_bytes": _grad_allreduce_bytes(cfg, mesh, run.fsdp),
              "coll_fixed_bytes": per_unit[0] - coll_per_unit,
              "coll_per_unit_bytes": coll_per_unit,
              **{k: v for k, v in roof.row().items()
                 if k not in ("arch", "shape", "mesh")},
              "coll_breakdown": breakdown}
    if verbose:
        print(f"[probe {arch} × {shape_name} × {mesh_name}] "
              f"t_comp {roof.t_compute*1e3:.1f}ms "
              f"t_mem {roof.t_memory*1e3:.1f}ms "
              f"t_coll {roof.t_collective*1e3:.1f}ms "
              f"-> {roof.dominant}-bound | useful "
              f"{roof.useful_flops_ratio:.3f} | "
              f"{result['probe_seconds']}s")
        sys.stdout.flush()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--protocol", default="softsync",
                    choices=["hardsync", "softsync", "async"])
    ap.add_argument("--n", type=int, default=4, dest="n_softsync")
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "fused"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--q-chunk", type=int, default=1024)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--mode", default="main", choices=["main", "probe"])
    ap.add_argument("--seq-par-residual", action="store_true")
    ap.add_argument("--force-mode", default=None, choices=["head", "seq"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    pairs = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                pairs.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]

    results = []
    for a, s in pairs:
        try:
            if args.mode == "probe":
                results.append(probe_roofline(
                    a, s, multi_pod=args.multi_pod, protocol=args.protocol,
                    n_softsync=args.n_softsync, engine=args.engine,
                    attn_q_chunk=args.q_chunk, attn_kv_chunk=args.kv_chunk,
                    seq_par_residual=args.seq_par_residual,
                    mode_override=args.force_mode))
                continue
            results.append(dryrun_one(
                a, s, multi_pod=args.multi_pod, protocol=args.protocol,
                n_softsync=args.n_softsync, engine=args.engine,
                num_microbatches=args.microbatches,
                attn_q_chunk=args.q_chunk, attn_kv_chunk=args.kv_chunk,
                seq_par_residual=args.seq_par_residual,
                mode_override=args.force_mode))
        except Exception as e:
            traceback.print_exc()
            results.append({"arch": a, "shape": s,
                            "mesh": "2x16x16" if args.multi_pod else "16x16",
                            "status": "error", "error": repr(e)})
            sys.stdout.flush()

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    else:
        print(json.dumps(results))
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skip")
    err = sum(1 for r in results if r["status"] == "error")
    print(f"\n== dry-run summary: {ok} ok / {sk} skip / {err} error ==")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
