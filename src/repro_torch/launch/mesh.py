"""The emulated cluster of the SPMD replay (counterpart of
``repro/launch/mesh.py``, DESIGN.md §13) as ``torch.distributed`` ranks.

The reference emulates N host devices inside one jax process and
``shard_map``\\ s the replay scan over a ``(ps, learner)`` mesh of them.
Here a "device" of the mesh is a process of its own: one
``torch.distributed`` rank, spawned with the ``spawn`` start method (a
forked process cannot use CUDA), all ranks joined in one ``gloo`` group.
On the card every rank uses ``cuda:0``: NCCL will not run two ranks on one
device, so gloo carries the collectives on host tensors.

* :func:`ensure_host_devices` sets how many ranks a mesh may spawn (the
  port's device count; 1 until raised).
* :func:`shard_map` spawns a world of ranks, runs one function on every
  rank and returns rank 0's value.  A rank that raises or dies fails the
  call with its traceback; a world that outlives ``timeout`` is killed and
  fails it too.
* :func:`threads_per_process` is the share of the host's cores each of n
  processes on it takes: every rank of an n-rank world sets its torch
  threads to it.
* :func:`make_sim_mesh`, called by every rank of a world, returns this
  rank's place on the ``ps × learner`` mesh (rank r = s·L + l) and its
  ``"ps"`` group (the S ranks of learner block l) and ``"learner"`` group
  (the L ranks of shard s).  Every rank creates every group, in the same
  order, even the groups it is not in; ranks beyond S·L sit the mesh out.

The functions ``shard_map`` runs and the arguments it passes are pickled
into each rank: module-level functions, methods of module-level classes,
tensors (CPU tensors travel best) and numpy arrays.

**Production meshes** (the dry-run's): :func:`make_production_mesh` gives an
:class:`AbstractMesh` — axis names and sizes, nothing spawned and no
device touched — of 16 × 16 (``data``, ``model``) or 2 × 16 × 16 (``pod``,
``data``, ``model``) H100s.  The roofline charges them at H100 SXM rates
(NVIDIA H100 data sheet, SXM5): ``PEAK_FLOPS`` 989 TFLOP/s dense bf16,
``HBM_BW`` 3.35 TB/s HBM3, and ``ICI_BW`` 50 GB/s per GPU for collectives.
A 16 × 16 mesh of 8-GPU nodes spans 32 nodes, and the ``model`` axis (16
GPUs) spans two of them: a ring over it crosses the inter-node network, so
every axis is charged at the slower link, one 400 Gb/s NIC per GPU
(50 GB/s), not NVLink 4's 450 GB/s per direction per GPU inside a node
(``NVLINK_BW``, kept for reference).  A ring collective runs at the rate
of its slowest hop, and each of the mesh's axes has a hop between nodes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per H100 SXM
HBM_BW = 3.35e12             # HBM3 B/s per H100 SXM
ICI_BW = 50e9                # B/s per GPU between nodes (400 Gb/s NIC)
NVLINK_BW = 450e9            # B/s per direction per GPU inside a node

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")

# the emulated-cluster mesh of the SPMD replay: S parameter-server shards ×
# L learner-group ranks
SIM_AXES = ("ps", "learner")
# the longest a world may run before it is killed (the reference's
# distributed-replay subprocess limit)
SPAWN_TIMEOUT = 1800.0

_host_devices = 1
# inside a spawned rank: (rank, world size); None in any other process
_world: Optional[Tuple[int, int]] = None
_meshes: Dict[Tuple[int, int], "SimMesh"] = {}


def in_world() -> bool:
    """Whether this process is a rank of a :func:`shard_map` world."""
    return _world is not None


def device_count() -> int:
    """The ranks a mesh may use: the world's size inside a rank, else the
    count :func:`ensure_host_devices` set."""
    return _world[1] if _world is not None else _host_devices


def ensure_host_devices(n: int) -> int:
    """Let meshes spawn up to ``n`` ranks (a request for fewer keeps the
    larger count); returns the device count.  Inside a rank the world's
    size is fixed, and asking for more than it raises."""
    global _host_devices
    if n < 1:
        raise ValueError(f"need at least 1 device, got n={n}")
    if _world is not None:
        if n > _world[1]:
            raise RuntimeError(
                f"need {n} devices but this world has {_world[1]} ranks: "
                f"call launch.mesh.ensure_host_devices({n}) before "
                f"shard_map spawns the world")
        return _world[1]
    _host_devices = max(_host_devices, n)
    return _host_devices


def _require_devices(n: int, what: str) -> None:
    if device_count() < n:
        raise RuntimeError(
            f"{what} needs {n} devices but only {device_count()} are "
            f"visible; call launch.mesh.ensure_host_devices({n}) first")


@dataclasses.dataclass(frozen=True)
class SimMesh:
    """This rank's place on a ``ps × learner`` mesh and its two groups."""

    shape: Tuple[int, int]
    rank: int
    ps_ranks: Tuple[int, ...]           # the global ranks of its "ps" group
    learner_ranks: Tuple[int, ...]      # … of its "learner" group
    ps_group: object = None
    learner_group: object = None

    @property
    def devices(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def active(self) -> bool:
        """Whether this rank holds a place on the mesh."""
        return self.rank < self.devices

    def axis_size(self, axis: str) -> int:
        return self.shape[SIM_AXES.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (s for "ps", l for
        "learner")."""
        if axis == "ps":
            return self.rank // self.shape[1]
        return self.rank % self.shape[1]

    def group(self, axis: str):
        return self.ps_group if axis == "ps" else self.learner_group

    def ranks(self, axis: str) -> Tuple[int, ...]:
        return self.ps_ranks if axis == "ps" else self.learner_ranks


def make_sim_mesh(ps: int, learners: int) -> SimMesh:
    """The SPMD-replay cluster: ``ps × learners`` ranks of this world.

    Axis "ps" holds the S parameter-server shards (one (K, Dp) ring slice
    per rank); axis "learner" splits the c gradient slots of an update
    across learner-group ranks (DESIGN.md §13).  Collective: every rank of
    the world calls it with the same shape.  Meshes are cached per shape,
    so a world can replay many traces."""
    _require_devices(ps * learners, f"sim mesh ({ps}×{learners})")
    if _world is None:
        raise RuntimeError("make_sim_mesh runs inside a world of ranks: "
                           "call it from a function launch.mesh.shard_map "
                           "runs")
    key = (ps, learners)
    if key not in _meshes:
        import torch.distributed as dist
        rank = _world[0]
        ps_ranks = [tuple(s * learners + l for s in range(ps))
                    for l in range(learners)]
        learner_ranks = [tuple(s * learners + l for l in range(learners))
                         for s in range(ps)]
        # every rank creates every group, in one order
        ps_groups = [dist.new_group(list(r)) for r in ps_ranks]
        learner_groups = [dist.new_group(list(r)) for r in learner_ranks]
        if rank < ps * learners:
            s, l = divmod(rank, learners)
            mesh = SimMesh(key, rank, ps_ranks[l], learner_ranks[s],
                           ps_groups[l], learner_groups[s])
        else:
            mesh = SimMesh(key, rank, (), ())
        _meshes[key] = mesh
    return _meshes[key]


def threads_per_process(n: int) -> int:
    """Torch intra-op threads for each of ``n`` processes that share this
    host: an equal share of its cores, at least one."""
    return max(1, (os.cpu_count() or 1) // n)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, size: int, port: int, work: str, out: str,
               timeout: float) -> None:
    """One rank: join the gloo world, run the ``(fn, args)`` saved at
    ``work``, save rank 0's value to ``out``, meet the others at a barrier
    and leave."""
    global _world
    import torch.distributed as dist
    fn, args = torch.load(work, weights_only=False)
    # after the load: importing fn's module may set a count of its own (a
    # test module takes its test worker's share)
    torch.set_num_threads(threads_per_process(size))
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout))
    _world = (rank, size)
    try:
        value = fn(*args)
        if rank == 0:
            torch.save(value, out)
        dist.barrier()
    except BaseException:
        # the time first: the parent reports the first failure first (the
        # other ranks' collectives fail after it)
        with open(f"{out}.rank{rank}.err", "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
        _world = None
        _meshes.clear()


def _failures(out: str) -> str:
    """Every failed rank's traceback, the first failure first."""
    found = []
    for path in Path(out).parent.glob(Path(out).name + ".rank*.err"):
        when, tb = path.read_text().split("\n", 1)
        found.append((float(when), path.suffixes[-2][len(".rank"):], tb))
    return "\n".join(f"rank {r} failed:\n{tb}"
                     for _, r, tb in sorted(found))


def shard_map(fn: Callable, ranks: int, *args,
              timeout: float = SPAWN_TIMEOUT):
    """Run ``fn(*args)`` on each of ``ranks`` spawned ranks of one gloo
    world and return rank 0's value — where the reference runs one program
    per device of a mesh in one process, the port runs one process per
    device.

    ``fn`` and ``args`` must pickle.  The call fails if a rank raises or
    dies (with that rank's traceback) or if the world runs longer than
    ``timeout`` seconds (every rank is killed)."""
    if _world is not None:
        raise RuntimeError("shard_map cannot spawn a world from inside a "
                           "rank")
    _require_devices(ranks, f"a world of {ranks} ranks")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        # the work goes through a file, not the spawn pipe: a large pickle
        # in the pipe holds each start until its child has imported the
        # main module, so the ranks would start one after another
        work, out = str(Path(tmp) / "work.pt"), str(Path(tmp) / "rank0.pt")
        torch.save((fn, args), work)
        ctx = mp.start_processes(
            _rank_main, args=(ranks, _free_port(), work, out, timeout),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.1):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {ranks} ranks ran past its {timeout} s "
                        f"limit")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_failures(out) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(out, weights_only=False)


# ---------------------------------------------------------------------------
# production meshes (abstract: names and sizes only)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes, as the dry-run needs it: no rank
    is spawned and no device is touched."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        return "x".join(map(str, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(MULTI_POD_SHAPE, MULTI_POD_AXES)
    return AbstractMesh(SINGLE_POD_SHAPE, SINGLE_POD_AXES)


def data_axes(mesh: AbstractMesh) -> Tuple[str, ...]:
    """The learner (batch) axes: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def n_chips(mesh: AbstractMesh) -> int:
    return mesh.size


def n_learners(mesh: AbstractMesh) -> int:
    """λ for the distributed runtime = product of the learner axes."""
    lam = 1
    for a in data_axes(mesh):
        lam *= mesh.shape[a]
    return lam


def make_debug_mesh(data: int = 2, model: int = 2) -> AbstractMesh:
    """A small (data, model) mesh for CPU tests."""
    return AbstractMesh((data, model), ("data", "model"))
