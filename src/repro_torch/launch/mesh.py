"""Meshes of the port (port of `repro.launch.mesh`) and the launcher of
its ranks.

The port runs SPMD over `torch.distributed`: one process and one device
a rank, every rank the same program. `spawn(n, fn)` starts the ranks (a
file store in a temp dir, no network), `make_serving_mesh(n)` is the
serving engine's mesh over them: axes ("data", "model"), data 1, model n
(the engine's slot pool is the batch dim and stays host-driven, as in the
reference). `make_train_mesh(data, model)` is a train step's (data,
model) mesh over data x model ranks, rank r at (r // model, r % model),
the layout of the reference's `devices.reshape(data, model)`. A serving
mesh carries the process group, its backend and this rank's device, a
train mesh its data group, its model group (as a serving mesh over those
ranks, which the trunk's collectives read) and the device; `.shape` and
`.axis_names` are what the sharding rules read
(`distributed/sharding.py`). The production meshes have no host to
run on here: `make_production_mesh` returns their shape only, for the
rules.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..distributed.sharding import MeshShape

# NVIDIA H100 SXM5 80GB data sheet (dense, no sparsity): roofline targets
PEAK_FLOPS_BF16 = 989e12    # H100 SXM5: FLOP/s per card, bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12     # H100 SXM5: FLOP/s per card, fp32
HBM_BW = 3.35e12            # H100 SXM5: HBM3 bytes/s per card
NVLINK_BW = 450e9           # H100 SXM5: NVLink 4 bytes/s per direction
HBM_BYTES = 80e9            # H100 SXM5: HBM3 capacity per card


@dataclass(frozen=True, eq=False)
class ServingMesh(MeshShape):
    """The sharded engine's mesh on one rank: `rank` is this process's
    position on the model axis, `group` the process group (None for a
    single process with no group: every collective is then the identity),
    `ctrl_group` a gloo group over the same ranks for the step loop's
    control broadcast (`distributed.api.broadcast_control`), `ranks` the
    group's global ranks, `device` this rank's device."""
    rank: int = 0
    group: object = None
    ctrl_group: object = None
    backend: Optional[str] = None
    device: torch.device = field(default_factory=lambda:
                                 torch.device("cpu"))
    ranks: tuple = (0,)

    def global_rank(self, i: int) -> int:
        return self.ranks[i]


@dataclass(frozen=True, eq=False)
class TrainMesh(MeshShape):
    """A sharded train step's (data, model) mesh on one rank: `rank` is
    this process's coordinate on the data axis and `group` its data group
    (the ranks of its model coordinate; None for one data rank: its
    collectives are then identities); `model_rank` its coordinate on the
    model axis and `model_mesh` its model group (the ranks of its data
    coordinate) as a `ServingMesh` of data 1, model M (None at model 1);
    `device` this rank's device. `size` is the data group's: the
    collectives that take the mesh run over it."""
    rank: int = 0
    group: object = None
    device: torch.device = field(default_factory=lambda:
                                 torch.device("cpu"))
    model_rank: int = 0
    model_mesh: Optional[ServingMesh] = None

    @property
    def size(self) -> int:
        return self.shape["data"]

    @property
    def mesh_rank(self) -> int:
        """This rank's place on the mesh, row-major (its global rank)."""
        return self.rank * self.shape["model"] + self.model_rank

    @property
    def lead(self) -> bool:
        """True on the rank at (0, 0), which logs and writes."""
        return self.rank == 0 and self.model_rank == 0


def make_train_mesh(data: Optional[int] = None, model: int = 1,
                    device="cuda") -> TrainMesh:
    """The (data, model) mesh of a sharded train step over the ranks of
    the initialized process group (`spawn` starts them): model `model`,
    data `data` (default: the world size over model). Rank r sits at
    (r // model, r % model) and trains on device `cuda:{r %
    device_count}` (or the CPU when asked). Every rank creates every
    group, in one order: the data groups (one a model coordinate), then
    the model groups (one a data coordinate). Without a process group,
    data and model must be 1 and the mesh's collectives are identities.
    Raises ValueError for data or model below 1, or data x model other
    than the group's world size."""
    import torch.distributed as dist
    world = _world()
    m = int(model)
    d = world // max(m, 1) if data is None else int(data)
    if d < 1 or m < 1 or d * m != world:
        raise ValueError(f"training mesh (data {d}, model {m}) needs a "
                         f"process group of {d * m} ranks, got {world}")
    dev = resolve_device(device)
    shape = {"data": d, "model": m}
    if not dist.is_initialized():
        return TrainMesh(shape, ("data", "model"), device=dev)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if m == 1:
        return TrainMesh(shape, ("data", "model"), rank=rank,
                         group=dist.group.WORLD if d > 1 else None,
                         device=dev)
    ranks_of = lambda i: [i + m * j for j in range(d)]
    rows_of = lambda j: [m * j + i for i in range(m)]
    data_groups = [dist.new_group(ranks_of(i)) for i in range(m)] \
        if d > 1 else None
    model_groups = [dist.new_group(rows_of(j)) for j in range(d)] \
        if d > 1 else [dist.group.WORLD]
    di, mi = divmod(rank, m)
    model_mesh = ServingMesh({"data": 1, "model": m}, ("data", "model"),
                             rank=mi, group=model_groups[di],
                             backend=dist.get_backend(), device=dev,
                             ranks=tuple(rows_of(di)))
    return TrainMesh(shape, ("data", "model"), rank=di,
                     group=data_groups[mi] if data_groups else None,
                     device=dev, model_rank=mi, model_mesh=model_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes (16x16 single pod, 2x16x16
    multi-pod), as shapes for the sharding rules."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16},
                         ("pod", "data", "model"))
    return MeshShape({"data": 16, "model": 16}, ("data", "model"))


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_local_mesh(model_axis: int = 1) -> MeshShape:
    """(data, model) over the ranks of the process group (one rank
    without one)."""
    return MeshShape({"data": _world() // model_axis, "model": model_axis},
                     ("data", "model"))


def make_serving_mesh(model_parallel: int = 1, backend: Optional[str] = None,
                      device="cuda") -> ServingMesh:
    """The serving engine's mesh: a "model" axis of `model_parallel`
    ranks of the initialized process group (`spawn` starts them), data 1.
    Rank r serves from device `cuda:{r % device_count}` (or the CPU when
    asked); no card raises. `backend`, when given, must be the group's.
    Raises ValueError for model_parallel < 1 or above the group's world
    size. Without a process group, model_parallel 1 gives a mesh whose
    collectives are identities."""
    import torch.distributed as dist
    m = int(model_parallel)
    if m < 1:
        raise ValueError(f"model_parallel must be >= 1, got {m}")
    world = _world()
    if m > world:
        raise ValueError(
            f"serving mesh wants {m} ranks but the process group has "
            f"{world} (start them with repro_torch.launch.mesh.spawn, or "
            f"`launch.serve --mesh {m}`)")
    dev = resolve_device(device)
    if not dist.is_initialized():
        if backend is not None:
            raise ValueError(f"backend {backend!r} asked for, but no "
                             f"process group is initialized")
        return ServingMesh({"data": 1, "model": 1}, ("data", "model"),
                           device=dev)
    group = dist.group.WORLD if m == world else \
        dist.new_group(list(range(m)))
    # every rank of the world joins both groups, in this order
    ctrl = group if dist.get_backend() == "gloo" else \
        dist.new_group(list(range(m)), backend="gloo")
    if dist.get_rank() >= m:
        raise ValueError(f"rank {dist.get_rank()} is outside the {m}-rank "
                         f"serving mesh")
    got = dist.get_backend(group)
    if backend is not None and got != backend:
        raise ValueError(f"the process group runs {got}, not {backend}")
    rank = dist.get_rank(group)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return ServingMesh({"data": 1, "model": m}, ("data", "model"),
                       rank=rank, group=group, ctrl_group=ctrl,
                       backend=got, device=dev, ranks=tuple(range(m)))


# --------------------------------- spawn ---------------------------------

def _init(rank: int, n: int, backend: str, store_dir: str,
          cuda: bool) -> None:
    import torch.distributed as dist
    if cuda:        # the device make_serving_mesh gives this rank
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(store_dir, "store"), n),
        rank=rank, world_size=n)


def _teardown() -> None:
    """Free the rank's objects, then its process groups, while the
    interpreter is whole. A group lives as long as a Python object holds
    it (a mesh, an engine that holds the mesh), and
    `destroy_process_group` only drops the registry's references: an
    object kept by a reference cycle kept the gloo group, and its
    worker and transport threads, alive into interpreter shutdown.
    Collecting the cycles first makes the registry's references the last
    ones, so the group is destroyed, its threads joined, here: teardown
    is deterministic. That is the suspected cause of a rare SIGABRT of a
    finished rank ("terminate called without an active exception",
    about 1 world in 1000 on the CPU); no abort was seen after this
    change, but in too few worlds to show that the rate fell."""
    import gc
    import torch.distributed as dist
    gc.collect()
    dist.destroy_process_group()
    gc.collect()


def _entry(rank, n, fn, args, backend, store_dir, cuda):
    _init(rank, n, backend, store_dir, cuda)
    try:
        out = fn(rank, *args)
    finally:
        _teardown()
    with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(n: int, fn: Callable, *args, backend: Optional[str] = None,
          device="cuda") -> list:
    """Run fn(rank, *args) on n ranks of one process group and return
    their results in rank order. The group meets through a file store in
    a fresh temp dir; its backend defaults to NCCL on the card and gloo on
    the CPU. n == 1 runs fn in this process; n > 1 starts n processes
    (`spawn` start method, so fn and its arguments must pickle, and
    fn must be importable). A rank that raises ends the run: the other
    ranks are killed and the error is raised here."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"spawn needs at least one rank, got {n}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    store_dir = tempfile.mkdtemp(prefix="repro_mesh_")
    try:
        if n == 1:
            _init(0, 1, backend, store_dir, dev.type == "cuda")
            try:
                return [fn(0, *args)]
            finally:
                _teardown()
        import torch.multiprocessing as mp
        mp.start_processes(_entry, args=(n, fn, args, backend, store_dir,
                                         dev.type == "cuda"),
                           nprocs=n, start_method="spawn", join=True)
        out = []
        for r in range(n):
            with open(os.path.join(store_dir, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
