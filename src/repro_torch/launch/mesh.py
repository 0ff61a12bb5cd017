"""Mesh construction (counterpart of ``repro.launch.mesh``): the model
meshes (``make_host_mesh``, data x model over every rank;
``make_production_mesh``, the assigned 16 x 16 pod and 2 x 16 x 16
multi-pod) and the 1-D lane mesh of the sharded quadrature driver
(``make_lane_mesh``; DESIGN.md Sec. 7).

The reference builds its mesh over the devices one process sees. Here
every rank is a process, started by the caller (``torchrun``, or
``torch.multiprocessing`` with a store of the caller's choosing), and the
mesh spans the default process group::

    init_lane_group("nccl", rank, world, init_method="tcp://host:port")
    mesh = make_lane_mesh()                    # every rank of the group
    res = solver.solve_batch_sharded(op, us, mesh=mesh, ...)

On a card per rank the group is NCCL. Ranks that share a card run a gloo
group, which the caller names: nothing switches the backend silently.
Every mesh is a function, not a module constant: importing this module
touches no process group.
"""
from __future__ import annotations

import datetime
import os

import torch


def _local_rank(rank: int) -> int:
    """The rank's index on its node: ``LOCAL_RANK`` as ``torchrun`` sets
    it, else the global rank (one node)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def _check_cards(backend: str, world: int) -> None:
    """NCCL needs a card of its own for each rank on the node
    (``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else the world)."""
    if backend != "nccl":
        return
    ranks = min(world, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise ValueError(
            f"NCCL cannot run {ranks} ranks on {cards} card(s): it "
            f"refuses two ranks on one card. Start one rank a card, or "
            f"create a gloo group for ranks that share a card")


def init_lane_group(backend: str, rank: int, world_size: int, *,
                    init_method: str | None = None, store=None,
                    timeout_s: float = 60.0) -> None:
    """``torch.distributed.init_process_group`` for a lane mesh, with a
    timeout, so that a rank that fails mid-loop fails the run instead of
    hanging it. Pass ``init_method`` (``tcp://...``, ``file://...``) or a
    ``store`` (a ``FileStore`` keeps test workers apart). NCCL with more
    ranks on the node than cards raises here, before the group exists."""
    import torch.distributed as dist

    _check_cards(backend, world_size)
    if backend == "nccl":
        # the rank's card is current before NCCL meets it
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, store=store, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _group_world(what: str) -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialised default process group: call "
            f"launch.init_lane_group (or torch.distributed."
            f"init_process_group with a timeout) on every rank first")
    return dist.get_world_size()


def _model_mesh(shape: tuple, names: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' but CUDA is not "
                               "available; pass device_type='cpu'")
        world = dist.get_world_size()
        _check_cards(dist.get_backend(), world)
        torch.cuda.set_device(_local_rank(dist.get_rank())
                              % torch.cuda.device_count())
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The assigned production mesh: (16, 16) named ("data", "model"), or
    (2, 16, 16) named ("pod", "data", "model"), over every rank of the
    default group, which must hold exactly 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = _group_world("make_production_mesh")
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the group has world size {world}")
    return _model_mesh(shape, names, device_type)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """Every rank of the default group as (world // model, model) named
    ("data", "model"), on ``device_type`` (the caller's: 'cuda', or 'cpu'
    for gloo ranks on the host)."""
    world = _group_world("make_host_mesh")
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the world size "
                         f"{world}")
    return _model_mesh((world // model, model), ("data", "model"),
                       device_type)


def data_axes_for(mesh) -> tuple:
    """The mesh's data-parallel axes: those of ("pod", "data") it has."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def make_lane_mesh(num_devices: int | None = None, *, axis: str = "lanes",
                   device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the
    initialised default group (``num_devices``, when given, must equal
    its size). With ``device_type='cuda'`` rank r computes on
    ``cuda:(local_rank % device_count)``, which becomes its current
    device. Raises if no group is initialised, and for an NCCL group with
    more ranks on the node than cards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_lane_mesh needs an initialised default process group: "
            "call launch.init_lane_group (or torch.distributed."
            "init_process_group with a timeout) on every rank first")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"the lane mesh spans the whole group: "
                         f"num_devices={n}, but the group has {world} "
                         f"ranks")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' but CUDA is not "
                               "available; pass device_type='cpu'")
        _check_cards(dist.get_backend(), world)
        torch.cuda.set_device(_local_rank(dist.get_rank())
                              % torch.cuda.device_count())
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def lane_device(mesh) -> torch.device:
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def lane_rank(mesh, axis: str = "lanes") -> tuple:
    """``(ranks on the lane axis, this rank's index on it)`` of a lane
    mesh; raises ``TypeError`` for anything but a ``DeviceMesh`` with
    that axis."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.make_lane_mesh), got "
                        f"{type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: "
                         f"{names})")
    dim = names.index(axis)
    return mesh.shape[dim], mesh.get_local_rank(dim)
