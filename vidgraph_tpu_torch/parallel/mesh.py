"""Device meshes over ``torch.distributed``: the port's multi-device substrate.

Counterpart of ``vidgraph_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one process sees every device and XLA inserts the
collectives.  PyTorch is SPMD: one process per device (a *rank*), every
rank runs the same program and issues the same collectives in the same
order.  A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` of
shape ``(data, model)`` over the ranks of the default process group, with
the JAX axis names; the vision tower and captioner split their heads and
MLP hidden over "model", batches and the embedding memory's rows over
"data".

The process group comes from ``init_group``: NCCL for a CUDA device, gloo
for the CPU, or gloo on a CUDA device when the caller asks for it (the
collectives then stage CUDA tensors through the host,
``parallel/comm.py``).  Nothing switches backend on a failure.

Placements are tuples of ``Replicate()`` / ``Shard(d)``, one per mesh
dimension: ``placements(mesh, None, MODEL_AXIS)`` is the port's
``P(None, "model")``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import os
from datetime import timedelta
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: seconds a collective may wait before the group fails it
DEFAULT_TIMEOUT_S = 600.0

_TIMEOUT_S = DEFAULT_TIMEOUT_S
_MESHES: Dict[tuple, DeviceMesh] = {}
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("vidgraph_mesh",
                                                         default=None)


def _factor(n: int, model_axis: int) -> Tuple[int, int]:
    """Pick (data, model) sizes for n devices."""
    if model_axis <= 0:
        model_axis = 1
    model = math.gcd(n, model_axis) if n % model_axis else model_axis
    if n % model != 0:
        model = 1
    return n // model, model


def init_group(backend: Optional[str] = None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Initialise the default process group unless one is, and return its
    backend.  ``backend`` defaults to ``nccl`` when the port computes on a
    CUDA device and ``gloo`` on the CPU; ``gloo`` on a CUDA device only
    when asked for.  Rank and world size come from the arguments, else
    from ``RANK``/``WORLD_SIZE`` (``torchrun``), else a world of one
    whose rendezvous is an in-process store (no port, no file)."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and have != backend:
            raise RuntimeError(f"a {have} process group is initialised; "
                               f"{backend} was asked for")
        return have
    from ..core.platform import device

    dev = device()
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, the port's is {dev}")
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    rendezvous = {"init_method": init_method}
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            rendezvous = {"init_method": "env://"}
        elif world_size == 1:
            rendezvous = {"store": dist.HashStore()}
        else:
            raise ValueError(f"a world of {world_size} ranks needs a "
                             "rendezvous: init_method or MASTER_ADDR")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    global _TIMEOUT_S
    _TIMEOUT_S = timeout_s
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s),
                            **rendezvous, **kw)
    return backend


def group_timeout_s() -> float:
    """Seconds a collective of the default group may wait (``init_group``'s
    ``timeout_s``)."""
    return _TIMEOUT_S


def shutdown() -> None:
    """Destroy the default process group and forget the meshes built on
    it (the end of a run, or of a test that built a world of one)."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks of the default group; before it is initialised, the world a
    launcher announced (``WORLD_SIZE``, ``torchrun``), else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank() -> int:
    """This process's rank (``RANK`` before the group is initialised)."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def _device_type() -> str:
    from ..core.platform import device

    return device().type


def build_mesh(ranks: Optional[Sequence[int]] = None, model_axis: int = 1,
               axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)
               ) -> DeviceMesh:
    """A 2-D (data, model) mesh over ``ranks`` (default: every rank of the
    default group, which ``init_group`` starts when none is).  Every rank
    of the world calls this, members or not: the sub-groups are made
    collectively.  Meshes are cached by their layout."""
    init_group()
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    data, model = _factor(len(ranks), model_axis)
    return mesh_of(torch.tensor(ranks).reshape(data, model), axis_names)


def mesh_of(layout: torch.Tensor, axis_names: Tuple[str, ...]) -> DeviceMesh:
    """The cached ``DeviceMesh`` of ranks ``layout`` (any shape) with
    ``axis_names``; every rank of the world calls it."""
    init_group()
    key = (tuple(layout.shape), tuple(layout.flatten().tolist()),
           tuple(axis_names), _device_type())
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = DeviceMesh(_device_type(), layout, mesh_dim_names=axis_names)
        _MESHES[key] = mesh
    return mesh


def single_device_mesh() -> DeviceMesh:
    """A (1, 1) mesh over this rank alone (every rank gets its own)."""
    init_group()
    world = dist.get_world_size()
    if world == 1:
        return build_mesh(model_axis=1)
    key = ("single", dist.get_rank(), _device_type())
    mesh = _MESHES.get(key)
    if mesh is None:
        own, _ = dist.new_subgroups(group_size=1)
        mesh = DeviceMesh.from_group([own, own], _device_type(),
                                     mesh=[[dist.get_rank()]],
                                     mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        _MESHES[key] = mesh
    return mesh


def host_cpu_mesh(n_devices: int = 8) -> DeviceMesh:
    """A gloo mesh over the first ``n_devices`` ranks, ``model_axis =
    min(2, n)``: what tests and the multichip dry-run use on the CPU."""
    init_group("gloo")
    if n_devices > dist.get_world_size():
        raise ValueError(f"{n_devices} ranks asked for, the world has "
                         f"{dist.get_world_size()}")
    return build_mesh(range(n_devices), model_axis=min(2, n_devices))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 for an axis it does not have)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for an absent axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group along ``axis``, or None where the axis is absent
    or of size one (nothing to communicate)."""
    if axis_size(mesh, axis) < 2:
        return None
    return mesh.get_group(axis)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of ``mesh``'s."""
    return mesh.get_coordinate() is not None


# -- placements (the port's PartitionSpecs) ----------------------------------
def placements(mesh, *dims: Optional[str]) -> tuple:
    """``P(*dims)`` as DTensor placements over ``mesh``'s dimensions:
    tensor dimension i is ``Shard(i)`` on the mesh axis ``dims[i]`` names
    and every other mesh dimension is ``Replicate()``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for tdim, axis in enumerate(dims):
        if axis is not None:
            out[names.index(axis)] = Shard(tdim)
    return tuple(out)


def replicated(mesh) -> tuple:
    return placements(mesh)


def data_sharded(mesh, ndim: int = 2) -> tuple:
    """Shard the leading (batch / row) dimension along the data axis."""
    return placements(mesh, DATA_AXIS, *[None] * (ndim - 1))


def model_sharded_cols(mesh) -> tuple:
    """[in, out] weight with the output dim split along the model axis."""
    return placements(mesh, None, MODEL_AXIS)


def model_sharded_rows(mesh) -> tuple:
    """[in, out] weight with the input dim split along the model axis."""
    return placements(mesh, MODEL_AXIS, None)


# -- the active mesh (JAX's ``with mesh:``) ----------------------------------
@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """Make ``mesh`` the one tensor-parallel code reads its groups from
    (``active_mesh``) inside the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE.get()


def active_group(axis: str, what: str):
    """The active mesh's group along ``axis`` (None at size one), for
    ``what`` (weights cut over that axis); raises outside ``use_mesh``."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"{what} cut over {axis!r} outside a mesh: call "
                           "inside parallel.mesh.use_mesh or "
                           "parallel.serving.maybe_mesh")
    return axis_group(mesh, axis)
