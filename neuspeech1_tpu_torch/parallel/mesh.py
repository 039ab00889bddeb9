"""Device mesh and the ambient mesh of the PyTorch port: the port of
``neuspeech1_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` with named axes and runs
under ``jax.sharding.set_mesh``; a config's ``seq_parallel_axis`` names an
axis of that ambient mesh. Here ``make_mesh`` builds a ``torch.distributed``
``DeviceMesh`` with named dims over the process group that
``initialize_distributed`` starts (NCCL on the card by default), and
``set_mesh`` makes a mesh ambient for the current thread: a ``DeviceMesh``,
or a mapping ``{axis: Ring}`` (``LocalRing`` ranks are threads, so the
ambient mesh is a ``contextvars`` variable, one per thread).

``AXES`` are the JAX mesh's axis names. ``batch_sharding`` says which rows
of a global batch this rank holds (the JAX ``P(("data", "fsdp"))`` layout:
rank r of those axes, major first, takes the r-th contiguous block) and
``replicated`` that it holds all of them (``batch_coordinate``: the
block's index and count; the ranks of one ``tensor`` group share rows).
``data_ring``, ``fsdp_ring`` and ``tensor_ring`` give an axis's ``Ring``
where it has more than one rank; ``parallel/sharding.py`` splits weights
over ``fsdp`` and ``tensor``. ``initialize_distributed`` starts the process
group from torchrun's environment or from a store.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Mapping, Optional

import torch

AXES = ("data", "fsdp", "tensor")
# the axes a global batch's rows are split over, major first
BATCH_AXES = ("data", "fsdp")

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "neuspeech1_tpu_torch_mesh", default=None)


def initialize_distributed(backend: str = "nccl", store=None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> bool:
    """Starts the default process group once per process and returns
    whether one is up. The rendezvous: ``store`` (a ``torch.distributed``
    store such as a ``FileStore``) with ``rank`` and ``world_size``, else
    torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``; ``env://``), where the fine-tune CLI also puts its
    ``--coordinator`` "host:port". Without either it is a no-op, as the JAX
    package's is without a coordinator. Under NCCL the process takes card
    ``LOCAL_RANK`` (torchrun's), else ``rank % device_count``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        return False
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return True


def make_mesh(device_type: str = "cuda", **axes: int):
    """A ``DeviceMesh`` over the default process group with one named dim
    per keyword, in order: ``make_mesh(data=1, seq=4)``. The sizes multiply
    to the world size; one of them may be -1, all the ranks the others
    leave (the JAX ``make_mesh``'s ``data=-1``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not axes:
        raise ValueError("make_mesh needs at least one named axis")
    axes = resolve_axes(dist.get_world_size(), **axes)
    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def resolve_axes(world_size: int, **axes: int) -> dict:
    """``axes`` with a -1 replaced by what the others leave of
    ``world_size``; raises where the sizes do not multiply to it."""
    fixed = math.prod(n for n in axes.values() if n != -1)
    free = [a for a, n in axes.items() if n == -1]
    if len(free) > 1:
        raise ValueError(f"at most one mesh axis may be -1: {axes}")
    if free:
        if world_size % fixed:
            raise ValueError(f"{world_size} ranks not divisible by {fixed}")
        axes = {**axes, free[0]: world_size // fixed}
    if math.prod(axes.values()) != world_size:
        raise ValueError(f"mesh {axes} needs {math.prod(axes.values())} "
                         f"ranks; the world has {world_size}")
    return axes


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which rows of a global batch this rank holds: the ``index``-th of
    ``count`` contiguous blocks, split over the mesh ``axes`` (empty:
    replicated, the whole batch)."""

    axes: tuple
    index: int
    count: int

    def shard(self, x):
        """This rank's block of ``x``'s leading dim, which ``count``
        divides."""
        if self.count == 1:
            return x
        if x.shape[0] % self.count:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"{self.count} ranks of {self.axes}")
        rows = x.shape[0] // self.count
        return x[self.index * rows:(self.index + 1) * rows]


def batch_sharding(mesh=None) -> Sharding:
    """The batch dim split over the mesh's ``data`` and ``fsdp`` axes, in
    that order (axes the mesh lacks are skipped): the JAX ``NamedSharding``
    of ``P(("data", "fsdp"))``, whose rank r takes the r-th contiguous
    block of rows."""
    mesh = get_mesh() if mesh is None else mesh
    axes = tuple(a for a in BATCH_AXES
                 if mesh is not None and a in axis_names(mesh))
    index, count = 0, 1
    for a in axes:
        n = axis_size(a, mesh)
        index = index * n + axis_rank(a, mesh)
        count *= n
    return Sharding(axes, index, count)


def replicated(mesh=None) -> Sharding:
    """Every rank holds the whole batch."""
    del mesh
    return Sharding((), 0, 1)


def local_mesh_info(mesh) -> dict:
    """Device count, axis sizes, and this process's rank and count."""
    import torch.distributed as dist

    axes = {name: axis_size(name, mesh) for name in axis_names(mesh)}
    info = {"devices": 1, "axes": axes}
    for n in axes.values():
        info["devices"] *= n
    info["process_index"] = dist.get_rank() if dist.is_initialized() else 0
    info["process_count"] = (dist.get_world_size() if dist.is_initialized()
                             else 1)
    return info


@contextlib.contextmanager
def set_mesh(mesh):
    """Makes ``mesh`` (a ``DeviceMesh`` or a ``{axis: Ring}`` mapping) the
    ambient mesh of this thread while the context is open."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh():
    """This thread's ambient mesh, or None."""
    return _MESH.get()


def axis_names(mesh) -> tuple:
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names or ())


def axis_size(axis: str, mesh=None) -> int:
    """The size of ``axis`` of ``mesh`` (default: the ambient mesh)."""
    mesh = _mesh_with(axis, mesh)
    if isinstance(mesh, Mapping):
        return mesh[axis].size
    return mesh.size(axis_names(mesh).index(axis))


def axis_rank(axis: str, mesh=None) -> int:
    """This rank's coordinate along ``axis`` of ``mesh`` (default: the
    ambient mesh)."""
    mesh = _mesh_with(axis, mesh)
    if isinstance(mesh, Mapping):
        return mesh[axis].rank
    return mesh.get_local_rank(axis)


def _ring_along(axis: str, mesh=None):
    """The ring along ``axis`` of ``mesh`` (default: the ambient mesh), or
    None where there is no mesh, no such axis, or one of size 1."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None or axis not in axis_names(mesh) or \
            axis_size(axis, mesh) == 1:
        return None
    return axis_ring(axis, mesh)


def data_ring(mesh=None):
    """The ring along the ``data`` axis (`_ring_along`)."""
    return _ring_along("data", mesh)


def fsdp_ring(mesh=None):
    """The ring along the ``fsdp`` axis (`_ring_along`)."""
    return _ring_along("fsdp", mesh)


def tensor_ring(mesh=None):
    """The ring along the ``tensor`` axis (`_ring_along`)."""
    return _ring_along("tensor", mesh)


def batch_rings(mesh=None) -> list:
    """The rings of the axes a global batch's rows are split over
    (``data``, then ``fsdp``), those of size 1 left out: a sum over the
    ranks holding different rows runs over each in turn."""
    return [r for r in (data_ring(mesh), fsdp_ring(mesh)) if r is not None]


def batch_coordinate(mesh=None) -> tuple:
    """(index, count): this rank's block of a global batch's rows among
    the blocks split over ``data`` x ``fsdp`` (`batch_sharding`). The
    ranks of one tensor group share it."""
    s = batch_sharding(mesh)
    return s.index, s.count


def is_first(mesh=None) -> bool:
    """Whether this rank is rank 0 along every axis of ``mesh`` (default:
    the ambient mesh; True without one): the rank that writes."""
    mesh = get_mesh() if mesh is None else mesh
    return mesh is None or all(axis_rank(a, mesh) == 0
                               for a in axis_names(mesh))


def barrier(mesh=None) -> None:
    """Returns once every rank of ``mesh`` (default: the ambient mesh) has
    called it: a barrier along each axis in turn."""
    mesh = get_mesh() if mesh is None else mesh
    for a in axis_names(mesh) if mesh is not None else ():
        ring = _ring_along(a, mesh)
        if ring is not None:
            ring.barrier()


def axis_ring(axis: str, mesh=None):
    """The ``Ring`` along ``axis`` of ``mesh`` (default: the ambient mesh)
    that this rank belongs to: the mapping's entry, or a ``DistRing`` over
    the ``DeviceMesh`` dim's process group."""
    from neuspeech1_tpu_torch.parallel.ring_attention import DistRing

    mesh = _mesh_with(axis, mesh)
    if isinstance(mesh, Mapping):
        return mesh[axis]
    return DistRing(mesh.get_group(axis))


def _mesh_with(axis: str, mesh):
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError(
            f"mesh axis {axis!r} needs an ambient mesh: run under "
            "neuspeech1_tpu_torch.parallel.mesh.set_mesh(mesh)")
    if axis not in axis_names(mesh):
        raise ValueError(f"the ambient mesh has no axis {axis!r}; its axes "
                         f"are {axis_names(mesh)}")
    return mesh
