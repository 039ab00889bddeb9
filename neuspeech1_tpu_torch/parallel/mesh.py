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

``batch_sharding``, ``replicated`` and ``parallel/sharding.py`` (data, FSDP
and tensor parallelism as DTensor specs) are not ported yet (ROADMAP.md
queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping, Optional

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "neuspeech1_tpu_torch_mesh", default=None)


def initialize_distributed(backend: str = "nccl", store=None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> None:
    """Starts the default process group once per process; a no-op when one
    exists. With ``store`` (a ``torch.distributed`` store, e.g. a
    ``FileStore``) the caller gives rank and world size; without, they come
    from the environment (``torchrun``'s ``env://``). Under NCCL the process
    takes card ``rank % device_count``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if store is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(device_type: str = "cuda", **axes: int):
    """A ``DeviceMesh`` over the default process group with one named dim
    per keyword, in order: ``make_mesh(data=1, seq=4)``. The sizes multiply
    to the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not axes:
        raise ValueError("make_mesh needs at least one named axis")
    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


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
