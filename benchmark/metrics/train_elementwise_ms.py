"""Device ms per training step in PyTorch's own elementwise, copy and
reduction kernels and in copies and sets, in the profiled slice. A kernel
counts by its group (its name without templates and arguments): a group
under ``at::native::`` naming one of `PARTS`, or a copy or set."""

from benchmark.lib.trace import group_of

PARTS = ("elementwise_kernel", "reduce_kernel", "CatArrayBatchedCopy",
         "copy_kernel", "index_kernel")


def matches(name: str) -> bool:
    if name.startswith(("Memcpy", "Memset")):
        return True
    g = group_of(name)
    return g.startswith("at::native::") and any(p in g for p in PARTS)


def read(run):
    p = run.profile
    if p is None or not p.ops:
        return None
    return p.device_seconds(matches) / p.units * 1e3
