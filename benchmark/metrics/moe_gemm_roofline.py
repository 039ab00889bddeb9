"""The routed experts' grouped GEMMs against their roofline, in %: the
least time of a step's routed-expert products, forward and input gradient
(`moe_counts.routed_least_seconds`: each product's larger of FLOPs over
the bf16 peak and bytes over the HBM bandwidth, rows batch x positions x
experts per token in every routed layer), over the device time a step of
the kernels named ``moe_grouped_gemm*`` in the profiled slice. Remat's
recompute is device time and not work, so the number reads the same work
whatever runs it."""

from benchmark.lib import moe_counts


def matches(name: str) -> bool:
    return "moe_grouped_gemm" in name


def read(run):
    p = run.profile
    if p is None:
        return None
    device = p.device_seconds(matches)
    if device <= 0:
        return None
    least = moe_counts.routed_least_seconds(
        run.config, run.stats["batch"], run.stats["label_len"]) * p.units
    return 100 * least / device
