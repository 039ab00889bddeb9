"""Device ms per training step in the grouped-GEMM kernels of the routed
experts (``csrc/moe_grouped_gemm.cu``, named ``moe_grouped_gemm*``), in
the profiled slice: forward, input gradient and remat's recompute."""


def matches(name: str) -> bool:
    return "moe_grouped_gemm" in name


def read(run):
    p = run.profile
    if p is None:
        return None
    device = p.device_seconds(matches)
    if device <= 0:
        return None
    return device / p.units * 1e3
