"""K6 (``csrc/decode_cross.cu``) against its roofline, in %: the bytes
each launch needs (`counts.decode_cross_bytes`: the bf16 cross cache's K
and V read once, the beam rows' queries and outputs) over the HBM
bandwidth, over K6's device time, summed over the profiled slice."""

from benchmark.lib import counts


def matches(name: str) -> bool:
    return "decode_cross_kernel" in name


def read(run):
    p = run.profile
    if p is None:
        return None
    device = p.device_seconds(matches)
    if device <= 0:
        return None
    nbytes = p.count(matches) * counts.decode_cross_bytes(
        run.config, run.stats["batch"], run.traffic["num_beams"])
    return 100 * nbytes / counts.PEAK_BYTES_PER_S / device
