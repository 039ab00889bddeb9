"""The training step's share of the card's dense bf16 peak, in %: three
times the forward FLOPs of a sample at the mix's label length
(`counts.fwd_flops_per_sample`; recompute not counted), times the samples
per second of the window's steps outside the profiled slice."""

from benchmark.lib import counts


def read(run):
    s = run.stats
    if not s.get("steps_outside") or run.device == "cpu":
        return None
    flops = 3 * counts.fwd_flops_per_sample(run.config, s["label_len"])
    rate = s["steps_outside"] * s["batch"] / s["seconds_outside"]
    return 100 * flops * rate / counts.PEAK_BF16_FLOPS
