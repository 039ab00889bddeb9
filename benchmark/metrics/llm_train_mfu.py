"""The language-model training step's share of the card's dense bf16
peak, in %: a sample's model FLOPs (`moe_counts.train_flops_per_sample`:
twice the frozen language model's forward, for its forward and input
gradient, plus three times the tower's and the projector's; recompute
not counted) times the samples per second of the window's steps outside
the profiled slice."""

from benchmark.lib import counts, moe_counts


def read(run):
    s = run.stats
    if not s.get("steps_outside") or run.device == "cpu":
        return None
    flops = moe_counts.train_flops_per_sample(run.config, s["label_len"])
    rate = s["steps_outside"] * s["batch"] / s["seconds_outside"]
    return 100 * flops * rate / counts.PEAK_BF16_FLOPS
