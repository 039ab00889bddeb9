"""The beam request's share of the card's dense bf16 peak, in %: the
request's model FLOPs (`counts.decode_request_flops`) over its seconds,
taken over the window's requests outside the profiled slice."""

from benchmark.lib import counts


def read(run):
    s = run.stats
    if not s.get("requests_outside") or run.device == "cpu":
        return None
    t = run.traffic
    flops = counts.decode_request_flops(run.config, s["batch"],
                                        t["num_beams"], s["prompt_len"],
                                        t["new_tokens"])
    rate = s["requests_outside"] / s["seconds_outside"]
    return 100 * flops * rate / counts.PEAK_BF16_FLOPS
