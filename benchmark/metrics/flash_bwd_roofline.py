"""K2 (``csrc/flash_bwd_btc.cu``: its delta, dk/dv and dq kernels) against
its roofline, in %: the least time of a step's flash attention backward
(`counts.train_step_attention_bwd`: every encoder self-attention and
decoder cross-attention, the larger of operations over the bf16 peak and
bytes over the HBM bandwidth) over K2's device time a step in the
profiled slice."""

from benchmark.lib import counts

KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
           "flash_bwd_dq_kernel")


def matches(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(run):
    p = run.profile
    if p is None:
        return None
    device = p.device_seconds(matches)
    if device <= 0:
        return None
    least = counts.train_step_attention_bwd(
        run.config, run.stats["batch"], run.stats["label_len"]) * p.units
    return 100 * least / device
