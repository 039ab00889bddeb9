"""Times the flash kernels of one checkout at chip_smoke.py's cases.

    python3 neuspeech1_tpu_torch/perf/flash_trees.py CHECKOUT TAG

imports ``neuspeech1_tpu_torch`` from the checkout CHECKOUT (so it builds
that tree's ``csrc/flash_fwd_btc.cu`` and ``csrc/flash_bwd_btc.cu``) and
prints one JSON line per kernel and case: the forward K1 at
``KERNEL_CASES``, K4's forward at ``BIAS_CASES`` and the backward K2 at the
cases with a backward, each by the mean CUDA-event time of 50 calls after 5
and by the device time of its kernels under torch.profiler (10 calls; the
smallest cases are launch-bound, so compare those by the device time). To
compare two commits on one card, unpack both and run parent, change,
change, parent in one call.
"""

import json
import sys

# (name, B, Tq, Tk, H, D, causal, kv_len, bwd): chip_smoke.py's KERNEL_CASES
CASES = (("encoder", 8, 1500, 1500, 8, 64, False, None, True),
         ("encoder_kv_len", 8, 1500, 1500, 8, 64, False, 1400, False),
         ("causal", 8, 448, 448, 8, 64, True, None, True),
         ("d32", 2, 300, 300, 4, 32, False, None, True),
         ("d128_causal", 2, 300, 300, 4, 128, True, None, True),
         ("train_cross", 64, 64, 1500, 8, 64, False, None, True),
         ("train_encoder", 64, 1500, 1500, 8, 64, False, None, True))
# (name, B, T, H, D, masked columns): chip_smoke.py's BIAS_CASES
BIAS_CASES = (("sp_step_n1", 64, 1536, 8, 64, 36),
              ("ring_n4_masked_block", 8, 384, 8, 64, 384),
              ("ring_n4_partial_block", 8, 384, 8, 64, 152))


def main(checkout: str, tag: str) -> None:
    sys.path.insert(0, checkout)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.perf.common import cuda_ms

    def emit(kernel, case, fn, prefix):
        ms = cuda_ms(fn, iters=50, warmup=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if prefix in e.key) / 1e4
        print(json.dumps({"tree": tag, "kernel": kernel, "case": case,
                          "ms": ms, "device_ms": dev}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, tq, tk, h, d, causal, kv_len, bwd in CASES:
        def bthd(t):
            return (torch.randn((b, t, h * d), generator=gen, device="cuda")
                    .to(torch.bfloat16).view(b, t, h, d))

        q, k, v, do = bthd(tq), bthd(tk), bthd(tk), bthd(tq)
        kvl = kv_len or tk
        emit("K1", name,
             lambda: fa._flash_fwd_cuda(q, k, v, causal, kvl), "flash_fwd")
        if bwd:
            o, lse = fa.flash_attention_bthd(q, k, v, causal, kv_len, True)
            emit("K2", name,
                 lambda: fa._flash_bwd_cuda(q, k, v, o, do, lse, causal, kvl),
                 "flash_bwd")
    for name, b, t, h, d, masked in BIAS_CASES:
        q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda")
                   .to(torch.bfloat16).view(b, t, h, d) for _ in range(3))
        bias = torch.zeros(t, device="cuda")
        bias[t - masked:] = fa.NEG_INF
        emit("K4", name, lambda: fa._flash_bias_fwd_cuda(q, k, v, bias),
             "flash_fwd")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
