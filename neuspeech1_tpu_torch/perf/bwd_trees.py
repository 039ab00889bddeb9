"""Times the flash backward (K2) of one checkout at chip_smoke.py's K2 cases.

    python3 neuspeech1_tpu_torch/perf/bwd_trees.py CHECKOUT TAG

imports ``neuspeech1_tpu_torch`` from the checkout CHECKOUT (so it builds
that tree's ``csrc/flash_bwd_btc.cu``) and prints one JSON line per case:
the mean CUDA-event time of 50 calls after 5 and the device time of the
backward's kernels under torch.profiler (10 calls). To compare two commits
on one card, unpack both and run parent, change, change, parent in one call.
"""

import json
import sys

# (name, B, Tq, Tk, H, D, causal): chip_smoke.py's KERNEL_CASES with bwd
CASES = (("causal", 8, 448, 448, 8, 64, True),
         ("d32", 2, 300, 300, 4, 32, False),
         ("d128_causal", 2, 300, 300, 4, 128, True),
         ("train_cross", 64, 64, 1500, 8, 64, False),
         ("encoder", 8, 1500, 1500, 8, 64, False),
         ("train_encoder", 64, 1500, 1500, 8, 64, False))


def main(checkout: str, tag: str) -> None:
    sys.path.insert(0, checkout)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.perf.common import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, tq, tk, h, d, causal in CASES:
        def bthd(t):
            return (torch.randn((b, t, h * d), generator=gen, device="cuda")
                    .to(torch.bfloat16).view(b, t, h, d))

        q, k, v, do = bthd(tq), bthd(tk), bthd(tk), bthd(tq)
        o, lse = fa.flash_attention_bthd(q, k, v, causal, None, True)

        def fn():
            return fa._flash_bwd_cuda(q, k, v, o, do, lse, causal, tk)

        ms = cuda_ms(fn, iters=50, warmup=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if "flash_bwd" in e.key) / 1e4
        print(json.dumps({"tree": tag, "case": name, "ms": ms,
                          "device_ms": dev}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
