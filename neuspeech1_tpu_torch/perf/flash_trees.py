"""Times the attention kernels of one checkout at chip_smoke.py's cases.

    python3 neuspeech1_tpu_torch/perf/flash_trees.py CHECKOUT TAG [WHICH]

imports ``neuspeech1_tpu_torch`` from the checkout CHECKOUT (so it builds
that tree's ``csrc/`` sources) and prints one JSON line per kernel and
case. WHICH is ``flash`` (the forward K1 at ``KERNEL_CASES``, K4's forward
at ``BIAS_CASES`` and the backward K2 at the cases with a backward),
``decode`` (the decode cross-attention K6 at ``DECODE_CROSS_CASES``, beside
SDPA on the same inputs, and the multi-query decode step K8 at
``DECODE_STEP_MULTI_CASES``) or ``all`` (the default). Each line gives the
mean CUDA-event time of 50 calls after 5 and the device time of the
kernels under torch.profiler (10 calls; the small cases are launch-bound,
so compare those by the device time); the decode lines also give the
wrapper's host time per call (the least of 20 runs of 100 calls queued
without a synchronize),
and cycle through CACHE_COPIES caches, more than the L2 holds. To compare
two commits on one card, unpack both and run parent, change, change,
parent in one call.
"""

import json
import sys
import time

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
# (name, B, Tq, T, kv_len, layout): chip_smoke.py's DECODE_CROSS_CASES
DECODE_CROSS_CASES = (("greedy", 8, 1, 1500, None, "bhtd"),
                      ("beam_step", 16, 5, 1500, None, "bhtd"),
                      ("beam_prefill", 16, 20, 1500, None, "bhtd"),
                      ("bench_step", 64, 1, 1500, None, "bhtd"),
                      ("bench_prefill", 64, 4, 1500, None, "bhtd"),
                      ("btc", 8, 1, 1504, 1500, "btc"))
# (name, rows, G, Tmax, idx, mask): chip_smoke.py's DECODE_STEP_MULTI_CASES
DECODE_STEP_MULTI_CASES = (("verify_early", 16, 4, 516, 8, "holes"),
                           ("verify_late", 16, 4, 516, 508, "holes"),
                           ("prefill", 16, 4, 516, 0, "broadcast"))
DECODE_HEADS, DECODE_HEAD_DIM = 8, 64
ACCEPTED_SHARE = 0.7
CACHE_COPIES = 4


def main(checkout: str, tag: str, which: str = "all") -> None:
    sys.path.insert(0, checkout)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuspeech1_tpu_torch.perf.common import cuda_ms

    def emit(kernel, case, fn, prefix, host=False):
        """One line: CUDA-event ms, device ms of the kernels whose names
        hold ``prefix`` (every kernel for None), the host's us per call."""
        ms = cuda_ms(fn, iters=50, warmup=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and (prefix is None or prefix in e.key)) / 1e4
        line = {"tree": tag, "kernel": kernel, "case": case, "ms": ms,
                "device_ms": dev}
        if host:  # the least of 20 runs of 100 calls
            best = float("inf")
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
            line["host_us"] = 1e6 * best / 100
        print(json.dumps(line), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    if which in ("flash", "all"):
        _flash(gen, emit)
    if which in ("decode", "all"):
        _decode(gen, emit)


def _flash(gen, emit) -> None:
    """K1, K2 and K4's forward at chip_smoke.py's cases."""
    import torch

    from neuspeech1_tpu_torch.ops import flash_attention as fa

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


def _decode(gen, emit) -> None:
    """K6 (beside SDPA) and K8 at chip_smoke.py's cases, each call on the
    next of CACHE_COPIES caches."""
    import itertools

    import torch
    import torch.nn.functional as F

    from neuspeech1_tpu_torch.decode.spec import verify_mask
    from neuspeech1_tpu_torch.ops import decode_cross as dc
    from neuspeech1_tpu_torch.ops import decode_step as ds

    h, d = DECODE_HEADS, DECODE_HEAD_DIM
    for name, b, t_q, t, kv_len, layout in DECODE_CROSS_CASES:
        kvl = kv_len or t
        q = (torch.randn((b, t_q, h * d), generator=gen, device="cuda")
             .to(torch.bfloat16).view(b, t_q, h, d))
        shape = (b, t, h * d) if layout == "btc" else (b, h, t, d)
        caches = itertools.cycle(
            [tuple(torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(2))
             for _ in range(CACHE_COPIES)])

        def bhtd(kv, layout=layout, b=b, t=t):
            if layout == "btc":
                return tuple(x.view(b, t, h, d).transpose(1, 2) for x in kv)
            return kv

        def kernel(q=q, layout=layout, kv_len=kv_len):
            kv = next(caches)
            if layout == "btc":
                return dc.decode_cross_btc(q, *kv, kv_len)
            return dc.decode_cross(q, *kv, kv_len)

        qs = q.transpose(1, 2)
        emit("K6", name, kernel, "decode_cross", host=True)
        emit("SDPA", name, lambda qs=qs, bhtd=bhtd, kvl=kvl:
             F.scaled_dot_product_attention(
                 qs, *(x[:, :, :kvl] for x in bhtd(next(caches)))), None)
    for name, rows, g, t_max, idx, kind in DECODE_STEP_MULTI_CASES:
        q, kn, vn = (torch.randn((rows, g, h * d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     .view(rows, g, h, d) for _ in range(3))
        caches = itertools.cycle(
            [tuple(torch.randn((rows, h, d, t_max), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(2)) for _ in range(CACHE_COPIES)])
        if kind == "broadcast":
            valid = torch.zeros((1, t_max), dtype=torch.bool, device="cuda")
        else:
            valid = torch.rand((rows, t_max), generator=gen,
                               device="cuda") < ACCEPTED_SHARE
        valid[:, :4] = True
        valid[:, idx:] = False
        mask = verify_mask(valid, idx, g)
        emit("K8", name, lambda q=q, kn=kn, vn=vn, mask=mask, idx=idx:
             ds.decode_step_multi(q, kn, vn, mask, *next(caches), idx),
             "decode_step_multi", host=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
