"""Times the attention kernels of one checkout at chip_smoke.py's cases.

    python3 neuspeech1_tpu_torch/perf/flash_trees.py CHECKOUT TAG [WHICH]

imports ``neuspeech1_tpu_torch`` from the checkout CHECKOUT (so it builds
that tree's ``csrc/`` sources) and prints one JSON line per kernel and
case. WHICH is ``flash`` (the forward K1 at ``KERNEL_CASES``, K4's forward
at ``BIAS_CASES`` and the backward K2 at the cases with a backward),
``decode`` (the decode cross-attention K6 at ``DECODE_CROSS_CASES``, beside
SDPA on the same inputs, the decode step K7 at ``DECODE_STEP_CASES`` and
the multi-query decode step K8 at ``DECODE_STEP_MULTI_CASES``), ``lora``
(the LoRA adapter backward K3 at ``LORA_CASES``; its device time counts
every kernel of the call), ``probes`` (the probes' attention forward P-fwd
at ``PROBE_FWD_CASES``, beside SDPA with the key mask, the attention
backward P-bwd at ``PROBE_BWD_CASES``, beside SDPA's backward in bf16 and
f32, with each variant's share of outputs bit-equal to the plain f32
version, and the batched dot P-dot at each K of ``PROBE_DOT_KS``, beside
``torch.bmm``, all at the probes' full shape through the checkout's
``perf`` make_* functions, so each tree maps block_q and n_sub to its own
schedule) or ``all`` (the
default: every group but ``probes``). Each line gives the
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
# (name, rows, Tmax, idx): chip_smoke.py's DECODE_STEP_CASES
DECODE_STEP_CASES = (("beam_early", 80, 132, 3),
                     ("beam_last", 80, 132, 131),
                     ("greedy_last", 8, 36, 35),
                     ("bench_early", 64, 52, 4),
                     ("bench_last", 64, 52, 51))
# (name, N, din, dout, r): chip_smoke.py's LORA_CASES
LORA_CASES = (("fc1", 96000, 512, 2048, 32),
              ("fc2", 96000, 2048, 512, 32),
              ("ragged_r12", 10007, 512, 2048, 12))
# (name, rows, G, Tmax, idx, mask): chip_smoke.py's DECODE_STEP_MULTI_CASES
DECODE_STEP_MULTI_CASES = (("verify_early", 16, 4, 516, 8, "holes"),
                           ("verify_late", 16, 4, 516, 508, "holes"),
                           ("prefill", 16, 4, 516, 0, "broadcast"))
DECODE_HEADS, DECODE_HEAD_DIM = 8, 64
# (tag, module, make_* and its arguments): P-fwd at the probes' shape,
# B*H = 512 heads of 64 over TK = 1536 keys, 1500 kept
PROBE_FWD_CASES = (("base_bq512", "kernel_probe", "make_kernel", ("base", 512)),
                   ("base_bq256", "kernel_probe", "make_kernel", ("base", 256)),
                   ("noexp_bq512", "kernel_probe", "make_kernel",
                    ("noexp", 512)),
                   ("online_bq512_kb4", "kernel_probe", "make_online",
                    (512, 4)),
                   ("fwd_bq512_sub2", "mxu_probe", "make_fwd", (512, 2)))
# (tag, module, make_* and its arguments, btc): P-bwd at the probes' shape
# from a given lse ~ N(8, 0.1^2), every variant of chip_smoke's sweep
PROBE_BWD_CASES = tuple(
    (f"bwd_bq{bq}_{ops}ops", "bwd_probe", "make_bwd",
     (bq,), {"bf16_ops": ops == "bf16"}, False)
    for bq in (512, 256) for ops in ("bf16", "f32")) + tuple(
    (f"bwd_btc_bq{bq}", "btc_probe", "make_bwd_btc", (bq,), {}, True)
    for bq in (512, 256, 192))
# P-dot: 256 x [512, K] @ [K, 1536]
PROBE_DOT_KS = (64, 128, 256, 512)
PROBE_BH, PROBE_TK, PROBE_T = 512, 1536, 1500
PROBE_DOT_M, PROBE_DOT_GRID = 512, 256
ACCEPTED_SHARE = 0.7
CACHE_COPIES = 4


def main(checkout: str, tag: str, which: str = "all") -> None:
    sys.path.insert(0, checkout)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuspeech1_tpu_torch.perf.common import cuda_ms

    def emit(kernel, case, fn, prefix, host=False):
        """One line: CUDA-event ms, device ms of the kernels whose names
        hold ``prefix`` (every kernel for None), the host's us per call
        (``host``: True for the least of 20 runs of 100 calls, or (calls,
        runs))."""
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
        if host:
            calls, runs = (100, 20) if host is True else host
            best = float("inf")
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
            line["host_us"] = 1e6 * best / calls
        print(json.dumps(line), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    if which in ("flash", "all"):
        _flash(gen, emit)
    if which in ("decode", "all"):
        _decode(gen, emit)
    if which in ("lora", "all"):
        _lora(gen, emit)
    if which == "probes":
        _probes(gen, emit, tag)


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
    for name, rows, t_max, idx in DECODE_STEP_CASES:
        q, kn, vn = (torch.randn((rows, 1, h * d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     .view(rows, 1, h, d) for _ in range(3))
        caches = itertools.cycle(
            [tuple(torch.randn((rows, h, d, t_max), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(2)) for _ in range(CACHE_COPIES)])
        emit("K7", name, lambda q=q, kn=kn, vn=vn, idx=idx:
             ds.decode_step(q, kn, vn, *next(caches), idx), None, host=True)
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


def _lora(gen, emit) -> None:
    """K3 at chip_smoke.py's cases: every kernel of the wrapper's call."""
    import torch

    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    for name, n, din, dout, r in LORA_CASES:
        x, dy = (torch.randn((n, w), generator=gen, device="cuda")
                 .to(torch.bfloat16) for w in (din, dout))
        a, bm = ((0.1 * torch.randn(s, generator=gen, device="cuda"))
                 .to(torch.bfloat16) for s in ((din, r), (r, dout)))
        emit("K3", name, lambda x=x, dy=dy, a=a, bm=bm:
             lb.lora_adapter_bwd(x, dy, a, bm), None, host=True)


def _probes(gen, emit, tree) -> None:
    """P-fwd beside SDPA with the key mask, P-dot beside torch.bmm; the
    device time of P-fwd and P-dot counts their own kernels."""
    import importlib

    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                .to(torch.bfloat16))

    q, k, v = (rnd(PROBE_BH, PROBE_TK, 64) for _ in range(3))
    for tag, module, make, args in PROBE_FWD_CASES:
        mod = importlib.import_module(f"neuspeech1_tpu_torch.perf.{module}")
        run = getattr(mod, make)(*args, t_valid=PROBE_T)
        emit("P-fwd", tag, lambda run=run: run(q, k, v), "probe_fwd")
    mask = (torch.arange(PROBE_TK, device="cuda") < PROBE_T).view(1, 1, 1, -1)
    q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
    emit("SDPA", "base", lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), None)
    del q, k, v, q4, k4, v4
    _probes_bwd(gen, emit, tree)
    from neuspeech1_tpu_torch.perf import mxu_probe

    for kdim in PROBE_DOT_KS:
        a, b = rnd(PROBE_DOT_GRID, PROBE_DOT_M, kdim), rnd(
            PROBE_DOT_GRID, kdim, PROBE_TK)
        run = mxu_probe.make_dot(kdim, PROBE_DOT_GRID)
        emit("P-dot", f"dot_k{kdim}", lambda run=run, a=a, b=b: run(a, b),
             "probe_dot")
        emit("bmm", f"dot_k{kdim}", lambda a=a, b=b: torch.bmm(a, b), None)
        del a, b
        torch.cuda.empty_cache()


def _probes_bwd(gen, emit, tree) -> None:
    """P-bwd at every variant (device time: every kernel of the call; host
    time: the least of 5 runs of 20 calls) beside SDPA's backward with the
    key mask on the same inputs, in bf16 and on f32 copies; then each
    variant's share of outputs bit-equal to the plain f32 version on these
    inputs and on the card test's (tests/test_torch_cuda_kernels.py::
    _probe_bwd_inputs: four heads over 1536 keys, seeds 9 and 19)."""
    import importlib

    import torch
    import torch.nn.functional as F

    from neuspeech1_tpu_torch.ops.probe_bwd import probe_bwd_plain

    def arrays(g, shape, lse_shape):
        """q, k, v, o, do bf16 N(0, 1) and lse ~ N(8, 0.1^2) from ``g``."""
        xs = [torch.randn(shape, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(5)]
        return xs + [8.0 + 0.1 * torch.randn(lse_shape, generator=g,
                                             device="cuda")]

    b = PROBE_BH // 8
    full = {False: arrays(gen, (PROBE_BH, PROBE_TK, 64),
                          (PROBE_BH, PROBE_TK)),
            True: arrays(gen, (b, PROBE_TK, 8 * 64), (b, 8, PROBE_TK))}
    test = {}
    for btc in (False, True):
        xs = arrays(torch.Generator(device="cuda").manual_seed(9),
                    (1, 1536, 4 * 64) if btc else (4, 1536, 64), (1,))[:5]
        g19 = torch.Generator(device="cuda").manual_seed(19)
        lse = 8.0 + 0.1 * torch.randn((4, 1536), generator=g19, device="cuda")
        test[btc] = xs + [lse.view(1, 4, 1536) if btc else lse]

    runs = {}
    for tag, module, make, args, kw, btc in PROBE_BWD_CASES:
        mod = importlib.import_module(f"neuspeech1_tpu_torch.perf.{module}")
        run = getattr(mod, make)(*args, t_valid=PROBE_T, **kw)
        runs[tag] = (run, btc)
        emit("P-bwd", tag, lambda run=run, a=full[btc]: run(*a), None,
             host=(20, 5))
    q, k, v, _, do, _ = full[False]
    mask = (torch.arange(PROBE_TK, device="cuda") < PROBE_T).view(1, 1, 1, -1)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        xs = [x.unsqueeze(1).to(dtype).detach().requires_grad_()
              for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*xs, attn_mask=mask)
        g = do.unsqueeze(1).to(dtype)
        emit("SDPA_bwd", name, lambda o=o, xs=xs, g=g: torch.autograd.grad(
            o, xs, g, retain_graph=True), None)
        del xs, o, g
        torch.cuda.empty_cache()

    def share(got, ref):
        same = sum(int((a == r).sum()) for a, r in zip(got, ref))
        return same / sum(r.numel() for r in ref)

    for where, inputs, t_valid in (("full", full, PROBE_T),
                                   ("card_test", test, 1500)):
        for btc in (False, True):
            gold = probe_bwd_plain(*inputs[btc], t_valid, "f32", btc)
            for tag, (run, b_) in runs.items():
                if b_ == btc:
                    print(json.dumps({"tree": tree, "kernel": "P-bwd",
                                      "case": tag,
                                      "inputs": where,
                                      "f32_gold_share": share(
                                          run(*inputs[btc]), gold)}),
                          flush=True)
            del gold
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(*sys.argv[1:4])
