#!/usr/bin/env python3
"""Smoke run of the PyTorch port (neuspeech1_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper GPU,
nvcc and PyTorch built for CUDA; no network and no JAX are needed. Phases,
each printing JSON lines:

1. build    compiles every CUDA kernel library from csrc/, one nvcc per
            source, all at once.
2. kernels  holds each kernel against its plain PyTorch version on the card
            at the serving and training paths' shapes (plus the other masks,
            head dims and the [B, H, T, D] layout), and times both with CUDA
            events: K1 (flash forward), K2 (flash backward), K3 (LoRA
            adapter backward).
3. slice    serves 16 synthetic [208, 6000] signals in two batches of 8
            through ``neuspeech1_tpu_torch.serve.Transcriber`` with
            whisper-base weights made from a seed, counts the kernel's
            launches in that run, holds the encoder states against the plain
            attention path, and checks the token ids.
4. train    runs the LoRA training step (whisper-base, batch 64, r=32, the
            'fc' fold) from seeded weights: kernel launches per step, the
            schedule's first steps, finite loss, ms per step and samples/s,
            and one step's gradients at batch 4 against the plain versions
            and against an f32 reference, at two states of the adapters.

Then it prints the kernel summary, the card's name and power limit as
``nvidia-smi`` gives them, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no ``ok`` line. Without CUDA it fails at once.

    python3 chip_smoke.py --profile-train [TRACE_DIR]

builds the kernels and prints where the training step's time goes
(CUDA events per phase, device busy share under torch.profiler) instead,
writing the profiler's trace into TRACE_DIR when one is given.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel against plain version, bf16 inputs drawn from N(0, 1). |o| < 1 and o
# is rounded to bf16 (spacing at most 2^-8 there), and p is rounded against a
# running row max in the kernel but against the final one in the plain
# version: the bound is two to three ulps of o. lse stays f32 in both, so its
# bound is f32 summation noise over 1500 terms with a wide margin. (Both are
# tighter than the 2e-2 / 1e-3 first set for this kernel: it measured
# 2e-3 / 5e-6 on an H100.)
O_TOL = 1e-2
LSE_TOL = 1e-4
# Encoder states after ln_post (|x| up to ~5) in bf16, kernel against the
# plain attention path. Any difference in an attention output flips later
# bf16 roundings, and six layers compound them: the max is bounded by a few
# ulps at |x| ~ 4 (spacing 2^-5), the mean by one ulp at |x| in [1, 2).
ENC_MAX_TOL = 0.25
ENC_MEAN_TOL = 2.0 ** -7

# K2 against its plain version, both from the same o, lse and do, errors
# over the plain gradient's max-abs. Both round p and ds to bf16 at the same
# points and the gradients once, so they differ where f32 sums taken in
# another order flip a bf16 rounding: a few ulps of the largest gradient
# (2^-8 relative each), so 2e-2.
K2_REL_TOL = 2e-2
# K3: f32 outputs; t1 and u are rounded to bf16 in both, and an f32 sum in
# another order can flip one rounding (2^-8 of that term) among the N terms
# of a sum, which moves the sum far less than 2^-8 of its largest entry.
K3_REL_TOL = 5e-3

KERNEL_CASES = (
    # the serving path: encoder self-attention at whisper-base width
    dict(name="encoder", b=8, t=1500, h=8, d=64, bwd=True),
    dict(name="encoder_kv_len", b=8, t=1500, h=8, d=64, kv_len=1400,
         bwd=True),
    dict(name="causal", b=8, t=448, h=8, d=64, causal=True, bwd=True),
    # the training path at batch 64: encoder self and decoder cross
    dict(name="train_encoder", b=64, t=1500, h=8, d=64, bwd=True),
    dict(name="train_cross", b=64, t=64, t_kv=1500, h=8, d=64, bwd=True),
    dict(name="d32", b=2, t=300, h=4, d=32, bwd=True),
    dict(name="d128_causal", b=2, t=300, h=4, d=128, causal=True, bwd=True),
)
# (name, N, din, dout, r): the fc1 and fc2 adapters of the training step at
# batch 64 (N = 64 x 1500 tokens, not a multiple of the TPU block), and a
# ragged N at AdaLoRA's initial rank
LORA_CASES = (
    ("fc1", 96000, 512, 2048, 32),
    ("fc2", 96000, 2048, 512, 32),
    ("ragged_r12", 10007, 512, 2048, 12),
)
# The training step: bench.py's batch and label length.
TRAIN_BATCH = 64
TRAIN_LABEL_LEN = 64
TRAIN_WARMUP = 2
TRAIN_STEPS = 6
GRAD_CHECK_BATCH = 4
# One step's gradients with the kernels against the plain versions, per
# trainable leaf, |g_kernel - g_plain| / |g_plain| over the whole leaf. The
# two paths differ only where a sum taken in another order flips a bf16
# rounding (2^-8 relative) of an attention output or gradient; twelve
# attention blocks and twelve adapters pass such flips on, so a few percent.
GRAD_REL_TOL = 5e-2
# Both bf16 paths against an f32 reference (plain attention and plain
# adapter backward computing in f32, on the same weights): the kernels may
# add their own summation-order noise, of bf16's size and independent of
# it, to the bf16 rounding both paths share (a factor sqrt(2) on the worst
# leaf); 2 leaves a margin over that.
WITNESS_FACTOR = 2.0
# The LoRA B std of the second gradient check (a trained magnitude, as in
# the JAX package's fold tests)
TRAINED_B_STD = 0.02
# The loss (about ln 51865 = 10.9 at these random weights) from bf16 logits.
LOSS_TOL = 1e-3
PROFILE_STEPS = 5
PROFILE_TRACED_STEPS = 3
SLICE_SIGNALS = 16
SLICE_BATCH = 8
SLICE_NEW_TOKENS = 32
SLICE_REPEATS = 5
SAMPLE_RATE = 200  # Hz: a 30 s clip is the stem's 6000 samples


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_build() -> list:
    """Builds every kernel library of the paths below: one nvcc per source,
    all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from neuspeech1_tpu_torch.ops import _build
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    loaders = {"flash_fwd_btc": fa._library, "flash_bwd_btc": fa._bwd_library,
               "lora_bwd": lb._library}

    def timed(name):
        t0 = time.perf_counter()
        loaders[name]()
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(loaders)) as pool:
        seconds = dict(pool.map(timed, loaders))
    out = []
    for name in loaders:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        res = {"phase": "build", "kernel": name, "seconds": seconds[name],
               "ptxas": ptxas}
        emit(res)
        out.append(res)
    return out


def _bthd(gen, b, t, h, d):
    """[B, T, H*D] bf16 drawn from N(0, 1) as the projections produce it,
    viewed as BTHD."""
    return (torch.randn((b, t, h * d), generator=gen, device="cuda")
            .to(torch.bfloat16).view(b, t, h, d))


def _rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def phase_kernels() -> list:
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for case in KERNEL_CASES:
        b, t, h, d = case["b"], case["t"], case["h"], case["d"]
        t_kv = case.get("t_kv", t)
        causal, kv_len = case.get("causal", False), case.get("kv_len")
        q = _bthd(gen, b, t, h, d)
        k, v = _bthd(gen, b, t_kv, h, d), _bthd(gen, b, t_kv, h, d)
        o_k, lse_k = fa.flash_attention_bthd(q, k, v, causal, kv_len,
                                             return_lse=True)
        o_p, lse_p = fa.flash_attention_bthd_plain(q, k, v, causal, kv_len,
                                                   return_lse=True)
        torch.cuda.synchronize()
        o_err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err = (lse_k - lse_p).abs().max().item()
        res = {
            "phase": "kernels", "kernel": "K1", "case": case["name"],
            "shape": [b, t, t_kv, h, d], "causal": causal, "kv_len": kv_len,
            "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
            "o_tol": O_TOL, "lse_tol": LSE_TOL,
            "ms": cuda_ms(lambda: fa.flash_attention_bthd(q, k, v, causal,
                                                          kv_len)),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_bthd_plain(
                q, k, v, causal, kv_len)),
        }
        emit(res)
        check(bool(torch.isfinite(o_k.float()).all()), f"{case}: non-finite o")
        check(o_err <= O_TOL and lse_err <= LSE_TOL,
              f"K1 {case['name']}: kernel disagrees with plain version")
        results.append(res)
        if case.get("bwd"):
            results.append(_check_flash_bwd(case, q, k, v, o_k, lse_k, gen))
    results.append(_check_bhtd_layout(gen))
    results.extend(_check_lora_bwd(gen))
    return results


def _check_flash_bwd(case, q, k, v, o, lse, gen) -> dict:
    """K2 against its plain version on the forward kernel's o and lse."""
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    causal, kv_len = case.get("causal", False), case.get("kv_len")
    kvl = kv_len or k.shape[1]
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, o, do, lse, causal, kvl)
    grads = fa._flash_bwd_cuda(*args)
    plain = fa.flash_attention_bthd_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {f"{n}_rel_err": _rel_err(g, p)
            for n, g, p in zip(("dq", "dk", "dv"), grads, plain)}
    abs_err = max((g.float() - p.float()).abs().max().item()
                  for g, p in zip(grads, plain))
    res = {"phase": "kernels", "kernel": "K2", "case": case["name"],
           "max_abs_err": abs_err,
           "shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     q.shape[3]],
           "causal": causal, "kv_len": kv_len, **errs, "rel_tol": K2_REL_TOL,
           "ms": cuda_ms(lambda: fa._flash_bwd_cuda(*args)),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_bthd_bwd_plain(
               *args))}
    if kv_len is not None:
        res["rows_past_kv_len_zero"] = bool(
            (grads[1][:, kv_len:] == 0).all() and (grads[2][:, kv_len:] == 0)
            .all())
        check(res["rows_past_kv_len_zero"],
              f"K2 {case['name']}: dk/dv rows past kv_len are not 0")
    emit(res)
    check(all(torch.isfinite(g.float()).all() for g in grads),
          f"K2 {case['name']}: non-finite gradients")
    check(max(errs.values()) <= K2_REL_TOL,
          f"K2 {case['name']}: kernel disagrees with plain version")
    return res


def _check_bhtd_layout(gen) -> dict:
    """K1 and K2 through the [B, H, T, D] entry (the JAX package's K5
    kernels), forward and autograd backward, against the plain versions."""
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    b, h, t, d = 8, 8, 1500, 64
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn((b, h, t, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    # this entry is not on the training or serving path: its launches are
    # counted over its own forward and backward, from 0
    _reset_counts()
    o = fa.flash_attention(q, k, v)
    o.backward(do)
    launches = {"K1": fa.launches, "K2": fa.bwd_launches}
    check(launches == {"K1": 1, "K2": 1},
          f"the [B, H, T, D] entry launched {launches}, expected K1 and K2 "
          "once each")
    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    o_p, lse_p = fa.flash_attention_bthd_plain(qt, kt, vt, return_lse=True)
    plain = fa.flash_attention_bthd_bwd_plain(
        qt, kt, vt, o_p, do.transpose(1, 2), lse_p)
    torch.cuda.synchronize()
    o_err = (o.detach().float() - o_p.transpose(1, 2).float()).abs().max()
    errs = {f"{n}_rel_err": _rel_err(x.grad, p.transpose(1, 2))
            for n, x, p in zip(("dq", "dk", "dv"), (q, k, v), plain)}
    bwd_args = (qt, kt, vt, o_p, do.transpose(1, 2), lse_p, False, t)
    res = {"phase": "kernels", "kernel": "K5", "case": "bhtd_fwd_bwd",
           "shape": [b, h, t, d], "launches": launches,
           "o_max_abs_err": o_err.item(), **errs,
           "grad_max_abs_err": max(
               (x.grad.float() - p.transpose(1, 2).float()).abs().max().item()
               for x, p in zip((q, k, v), plain)),
           "o_tol": O_TOL, "rel_tol": K2_REL_TOL,
           "ms": cuda_ms(lambda: fa.flash_attention(q.detach(), k.detach(),
                                                    v.detach())),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_bthd_plain(
               qt, kt, vt)),
           "bwd_ms": cuda_ms(lambda: fa._flash_bwd_cuda(*bwd_args)),
           "bwd_plain_ms": cuda_ms(
               lambda: fa.flash_attention_bthd_bwd_plain(*bwd_args))}
    emit(res)
    check(o_err.item() <= O_TOL and max(errs.values()) <= K2_REL_TOL,
          "K5 [B, H, T, D]: kernels disagree with plain versions")
    return res


def _check_lora_bwd(gen) -> list:
    """K3 against its plain version at the fc1 / fc2 shapes of the training
    step (N = 64 x 1500 tokens) and at a ragged N with rank 12."""
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    out = []
    for name, n, din, dout, r in LORA_CASES:
        x, dy = (torch.randn((n, w), generator=gen, device="cuda")
                 .to(torch.bfloat16) for w in (din, dout))
        a, bm = (0.1 * torch.randn(s, generator=gen, device="cuda")
                 for s in ((din, r), (r, dout)))
        a, bm = a.to(torch.bfloat16), bm.to(torch.bfloat16)
        got = lb.lora_adapter_bwd(x, dy, a, bm)
        ref = lb.lora_adapter_bwd_plain(x, dy, a, bm)
        torch.cuda.synchronize()
        errs = {f"{k}_rel_err": _rel_err(g, p)
                for k, g, p in zip(("dA", "dB", "dE"), got, ref)}
        res = {"phase": "kernels", "kernel": "K3", "case": name,
               "max_abs_err": max((g - p).abs().max().item()
                                  for g, p in zip(got, ref)),
               "shape": [n, din, dout, r], **errs, "rel_tol": K3_REL_TOL,
               "ms": cuda_ms(lambda: lb.lora_adapter_bwd(x, dy, a, bm)),
               "plain_ms": cuda_ms(lambda: lb.lora_adapter_bwd_plain(
                   x, dy, a, bm))}
        emit(res)
        check(all(torch.isfinite(g).all() for g in got),
              f"K3 {name}: non-finite gradients")
        check(max(errs.values()) <= K3_REL_TOL,
              f"K3 {name}: kernel disagrees with plain version")
        out.append(res)
    return out


def _signals(n_channels: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """Synthetic clips of 2-10 s (a sinusoid per clip plus noise), then
    zeros: [SLICE_SIGNALS, n_channels, n_samples], 30 s at 200 Hz."""
    rng = np.random.default_rng(seed)
    out = np.zeros((SLICE_SIGNALS, n_channels, n_samples), np.float32)
    for i in range(SLICE_SIGNALS):
        n = int(rng.integers(2 * SAMPLE_RATE, 10 * SAMPLE_RATE + 1))
        t = np.arange(n) / SAMPLE_RATE
        sig = 0.5 * np.sin(2 * np.pi * (3.0 + i) * t)[None, :]
        out[i, :, :n] = sig + 0.05 * rng.standard_normal((n_channels, n))
    return out


def phase_slice() -> dict:
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import generate
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.serve import Transcriber

    # whisper-base (bf16 compute) with the 'base' EEG stem over 208 channels.
    # Its token layout is layout_for_vocab(50257, 99), so a 50257-word
    # vocabulary is its tokenizer (the byte tokenizer needs eot_id 256).
    config, stem = common.preset_model("base", "base", in_channels=208)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model_dir = common.save_full_model(
            os.path.join(tmp, "full_model"), init_params(config, stem, seed=0),
            config, stem)
        vocab = os.path.join(tmp, "vocab.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(f"w{i}" for i in range(config.eot_id)) + "\n")
        # the stem strides by 2 twice: 4 samples per encoder position
        signals = _signals(stem.in_channels, 4 * config.max_source_positions)
        tr = Transcriber(model_dir, tokenizer=f"word:{vocab}",
                         batch_size=SLICE_BATCH,
                         max_new_tokens=SLICE_NEW_TOKENS, device="cuda")
        setup_s = time.perf_counter() - t0

    tr.transcribe(signals[:SLICE_BATCH])  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    fa.launches = 0
    t0 = time.perf_counter()
    texts = tr.transcribe(signals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    n_batches = -(-SLICE_SIGNALS // SLICE_BATCH)
    check(launches == config.encoder_layers * n_batches,
          f"flash kernel launched {launches} times, expected "
          f"{config.encoder_layers * n_batches}")
    check(len(texts) == SLICE_SIGNALS, f"{len(texts)} texts for "
          f"{SLICE_SIGNALS} signals")

    # one pass of 16 signals lasts a few tenths of a second: repeat both
    # readings and report every one beside the median
    lat, rates = [], [SLICE_SIGNALS / wall]
    for _ in range(SLICE_REPEATS):
        t0 = time.perf_counter()
        tr.transcribe(signals[:SLICE_BATCH])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tr.transcribe(signals)
        torch.cuda.synchronize()
        rates.append(SLICE_SIGNALS / (time.perf_counter() - t0))

    feats = common.upload_features(tr._prepare(signals[:SLICE_BATCH]),
                                   tr.model.dtype, tr.device)
    with torch.no_grad():
        enc_k = tw.encoder_apply(tr.model, feats)
        kernel_fn = tw.flash_attention_bthd
        tw.flash_attention_bthd = fa.flash_attention_bthd_plain
        try:
            enc_p = tw.encoder_apply(tr.model, feats)
        finally:
            tw.flash_attention_bthd = kernel_fn
        prompt = torch.as_tensor(np.repeat(tr.prompt, SLICE_BATCH, axis=0),
                                 device=tr.device)
        tokens = generate(tr.model, feats, prompt, tr.gen)
    torch.cuda.synchronize()
    diff = (enc_k.float() - enc_p.float()).abs()
    enc_max, enc_mean = diff.max().item(), diff.mean().item()
    check(bool(torch.isfinite(enc_k.float()).all()), "non-finite encoder states")
    check(tuple(enc_k.shape) == (SLICE_BATCH, config.max_source_positions,
                                 config.d_model),
          f"encoder states shape {tuple(enc_k.shape)}")
    check(enc_max <= ENC_MAX_TOL and enc_mean <= ENC_MEAN_TOL,
          f"encoder states: kernel path off the plain path by max {enc_max}, "
          f"mean {enc_mean}")
    check(tuple(tokens.shape) == (SLICE_BATCH, tr.gen.max_length),
          f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < config.vocab_size)).all()),
          "token id outside the vocabulary")
    check("jax" not in sys.modules, "jax was imported")
    out = {
        "phase": "slice", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "signals": SLICE_SIGNALS,
        "batch_size": SLICE_BATCH, "max_new_tokens": SLICE_NEW_TOKENS,
        "flash_launches": launches, "setup_s": setup_s, "wall_s": wall,
        "utterances_per_s": statistics.median(rates),
        "utterances_per_s_all": rates,
        "request_latency_s": statistics.median(lat),
        "request_latency_all_s": lat,
        "encoder_max_abs_err": enc_max, "encoder_mean_abs_err": enc_mean,
        "encoder_tol": [ENC_MAX_TOL, ENC_MEAN_TOL],
        "jax_imported": "jax" in sys.modules,
        "sample_text": texts[0][:80], "card": card(),
    }
    emit(out)
    return out


def _train_setup(batch_size: int, device: str = "cuda"):
    """The bench configuration on the card: whisper-base with the 'base'
    stem over 208 channels, f32 masters computing in bf16, LoRA r=32 alpha=64
    on encoder q/k/v/out/fc1/fc2 from seeds, AdamW with warmup, and a
    synthetic batch from a seeded numpy generator (bench.py's recipe)."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    config, stem = common.preset_model("base", "base", in_channels=208)
    model = module_from_params(init_params(config, stem, seed=0), config, stem,
                               device=device, dtype=torch.float32)
    lora = init_lora(config, rank=32, alpha=64, seed=1, device=device)
    tx = optimizer.make_optimizer(peak_lr=1e-3, warmup_steps=500,
                                  total_steps=100_000)
    state, frozen = trainstep.init_train_state(model, lora, tx)
    step = trainstep.make_train_step(config, stem, tx, fold_lora=True)
    rng = np.random.default_rng(0)
    n_samples = 4 * config.max_source_positions
    batch = {
        "input_features": torch.from_numpy(rng.standard_normal(
            (batch_size, stem.in_channels, n_samples)).astype(np.float32))
        .to(device, torch.bfloat16),
        "labels": torch.from_numpy(rng.integers(
            0, 50000, (batch_size, TRAIN_LABEL_LEN))).to(device),
        "decoder_input_ids": torch.from_numpy(rng.integers(
            0, 50000, (batch_size, TRAIN_LABEL_LEN))).to(device),
    }
    return config, tx, state, frozen, step, batch


def _kernel_counts():
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    return {"K1": fa.launches, "K2": fa.bwd_launches, "K3": lb.launches}


def _reset_counts():
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    fa.launches = fa.bwd_launches = lb.launches = 0


def _adapter_b_max(frozen) -> float:
    from neuspeech1_tpu_torch.models.lora import entries

    return max(e["B"].abs().max().item() for _, e in entries(frozen.lora))


@contextlib.contextmanager
def _plain_kernels():
    """Every CUDA kernel wrapper of the training path replaced by its plain
    version while the context is open (a swap for comparison only)."""
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    swaps = [
        (fa, "_flash_fwd_cuda",
         lambda q, k, v, causal, kv_len: fa.flash_attention_bthd_plain(
             q, k, v, causal, kv_len, return_lse=True)),
        (fa, "_flash_bwd_cuda", fa.flash_attention_bthd_bwd_plain),
        (lb, "_lora_bwd_cuda", lb.lora_adapter_bwd_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _f32_compute(model):
    """The model computing in f32 with plain attention while the context is
    open (its masters are f32 already): the reference of the gradient
    checks. Run it under `_plain_kernels`, since K3 takes bf16 only."""
    import dataclasses

    config = model.config
    model.config = dataclasses.replace(config, dtype="float32",
                                       flash_attention="off")
    try:
        yield
    finally:
        model.config = config


def _grads(loss_fn, state, frozen, batch):
    """loss and the trainable leaves' gradients of one forward/backward."""
    for t in state.trainable.values():
        t.grad = None
    loss, _ = loss_fn(frozen, batch)
    loss.backward()
    out = {k: t.grad.detach().clone() for k, t in state.trainable.items()
           if t.grad is not None}
    for t in state.trainable.values():
        t.grad = None
    return loss.item(), out


def _leaf_errs(got, ref) -> dict:
    """|got - ref| / |ref| per leaf: the worst leaf, its value, the median
    and the five worst."""
    rel = {k: ((got[k].float() - ref[k].float()).norm()
               / ref[k].float().norm().clamp_min(1e-30)).item() for k in ref}
    ranked = sorted(rel.items(), key=lambda kv: kv[1], reverse=True)
    return {"max": ranked[0][1], "leaf": ranked[0][0],
            "median": statistics.median(rel.values()), "top5": ranked[:5],
            "stem": max(v for k, v in rel.items() if k.startswith("model/"))}


def _grad_check(name, loss_fn, state, frozen, batch, expect) -> dict:
    """One step's gradients on the kernels, on the plain versions and on
    the f32 reference, at the adapters' present state. Checks the kernels
    against the plain versions (GRAD_REL_TOL, LOSS_TOL), and that the
    kernels lie no further from the f32 reference than WITNESS_FACTOR
    times the plain versions do (worst leaf)."""
    _reset_counts()
    loss_k, g_k = _grads(loss_fn, state, frozen, batch)
    check(_kernel_counts() == expect, f"gradient check {name} missed a kernel")
    _reset_counts()
    with _plain_kernels():
        loss_p, g_p = _grads(loss_fn, state, frozen, batch)
        with _f32_compute(frozen.model):
            loss_32, g_32 = _grads(loss_fn, state, frozen, batch)
    check(_kernel_counts() == {"K1": 0, "K2": 0, "K3": 0},
          "a kernel ran while the plain versions were swapped in")
    check(set(g_k) == set(g_p) == set(g_32),
          "kernel, plain and f32 paths reach other leaves")
    out = {"state": name, "b_max": _adapter_b_max(frozen),
           "loss": {"kernels": loss_k, "plain": loss_p, "f32": loss_32},
           "kernels_vs_plain": _leaf_errs(g_k, g_p),
           "kernels_vs_f32": _leaf_errs(g_k, g_32),
           "plain_vs_f32": _leaf_errs(g_p, g_32)}
    emit({"phase": "train_grad_check", **out, "grad_rel_tol": GRAD_REL_TOL,
          "witness_factor": WITNESS_FACTOR})
    kp, k32 = out["kernels_vs_plain"], out["kernels_vs_f32"]
    check(kp["max"] <= GRAD_REL_TOL,
          f"{name}: grads with the kernels off the plain path: {kp['leaf']} "
          f"{kp['max']}")
    check(k32["max"] <= WITNESS_FACTOR * out["plain_vs_f32"]["max"],
          f"{name}: the kernels' grads lie further from the f32 reference "
          f"({k32['max']}) than {WITNESS_FACTOR} x the plain path's")
    check(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
          f"{name}: loss with the kernels {loss_k}, plain {loss_p}")
    return out


def phase_train() -> dict:
    """The LoRA training step at full width: counts each kernel's launches
    per step, checks the optimizer's first steps and the loss, times the
    step, and holds one step's gradients against the plain versions."""
    from neuspeech1_tpu_torch.train.trainstep import make_loss_fn

    config, _, state, frozen, step, batch = _train_setup(TRAIN_BATCH)
    stem = frozen.model.stem_config
    n_layers = config.encoder_layers
    expect = {"K1": 2 * n_layers, "K2": 2 * n_layers, "K3": 2 * n_layers}

    def run_step():
        _reset_counts()
        t0 = time.perf_counter()
        m = step(state, frozen, batch)
        loss = float(m["loss"])  # a device -> host copy: the step has run
        seconds = time.perf_counter() - t0
        counts = _kernel_counts()
        check(counts == expect, f"kernel launches per step {counts}, "
              f"expected {expect}")
        norm = float(m["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(norm) and norm > 0,
              f"step {state.step}: loss {loss}, grad_norm {norm}")
        return loss, norm, seconds, counts

    # the warm-up steps check the schedule: lr = schedule(0) = 0 at step 1
    # leaves every LoRA B at its initial 0; step 2 moves them
    warm, b_after = [], []
    for _ in range(TRAIN_WARMUP):
        warm.append(run_step())
        b_after.append(_adapter_b_max(frozen))
    check(b_after[0] == 0.0, f"LoRA B moved at step 1 (lr 0): {b_after[0]}")
    check(b_after[1] > 0.0, "LoRA B still zero after step 2")
    timed = [run_step() for _ in range(TRAIN_STEPS)]
    ms = [1e3 * t[2] for t in timed]
    med = statistics.median(ms)

    # one step's gradients at a small batch, kernels against the plain
    # versions and both against f32: first at the state the timed steps
    # ran in (LoRA B small, from the warm-up rates), then with every B
    # refilled at a trained magnitude (N(0, TRAINED_B_STD^2), seeded)
    from neuspeech1_tpu_torch.models.lora import entries

    small = {k: v[:GRAD_CHECK_BATCH] for k, v in batch.items()}
    loss_fn = make_loss_fn(config, stem, fold_lora=True)
    checks = [_grad_check("after_timed_steps", loss_fn, state, frozen, small,
                          expect)]
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for _, e in entries(frozen.lora):
            e["B"].copy_(TRAINED_B_STD * torch.randn(e["B"].shape,
                                                     generator=gen))
    checks.append(_grad_check("trained_b", loss_fn, state, frozen, small,
                              expect))
    torch.cuda.synchronize()
    check("jax" not in sys.modules, "jax was imported")
    out = {
        "phase": "train", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "masters": "float32", "lora_rank": 32,
        "lora_alpha": 64, "fold": "fc", "batch_size": TRAIN_BATCH,
        "label_len": TRAIN_LABEL_LEN,
        "launches_per_step": timed[-1][3],
        "warmup_losses": [w[0] for w in warm],
        "b_max_after_step": b_after,
        "losses": [t[0] for t in timed], "grad_norms": [t[1] for t in timed],
        "step_ms": med, "step_ms_all": ms,
        "samples_per_s": TRAIN_BATCH / (med / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "grad_check_batch": GRAD_CHECK_BATCH,
        "grad_rel_err_max": {c["state"]: c["kernels_vs_plain"]["max"]
                             for c in checks},
        "grad_rel_tol": GRAD_REL_TOL,
        "jax_imported": "jax" in sys.modules, "card": card(),
    }
    emit(out)
    return out


def phase_train_profile(trace_dir=None) -> dict:
    """Where the training step's time goes: CUDA events around forward
    (loss), backward and the optimizer over a few steps, then the device's
    busy and idle share under torch.profiler. Prints one JSON line and
    writes the chrome trace into ``trace_dir`` when one is given."""
    from neuspeech1_tpu_torch.train.optimizer import global_norm
    from neuspeech1_tpu_torch.train.trainstep import make_loss_fn

    config, tx, state, frozen, step, batch = _train_setup(TRAIN_BATCH)
    loss_fn = make_loss_fn(config, frozen.model.stem_config, fold_lora=True)
    for _ in range(TRAIN_WARMUP):
        float(step(state, frozen, batch)["loss"])
    phases = {"forward": [], "backward": [], "optimizer": [], "step": []}
    for _ in range(PROFILE_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for t in state.trainable.values():
            t.grad = None
        ev[0].record()
        loss, _ = loss_fn(frozen, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads = {k: t.grad for k, t in state.trainable.items()
                 if t.grad is not None}
        tx.update(state.trainable, grads, state.opt_state,
                  global_norm(grads.values()))
        ev[3].record()
        torch.cuda.synchronize()
        phases["forward"].append(ev[0].elapsed_time(ev[1]))
        phases["backward"].append(ev[1].elapsed_time(ev[2]))
        phases["optimizer"].append(ev[2].elapsed_time(ev[3]))
        phases["step"].append(ev[0].elapsed_time(ev[3]))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TRACED_STEPS):
            float(step(state, frozen, batch)["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "train_step_trace.json"))
    out = {
        "phase": "train_profile", "batch_size": TRAIN_BATCH,
        "events_ms_median": {k: statistics.median(v)
                             for k, v in phases.items()},
        "events_ms_all": phases,
        "profiled_steps": PROFILE_TRACED_STEPS, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3,
                            e.count] for e in top],
        "card": card(),
    }
    emit(out)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[1:2] == ["--profile-train"] and len(argv) <= 3:
        phase_build()
        phase_train_profile(argv[2] if len(argv) == 3 else None)
        return 0
    if argv[1:]:
        print(f"usage: {argv[0]} [--profile-train [TRACE_DIR]]",
              file=sys.stderr)
        return 2
    phase_build()
    kernels = phase_kernels()
    sl = phase_slice()
    tr = phase_train()

    def first(kernel, case):
        return next(r for r in kernels
                    if r["kernel"] == kernel and r["case"] == case)

    k1, k2 = first("K1", "train_encoder"), first("K2", "train_encoder")
    k5, k3 = first("K5", "bhtd_fwd_bwd"), first("K3", "fc1")
    launches = tr["launches_per_step"]
    src = "neuspeech1_tpu_torch/csrc/"
    fa_py = "neuspeech1_tpu/ops/flash_attention.py"
    emit({"kernels": [
        {"name": "flash_fwd_btc (K1)", "route": "cuda",
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":494",
         "launches": launches["K1"], "serving_launches": sl["flash_launches"],
         "max_abs_err": k1["o_max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "flash_bwd_btc (K2)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":599",
         "launches": launches["K2"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
        # K5: the same two kernels on [B, H, T, D] strides. No path of the
        # port calls that entry; its launches are those of its own run in
        # the kernels phase (counted from 0)
        {"name": "flash_fwd_btc on [B,H,T,D] (K5 forward)", "route": "cuda",
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":80",
         "launches": k5["launches"]["K1"], "path": "flash_attention entry",
         "max_abs_err": k5["o_max_abs_err"],
         "ms": k5["ms"], "plain_ms": k5["plain_ms"]},
        {"name": "flash_bwd_btc on [B,H,T,D] (K5 backward)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":194",
         "launches": k5["launches"]["K2"], "path": "flash_attention entry",
         "max_abs_err": k5["grad_max_abs_err"],
         "ms": k5["bwd_ms"], "plain_ms": k5["bwd_plain_ms"]},
        {"name": "lora_bwd (K3)", "route": "cuda",
         "source": src + "lora_bwd.cu",
         "replaces": "neuspeech1_tpu/ops/lora_bwd.py:47",
         "launches": launches["K3"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"]},
    ]})
    print(card(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
