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
            head dims and layouts), and times both with CUDA events, beside
            one PyTorch library call of the same function where there is
            one: K1 (flash forward), K2 (flash backward), K3 (LoRA adapter
            backward), K4 (flash forward and backward with a bias row, ring
            attention's blocks), K6 (decode cross-attention), K7 (decode
            self-attention step), K8 (multi-query decode step of
            speculative decoding). K2 and K4's backward also run twice on
            the same inputs (the same bits) and split their time over
            their three kernels (delta, dk/dv, dq) under torch.profiler.
            K6 and K8 run twice too (the same bits), and add their device
            time under torch.profiler (K6's beside SDPA's) and the
            wrapper's host time per call.
3. slice    serves 16 synthetic [208, 6000] signals in two batches of 8
            greedily through ``neuspeech1_tpu_torch.serve.Transcriber`` with
            whisper-base weights made from a seed, counts the kernels'
            launches in that run against the encoder and decoder calls,
            holds the encoder states against the plain attention path, and
            checks the token ids.
4. beam     the eval CLI's decode (beam 5, repetition penalty 5.0,
            no-repeat-ngram 2, batch 16, 128 new tokens) on the same model:
            latency and utterances/s, launches of K1, K6 and K7 against the
            encoder, cached decoder and width-1 calls, the cached decoder's
            logits over 8 teacher-forced steps against the plain versions,
            and the share of tokens equal to the plain path's and to an
            f32 reference's.
5. spec     self-speculative greedy serving (gamma 4, batch 16, 128 new
            tokens) on the same model, with the self-prefix drafter and with
            a corpus-table drafter built from the greedy outputs of the same
            signals, beside a plain greedy request, and greedy and spec with
            the int8 cross cache: latency, utterances/s, iterations and
            accepted tokens per iteration, host syncs, the device's busy
            share, launches of K1, K6, K7 and K8 against the model calls,
            the cached decoder's logits over forced verify iterations
            against the plain versions, and spec tokens against greedy (in
            f32 with the plain versions they must be equal up to near-ties).
6. train    runs the LoRA training step (whisper-base, batch 64, r=32, the
            'fc' fold) from seeded weights: kernel launches per step, the
            schedule's first steps, finite loss, ms per step and samples/s,
            and one step's gradients at batch 4 against the plain versions
            and against an f32 reference, at two states of the adapters.
7. ring     sequence-parallel (ring) attention: a LocalRing of 4 threads on
            the card at whisper-base widths (B=8, T=1536) through K4's
            forward and backward bodies, against K1/K2 on the whole
            sequence at kv_valid_len 1500 and 1000; then the training step
            with ``seq_parallel_axis`` over a one-rank NCCL group from
            ``parallel/mesh.py`` (whisper-base, batch 64): K4 launches per
            step, ms per step and samples/s beside the train phase's, and
            one step's loss and gradients against the non-SP kernel step.
8. lora     greedy serving (batch 8, 32 new tokens) through ``generate(...,
            lora=)`` with unmerged rank-32 adapters on encoder and decoder
            (self-attention q/k/v/out, cross-attention q/out, fc1/fc2):
            K1/K6/K7 launches against the model calls and the request
            without adapters, the cached decoder's logits over 8 forced
            steps against the plain versions, tokens equal to the plain
            versions' up to near-ties, and that the adapters move the
            logits.
9. eval     the eval CLI (``neuspeech1_tpu_torch.cli.evaluation.main``) in
            process on the same model: a manifest of 48 synthetic 2-10 s
            clips over 208 channels (``data/synthetic.py``), a word
            vocabulary whose first entries are the corpus's words, the
            CLI's defaults (beam 5, rp 5.0, ngram 2, batch 16, 128 new
            tokens) at pipeline depth 2 with per-sentence rows and timing:
            the phase timing, utterances/s over the decode phase and end to
            end, whether the native clip loader ran, the metrics and
            METEOR's stages, and K1/K6/K7 launches against the model calls.
            Checks that the predictions equal ``generate`` on the same
            batches, that depth 1 and the Python clip reader (the native
            one switched off) write the same files, that a
            ``--sequence_bias`` run finishes (its decode phase set against
            the three unbiased runs'), and that ``sequence_bias`` gives the
            same bits on the card as on the CPU at the beam step's shape
            (timed beside the beam step).
10. probes  the perf entry points (``neuspeech1_tpu_torch/perf``): every
            variant of the TPU probes' sweeps (kernel_probe, mxu_probe,
            btc_probe, bwd_probe) held against its plain version at full
            TK and 8 heads, then at the probe's shape (B*H = 512, TK =
            1536, D = 64; the dot at 256 x [512, K] @ [K, 1536]) held
            against it again and timed beside its bound, the plain version
            and a library call (SDPA, its backward, ``torch.bmm``), each a
            line tagged as the JAX probe tags it; launches of probe_fwd,
            probe_bwd and probe_dot over the full-shape sweep.
11. bench   ``neuspeech1_tpu_torch.bench`` once in process: its JSON line
            (samples/s, step ms, mfu, greedy decode tokens/s with adapters).

Then it prints the kernel summary (with each kernel's bound: the least time
the card could take for the same bytes or operations, from NVIDIA's H100 SXM
peaks), the card's name and power limit as ``nvidia-smi`` gives them, and as
its last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no ``ok`` line. Without CUDA it fails at once.

    python3 chip_smoke.py --profile-train [TRACE_DIR]
    python3 chip_smoke.py --profile-train-sp [TRACE_DIR]

builds the kernels and prints where the training step's time goes
(CUDA events per phase, device busy share under torch.profiler) instead,
writing the profiler's trace into TRACE_DIR when one is given; ``-sp``
profiles the ring phase's step (``seq_parallel_axis`` over a one-rank NCCL
group).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
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

from neuspeech1_tpu_torch.perf.common import cuda_ms

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

# K6 against its plain version, bf16 inputs drawn from N(0, 1), the error over
# the plain output's max-abs. At T=1500 o is a near-flat mean of N(0, 1) rows:
# a typical |o| is about 0.04 and the largest a few tenths, so an absolute
# bound set from |o| < 1 would be loose. Both round o to bf16 once, and f32
# sums in another order flip that rounding by one ulp, at most 2^-7 of the
# largest |o|. exp(s - m) is rounded to bf16 against a running max per 32-row
# tile and per 256-row split in the kernel, against the final max in the
# plain version: 2^-8 relative per term, of random sign over 1500 terms, which
# moves o far less than another ulp. Two ulps of the largest |o|: 2^-6. (It
# measured 0.0045-0.0061, one ulp at max |o| 0.16-0.21, on an H100.)
K6_REL_TOL = 2.0 ** -6
# K7: the score is rounded to bf16 in both, from f32 sums taken in another
# order; where that flips a rounding the score moves by one bf16 spacing
# (0.125 at |q.k| in [16, 32), N(0, 1) inputs at Dh=64), 0.016 after the
# scale, so that column's p moves by 1.6% of itself; p * |v| stays below a
# few units. Plus an ulp of the bf16 context (|ctx| < 1). The caches after
# the in-place write must be equal exactly.
K7_TOL = 2e-2
# The cached decoder's logits over 8 teacher-forced steps, K6 and K7 against
# their plain versions on the same encoder states and tokens: the attention
# outputs differ by the ulps above, each later bf16 rounding in six layers
# and the caches of the steps before pass the flips on, and the logits are
# bf16 (2^-8 relative). A few percent of the largest logit.
LOGITS_REL_TOL = 5e-2
# K8: as K7, per query: a score whose bf16 rounding flips between the f32
# sums of the kernel and the plain version moves that column's p by 1.6% of
# itself, plus an ulp of the bf16 context (|ctx| < 1). The caches after the
# in-place writes must be equal exactly.
K8_TOL = 2e-2
# Spec against greedy in f32 with the plain versions: the verify step runs
# the decoder at width gamma where greedy runs it at width 1, so the
# products sum in another order, as two f32 implementations of the same
# function do. A first difference is a near-tie when greedy's top-2 logit
# gap lies within the repo's f32 bound for such pairs (tests/
# test_model_parity.py: rtol 1e-4 of the logit, atol 2e-4).
F32_TIE_RTOL, F32_TIE_ATOL = 1e-4, 2e-4

# NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit): HBM3 rate
# and bf16 tensor-core rate. The bound of a call is the larger of its bytes
# over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# f32 outside the tensor cores (data sheet): the f32-operand probe backward
F32_FLOPS = 67e12

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
# (name, B, Tq, T, kv_len, layout): K6 at the serving paths' shapes,
# whisper-base (H=8, D=64, T=1500): the greedy step at batch 8, the beam
# step (16 utterances x 5 beams folded into the query) and the beam
# prefill (5 beams x 4 prompt tokens), the bench's greedy decode at batch
# 64 (its step and its 4-token prefill), and the [B, T, H*D] entry with rows
# padded to a multiple of 8 past kv_len
DECODE_CROSS_CASES = (
    ("greedy", 8, 1, 1500, None, "bhtd"),
    ("beam_step", 16, 5, 1500, None, "bhtd"),
    ("beam_prefill", 16, 20, 1500, None, "bhtd"),
    ("bench_step", 64, 1, 1500, None, "bhtd"),
    ("bench_prefill", 64, 4, 1500, None, "bhtd"),
    ("btc", 8, 1, 1504, 1500, "btc"),
)
# (name, rows, Tmax, idx): K7 at the beam step (16 x 5 rows, 4 prompt + 128
# new tokens) early and at its last column, at the greedy step (8 rows,
# 4 + 32), and at the bench's greedy decode (64 rows, 4 + 48) early and last
DECODE_STEP_CASES = (
    ("beam_early", 80, 132, 3),
    ("beam_last", 80, 132, 131),
    ("greedy_last", 8, 36, 35),
    ("bench_early", 64, 52, 4),
    ("bench_last", 64, 52, 51),
)
# (name, rows, G, Tmax, idx, mask): K8 at the speculative serving path's
# shapes, whisper-base, batch 16, gamma 4, 4 prompt + 128 new tokens (the
# self cache holds 4 + 4 x 128 = 516 columns): the verify step early and
# late with the holes of rejected drafts, and the prompt's prefill under the
# contiguous rule broadcast over rows
DECODE_STEP_MULTI_CASES = (
    ("verify_early", 16, 4, 516, 8, "holes"),
    ("verify_late", 16, 4, 516, 508, "holes"),
    ("prefill", 16, 4, 516, 0, "broadcast"),
)
# the share of earlier verify columns a row keeps (accepted drafts) in the
# K8 cases' hole masks
ACCEPTED_SHARE = 0.7
DECODE_HEADS, DECODE_HEAD_DIM = 8, 64
# K6 timings cycle through this many copies of the cache, more bytes than
# the 50 MB L2 holds, so that each call reads device memory as the decoder
# does (it reads six layers' caches in turn)
CACHE_COPIES = 4
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
# Ring attention at n = 4 against K1/K2 on the whole sequence: each of the
# n partial outputs and gradients is rounded to bf16 by K4 before the f32
# merge or sum, and rounded again at the end, so the ring adds about five
# roundings of 2^-9 of the largest value to K1's bound (O_TOL: o is bf16 with
# |o| < 1, at most 2^-8 spacing) and to K2's relative bound: 2e-2 + 5 x 2^-9.
RING_O_TOL = 2e-2
RING_GRAD_REL_TOL = 3e-2
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
SLICE_REPEATS = 3
# The eval CLI's decode (neuspeech1_tpu/cli/evaluation.py defaults)
BEAM_SETTINGS = dict(num_beams=5, repetition_penalty=5.0,
                     no_repeat_ngram_size=2)
BEAM_BATCH = 16
BEAM_NEW_TOKENS = 128
BEAM_REPEATS = 3
BEAM_FORCED_STEPS = 8
# Speculative serving: the JAX package's measured gamma, at the beam phase's
# batch and budget
SPEC_BATCH = 16
SPEC_NEW_TOKENS = 128
SPEC_GAMMA = 4
SPEC_REPEATS = 3
# tokens accepted in each forced verify iteration of the logits check: the
# 4 - m rejected columns of each iteration stay as holes
SPEC_FORCED_ACCEPTS = (1, 4, 2, 3, 1)
SAMPLE_RATE = 200  # Hz: a 30 s clip is the stem's 6000 samples
# The TPU probes' geometry (perf/*.py): B*H = 512 heads of D = 64 over
# TK = 1536 keys, T = 1500 kept; the dot's [512, K] @ [K, 1536] over 256
# grid steps. Checked against the plain versions at 8 heads (B = 1 in the
# [B, T, H*D] layout) and 4 grid steps first, then checked and timed at the
# full shape.
PROBE_BH, PROBE_H, PROBE_D, PROBE_TK, PROBE_T = 512, 8, 64, 1536, 1500
PROBE_DOT_M, PROBE_DOT_GRID = 512, 256
PROBE_CHECK_BH, PROBE_DOT_CHECK_GRID = 8, 4
# calls of each variant's kernel in its timing, after one checked call
PROBE_WARMUP, PROBE_ITERS = 3, 20
# Kernel against plain version on the same bf16 inputs: the forward's o
# (two bf16 ulps of the largest |o|, as K6) and lse (f32, absolute); the
# bf16-operand backward as K2 (a few ulps of the largest gradient, from p
# and ds rounded at the same points and f32 sums in another order); the
# f32-operand backward and the dot round only their outputs, so a flip
# of that one rounding: 2^-7 of the largest value, 1e-2.
PROBE_TOL = {"probe_fwd": 2.0 ** -6, "probe_bwd_bf16": 2e-2,
             "probe_bwd_f32": 1e-2, "probe_dot": 1e-2}
# The eval CLI (the `eval` phase): a synthetic corpus of 2-10 s clips over
# 208 channels, three batches of 16, decoded with the CLI's defaults (beam 5,
# repetition penalty 5.0, no-repeat-ngram 2, 128 new tokens)
EVAL_CLIPS = 48
EVAL_BATCH = 16
EVAL_NEW_TOKENS = 128
EVAL_DURATION_S = (2.0, 10.0)
# `sequence_bias` held between the card and the CPU at the beam step's shape
# (16 utterances x 5 beams over whisper-base's vocabulary), scoring the
# position after EVAL_BIAS_CUR_LEN tokens drawn from the corpus's words;
# besides the CLI's bias (-1.0, exact in any order of summation), a bias whose
# sums round (0.1), so that the order of the sums shows in the bits
EVAL_BIAS_ROWS = 80
EVAL_BIAS_CUR_LEN = 40
EVAL_BIAS_WEIGHTS = (-1.0, 0.1)
# Greedy serving with unmerged adapters (the `lora` phase)
LORA_RANK = 32
LORA_FORCED_STEPS = 8
# K4, the flash forward and backward with a bias row (ring attention's
# blocks): (name, B, T, H, D, masked key columns at the end). (a) the SP
# training step's encoder at n = 1 (1500 frames padded to 1536, the last 36
# keys masked); (b) a round of a ring of 4 over whisper-base's padded 1536
# frames whose key block lies wholly past kv_valid_len; (c) a block of it
# partly past (kv_valid_len 1000: keys 768..1151 keep 232)
BIAS_CASES = (
    ("sp_step_n1", 64, 1536, 8, 64, 36),
    ("ring_n4_masked_block", 8, 384, 8, 64, 384),
    ("ring_n4_partial_block", 8, 384, 8, 64, 152),
)
# The ring phase: a LocalRing of RING_N threads on the card at whisper-base
# widths, 1500 frames padded to 1536, and kv_valid_len 1000, which masks the
# fourth shard entirely
RING_N = 4
RING_BATCH = 8
RING_T = 1536
RING_KV_VALID = (1500, 1000)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> dict:
    """The least time the card could take for a call that moves ``n_bytes``
    (each input read once, each output written once) and does ``flops``
    operations at ``peak`` (bf16 tensor cores unless given), and which of
    the two sets it."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
    from neuspeech1_tpu_torch.ops import decode_cross as dc
    from neuspeech1_tpu_torch.ops import decode_step as ds
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb
    from neuspeech1_tpu_torch.ops import probe_bwd, probe_dot, probe_fwd

    loaders = {"flash_fwd_btc": fa._library, "flash_bwd_btc": fa._bwd_library,
               "lora_bwd": lb._library, "decode_cross": dc._library,
               "decode_step": ds._library,
               "decode_step_multi": ds._multi_library,
               "probe_fwd": probe_fwd._library,
               "probe_bwd": probe_bwd._library,
               "probe_dot": probe_dot._library}

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


def _flash_cost(b, t_q, t_kv, h, d, causal, kv_len):
    """(bytes, flops) of one flash forward: q, k, v rows read up to kv_len,
    o written in bf16, lse in f32; the QK^T and PV products over the
    (row, column) pairs the masks keep."""
    kvl = kv_len or t_kv
    pairs = t_q * (t_q + 1) // 2 if causal else t_q * kvl
    n_bytes = 2 * b * h * d * (2 * t_q + 2 * kvl) + 4 * b * h * t_q
    return n_bytes, 4 * b * h * pairs * d


def _sdpa_inputs(q, k, v, kv_len):
    """The [B, H, T, D] copies SDPA takes, K/V cut at kv_len."""
    kvl = kv_len or k.shape[1]
    return tuple(x[:, :n].transpose(1, 2).contiguous()
                 for x, n in ((q, q.shape[1]), (k, kvl), (v, kvl)))


def phase_kernels() -> list:
    import torch.nn.functional as F

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
        again = fa.flash_attention_bthd(q, k, v, causal, kv_len,
                                        return_lse=True)
        o_p, lse_p = fa.flash_attention_bthd_plain(q, k, v, causal, kv_len,
                                                   return_lse=True)
        torch.cuda.synchronize()
        o_err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err = (lse_k - lse_p).abs().max().item()
        sq, sk, sv = _sdpa_inputs(q, k, v, kv_len)
        n_bytes, flops = _flash_cost(b, t, t_kv, h, d, causal, kv_len)
        ms = cuda_ms(lambda: fa.flash_attention_bthd(q, k, v, causal, kv_len))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, is_causal=causal))
        res = {
            "phase": "kernels", "kernel": "K1", "case": case["name"],
            "shape": [b, t, t_kv, h, d], "causal": causal, "kv_len": kv_len,
            "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
            "o_tol": O_TOL, "lse_tol": LSE_TOL,
            "ms": ms,
            "plain_ms": cuda_ms(lambda: fa.flash_attention_bthd_plain(
                q, k, v, causal, kv_len)),
            "library_ms": library_ms,
            "tflops": _tflops(flops, ms),
            "library_tflops": _tflops(flops, library_ms),
            "same_bits": _same_bits((o_k, lse_k), again),
            **bound(n_bytes, flops),
        }
        emit(res)
        check(bool(torch.isfinite(o_k.float()).all()), f"{case}: non-finite o")
        check(o_err <= O_TOL and lse_err <= LSE_TOL,
              f"K1 {case['name']}: kernel disagrees with plain version")
        check(res["same_bits"],
              f"K1 {case['name']}: a second run gave other bits")
        results.append(res)
        if case.get("bwd"):
            results.append(_check_flash_bwd(case, q, k, v, o_k, lse_k, gen))
    results.append(_check_bhtd_layout(gen))
    results.extend(_check_lora_bwd(gen))
    results.extend(_check_flash_bias(gen))
    results.extend(_check_decode_cross(gen))
    results.extend(_check_decode_step(gen))
    results.extend(_check_decode_step_multi(gen))
    return results


def _sdpa_bwd_ms(q, k, v, do, causal, kv_len) -> float:
    """One autograd call through SDPA's backward on the same inputs."""
    import torch.nn.functional as F

    sq, sk, sv = (x.requires_grad_() for x in _sdpa_inputs(q, k, v, kv_len))
    o = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
    sdo = do.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(o, (sq, sk, sv), sdo,
                                               retain_graph=True))


def _bwd_split_ms(fn, calls: int = 5) -> dict:
    """Device ms per call of each of the backward's three kernels (delta,
    dk/dv, dq), from one torch.profiler pass over ``calls`` calls of ``fn``,
    by the compiled kernels' names."""
    def read(events):
        split = dict.fromkeys(("delta", "dkdv", "dq"), 0.0)
        for e in events:
            if e.device_type.name != "CUDA":
                continue
            for part in split:
                if f"flash_bwd_{part}_kernel" in e.key:
                    split[part] += e.self_device_time_total / 1e3 / calls
        return split

    split = _profiled(fn, calls, read, lambda sp: all(sp.values()))
    check(all(split.values()), f"backward split: a kernel not seen: {split}")
    return split


def _profiled(fn, calls: int, read, seen, windows: int = 3):
    """``read`` of torch.profiler's key averages over ``calls`` calls of
    ``fn``, after one call outside the window. The profiler on the card now
    and then hands back a window without its device events; a window whose
    reading ``seen`` rejects is taken again, up to ``windows`` times, and
    the last reading is returned either way."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        value = read(prof.key_averages())
        if seen(value):
            break
    return value


def _same_bits(a, b) -> bool:
    """Whether two tuples of bf16 or f32 tensors are equal bit for bit."""
    ints = {2: torch.int16, 4: torch.int32}
    return all(torch.equal(x.view(ints[x.element_size()]),
                           y.view(ints[y.element_size()]))
               for x, y in zip(a, b))


def _device_ms(fn, calls: int = 10) -> float:
    """Device ms per call of ``fn``: the time of every kernel it launches,
    summed under torch.profiler over ``calls`` calls (``cuda_ms`` times the
    host's loop, which a small call's launch can set)."""
    total = _profiled(
        fn, calls, lambda events: sum(e.self_device_time_total
                                      for e in events
                                      if e.device_type.name == "CUDA"),
        lambda t: t > 0)
    check(total > 0, "the profiler saw no device time")
    return total / 1e3 / calls


def _host_us(fn, calls: int = 100, repeats: int = 20) -> float:
    """Host microseconds per call of ``fn``: the wrapper's own time, from
    the host clock over ``calls`` calls queued without a synchronize; the
    least of ``repeats`` such runs (the host's cores are shared, so a run
    can only be slowed by others)."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / calls


def _tflops(flops: float, ms: float) -> float:
    """The rate of ``flops`` operations done in ``ms`` milliseconds."""
    return flops / ms / 1e9


def _check_flash_bwd(case, q, k, v, o, lse, gen) -> dict:
    """K2 against its plain version on the forward kernel's o and lse."""
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    causal, kv_len = case.get("causal", False), case.get("kv_len")
    kvl = kv_len or k.shape[1]
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, o, do, lse, causal, kvl)
    grads = fa._flash_bwd_cuda(*args)
    again = fa._flash_bwd_cuda(*args)
    plain = fa.flash_attention_bthd_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {f"{n}_rel_err": _rel_err(g, p)
            for n, g, p in zip(("dq", "dk", "dv"), grads, plain)}
    abs_err = max((g.float() - p.float()).abs().max().item()
                  for g, p in zip(grads, plain))
    b, t_q, h, d = q.shape
    # reads q, k, v, o, do (bf16) and lse (f32), writes dq, dk, dv; five
    # products over the kept pairs, 2.5 times the forward's two
    fwd_bytes, fwd_flops = _flash_cost(b, t_q, k.shape[1], h, d, causal,
                                       kv_len)
    n_bytes = 2 * b * h * d * (4 * t_q + 4 * kvl) + 4 * b * h * t_q
    res = {"phase": "kernels", "kernel": "K2", "case": case["name"],
           "max_abs_err": abs_err,
           "shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     q.shape[3]],
           "causal": causal, "kv_len": kv_len, **errs, "rel_tol": K2_REL_TOL,
           "ms": cuda_ms(lambda: fa._flash_bwd_cuda(*args)),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_bthd_bwd_plain(
               *args)),
           "library_ms": _sdpa_bwd_ms(q, k, v, do, causal, kv_len),
           "split_ms": _bwd_split_ms(lambda: fa._flash_bwd_cuda(*args)),
           "same_bits": _same_bits(grads, again),
           **bound(n_bytes, 2.5 * fwd_flops)}
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
    check(res["same_bits"],
          f"K2 {case['name']}: a second run gave other bits")
    return res


def _check_bhtd_layout(gen) -> dict:
    """K1 and K2 through the [B, H, T, D] entry (the JAX package's K5
    kernels), forward and autograd backward, against the plain versions."""
    import torch.nn.functional as F

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
    fwd_bytes, fwd_flops = _flash_cost(b, t, t, h, d, False, None)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    res = {"phase": "kernels", "kernel": "K5", "case": "bhtd_fwd_bwd",
           "shape": [b, h, t, d], "launches": launches,
           "o_max_abs_err": o_err.item(), **errs,
           "grad_max_abs_err": max(
               (x.grad.float() - p.transpose(1, 2).float()).abs().max().item()
               for x, p in zip((q, k, v), plain)),
           "o_tol": O_TOL, "rel_tol": K2_REL_TOL,
           "ms": cuda_ms(lambda: fa.flash_attention(qd, kd, vd)),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_bthd_plain(
               qt, kt, vt)),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               qd, kd, vd)),
           "bwd_ms": cuda_ms(lambda: fa._flash_bwd_cuda(*bwd_args)),
           "bwd_plain_ms": cuda_ms(
               lambda: fa.flash_attention_bthd_bwd_plain(*bwd_args)),
           "bwd_library_ms": _sdpa_bwd_ms(qt, kt, vt, do.transpose(1, 2),
                                          False, None),
           **bound(fwd_bytes, fwd_flops)}
    bwd_bound = bound(2 * b * h * d * 8 * t + 4 * b * h * t, 2.5 * fwd_flops)
    res.update(bwd_bound_ms=bwd_bound["bound_ms"],
               bwd_bound_by=bwd_bound["bound_by"])
    emit(res)
    check(o_err.item() <= O_TOL and max(errs.values()) <= K2_REL_TOL,
          "K5 [B, H, T, D]: kernels disagree with plain versions")
    return res


def _check_lora_bwd(gen) -> list:
    """K3 against its plain version at the fc1 / fc2 shapes of the training
    step (N = 64 x 1500 tokens) and at a ragged N with rank 12: CUDA
    events, device time under torch.profiler (both of the call's launches)
    and the wrapper's host time; a second call gives the same bits."""
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
        same = _same_bits(got, lb.lora_adapter_bwd(x, dy, a, bm))
        torch.cuda.synchronize()
        plan = lb.plan(n, din, dout, r, lb._sm_count(0))
        errs = {f"{k}_rel_err": _rel_err(g, p)
                for k, g, p in zip(("dA", "dB", "dE"), got, ref)}
        # reads x, dy, A, B (bf16), writes dA, dB, dE (f32); four rank-r
        # products over N tokens (t1, u, dA, dB)
        n_bytes = 2 * (n * (din + dout) + r * (din + dout)) \
            + 4 * (r * (din + dout) + r)
        res = {"phase": "kernels", "kernel": "K3", "case": name,
               "max_abs_err": max((g - p).abs().max().item()
                                  for g, p in zip(got, ref)),
               "shape": [n, din, dout, r], **errs, "rel_tol": K3_REL_TOL,
               "ms": cuda_ms(lambda: lb.lora_adapter_bwd(x, dy, a, bm)),
               "plain_ms": cuda_ms(lambda: lb.lora_adapter_bwd_plain(
                   x, dy, a, bm)),
               "library_ms": None,
               "device_ms": _device_ms(lambda: lb.lora_adapter_bwd(
                   x, dy, a, bm)),
               "host_us": _host_us(lambda: lb.lora_adapter_bwd(x, dy, a, bm)),
               "same_bits": same,
               "plan": plan._asdict(),
               "resident_clusters": lb.resident_clusters(plan),
               **bound(n_bytes, 4 * n * r * (din + dout))}
        emit(res)
        check(all(torch.isfinite(g).all() for g in got),
              f"K3 {name}: non-finite gradients")
        check(max(errs.values()) <= K3_REL_TOL,
              f"K3 {name}: kernel disagrees with plain version")
        check(same, f"K3 {name}: a second call gave other bits")
        out.append(res)
    return out


def _bias_row(t: int, masked: int):
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    bias = torch.zeros(t, device="cuda")
    bias[t - masked:] = fa.NEG_INF
    return bias


def _check_flash_bias(gen) -> list:
    """K4's forward and backward against their plain versions at
    BIAS_CASES: o and lse (NaN and -inf in the same places; every row of a
    fully masked block NaN and -inf), then dq, dk, dv against one block
    with the global o and lse of a two-block merge (the block and an
    unmasked one), as the ring's backward takes them. Timed beside SDPA
    with the bias as a float mask where it computes the same function (not
    for a fully masked block, where SDPA's rows are not NaN)."""
    import torch.nn.functional as F

    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.parallel.ring_attention import merge

    out = []
    for name, b, t, h, d, masked in BIAS_CASES:
        q, k, v, k2, v2, do = (_bthd(gen, b, t, h, d) for _ in range(6))
        bias = _bias_row(t, masked)
        o_k, lse_k = fa.flash_bias_fwd(q, k, v, bias)
        again = fa.flash_bias_fwd(q, k, v, bias)
        o_p, lse_p = fa.flash_bias_fwd_plain(q, k, v, bias)
        torch.cuda.synchronize()
        nan_k, nan_p = torch.isnan(o_k), torch.isnan(o_p)
        ninf_k, ninf_p = lse_k == float("-inf"), lse_p == float("-inf")
        fin = ~nan_p
        o_err = ((o_k.float() - o_p.float())[fin].abs().max().item()
                 if fin.any() else 0.0)
        lse_err = ((lse_k - lse_p)[~ninf_p].abs().max().item()
                   if (~ninf_p).any() else 0.0)
        kept = t - masked
        sq, sk, sv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = bias.to(q.dtype).view(1, 1, 1, t)
        library = kept > 0
        # the products over the kept columns only
        flops = 4 * b * h * t * kept * d
        ms = cuda_ms(lambda: fa.flash_bias_fwd(q, k, v, bias))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask)) if library else None
        res = {"phase": "kernels", "kernel": "K4", "case": name,
               "shape": [b, t, t, h, d], "masked_columns": masked,
               "o_max_abs_err": o_err,
               "lse_max_abs_err": lse_err,
               "nan_equal": bool(torch.equal(nan_k, nan_p)),
               "ninf_equal": bool(torch.equal(ninf_k, ninf_p)),
               "o_tol": O_TOL, "lse_tol": LSE_TOL,
               "ms": ms,
               "plain_ms": cuda_ms(lambda: fa.flash_bias_fwd_plain(
                   q, k, v, bias)),
               "library_ms": library_ms,
               "tflops": _tflops(flops, ms),
               "library_tflops": (_tflops(flops, library_ms) if library
                                  else None),
               "same_bits": _same_bits((o_k, lse_k), again),
               # q, k, v read, o written (bf16), lse written and the bias
               # read (f32)
               **bound(2 * b * h * d * 4 * t + 4 * b * h * t + 4 * t,
                       flops)}
        check(res["nan_equal"] and res["ninf_equal"],
              f"K4 {name}: NaN / -inf rows differ from the plain version")
        check(res["same_bits"],
              f"K4 {name}: a second run gave other bits")
        if kept == 0:
            res["all_rows_nan_and_ninf"] = bool(nan_k.all() and ninf_k.all())
            check(res["all_rows_nan_and_ninf"],
                  f"K4 {name}: a fully masked block must give o NaN and "
                  "lse -inf on every row")
        else:
            check(not nan_k.any(), f"K4 {name}: NaN in a kept row")
        check(o_err <= O_TOL and lse_err <= LSE_TOL,
              f"K4 {name}: kernel disagrees with plain version")
        emit(res)
        out.append(res)

        # the backward against this block with the global o and lse of a
        # merge with an unmasked block
        o2, lse2 = fa.flash_bias_fwd_plain(q, k2, v2, torch.zeros_like(bias))
        o_g, lse_g = merge(o_p.float(), lse_p, o2.float(), lse2)
        args = (q, k, v, o_g.to(q.dtype), do, lse_g.contiguous(), bias)
        grads = fa.flash_bias_bwd(*args)
        again = fa.flash_bias_bwd(*args)
        plain = fa.flash_bias_bwd_plain(*args)
        torch.cuda.synchronize()
        abs_err = max((g.float() - p.float()).abs().max().item()
                      for g, p in zip(grads, plain))
        if kept == 0:  # every p is 0: the plain grads are exactly 0
            errs = {f"{n}_max_abs": g.float().abs().max().item()
                    for n, g in zip(("dq", "dk", "dv"), grads)}
            ok = abs_err == 0.0 and not any(errs.values())
        else:
            errs = {f"{n}_rel_err": _rel_err(g, p)
                    for n, g, p in zip(("dq", "dk", "dv"), grads, plain)}
            ok = max(errs.values()) <= K2_REL_TOL
        bwd = {"phase": "kernels", "kernel": "K4_bwd", "case": name,
               "shape": [b, t, t, h, d], "masked_columns": masked,
               "max_abs_err": abs_err, **errs,
               "rel_tol": K2_REL_TOL,
               "ms": cuda_ms(lambda: fa.flash_bias_bwd(*args)),
               "plain_ms": cuda_ms(lambda: fa.flash_bias_bwd_plain(*args)),
               # SDPA's backward computes this function where the block's
               # lse is the global one: at (a), a ring of one
               "library_ms": (_sdpa_bias_bwd_ms(q, k, v, mask, do)
                              if name == "sp_step_n1" else None),
               "split_ms": _bwd_split_ms(lambda: fa.flash_bias_bwd(*args)),
               "same_bits": _same_bits(grads, again),
               # q, k, v, o, do read and dq, dk, dv written (bf16), lse and
               # the bias read; five products over the kept columns
               **bound(2 * b * h * d * 8 * t + 4 * b * h * t + 4 * t,
                       2.5 * 4 * b * h * t * kept * d)}
        emit(bwd)
        check(all(torch.isfinite(g.float()).all() for g in grads),
              f"K4 backward {name}: non-finite gradients")
        check(ok, f"K4 backward {name}: kernel disagrees with plain version")
        check(bwd["same_bits"],
              f"K4 backward {name}: a second run gave other bits")
        out.append(bwd)
    return out


def _sdpa_bias_bwd_ms(q, k, v, mask, do) -> float:
    """One autograd call through SDPA's backward with a float mask."""
    import torch.nn.functional as F

    sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
    sdo = do.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(o, (sq, sk, sv), sdo,
                                               retain_graph=True))


def _check_decode_cross(gen) -> list:
    """K6 against its plain version at the greedy and beam decoder's shapes,
    through both cache layouts; timed over CACHE_COPIES caches in turn,
    beside SDPA on the same [B, H, Tq, D] x [B, H, T, D] inputs: CUDA
    events, device time under torch.profiler and the wrapper's host time;
    and a second call on the same inputs gives the same bits."""
    import torch.nn.functional as F

    from neuspeech1_tpu_torch.ops import decode_cross as dc

    h, d = DECODE_HEADS, DECODE_HEAD_DIM
    out = []
    for name, b, t_q, t, kv_len, layout in DECODE_CROSS_CASES:
        kvl = kv_len or t
        q = (torch.randn((b, t_q, h * d), generator=gen, device="cuda")
             .to(torch.bfloat16).view(b, t_q, h, d))
        shape = (b, t, h * d) if layout == "btc" else (b, h, t, d)
        caches = [tuple(torch.randn(shape, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(2))
                  for _ in range(CACHE_COPIES)]

        def bhtd(kv, layout=layout, b=b, t=t):
            """The [B, H, T, D] view of a cache pair."""
            if layout == "btc":
                return tuple(x.view(b, t, h, d).transpose(1, 2) for x in kv)
            return kv

        def kernel(kv, layout=layout, q=q, kv_len=kv_len):
            if layout == "btc":
                return dc.decode_cross_btc(q, *kv, kv_len)
            return dc.decode_cross(q, *kv, kv_len)

        dc.launches = 0
        o_k = kernel(caches[0])
        launches = dc.launches
        o_p = dc.decode_cross_plain(q, *bhtd(caches[0]), kv_len)
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        rel = _rel_err(o_k, o_p)
        same = _same_bits((o_k,), (kernel(caches[0]),))
        cycle = itertools.cycle(caches)
        qs = q.transpose(1, 2)

        def sdpa(qs=qs, bhtd=bhtd, kvl=kvl):
            return F.scaled_dot_product_attention(
                qs, *(x[:, :, :kvl] for x in bhtd(next(cycle))))

        res = {"phase": "kernels", "kernel": "K6", "case": name,
               "layout": layout, "shape": [b, t_q, t, h, d], "kv_len": kvl,
               "launches": launches, "max_abs_err": err,
               "max_abs_plain": o_p.float().abs().max().item(),
               "rel_err": rel, "rel_tol": K6_REL_TOL,
               "ms": cuda_ms(lambda: kernel(next(cycle))),
               "plain_ms": cuda_ms(lambda: dc.decode_cross_plain(
                   q, *bhtd(next(cycle)), kv_len)),
               "library_ms": cuda_ms(sdpa),
               "device_ms": _device_ms(lambda: kernel(next(cycle))),
               "library_device_ms": _device_ms(sdpa),
               "host_us": _host_us(lambda: kernel(next(cycle))),
               "same_bits": same,
               # K and V rows up to kv_len read, q read and o written
               **bound(2 * b * h * d * (2 * kvl + 2 * t_q),
                       4 * b * h * t_q * kvl * d)}
        emit(res)
        check(launches == 1, f"K6 {name}: {launches} launches for one call")
        check(bool(torch.isfinite(o_k.float()).all()), f"K6 {name}: non-finite")
        check(rel <= K6_REL_TOL,
              f"K6 {name}: kernel disagrees with plain version")
        check(same, f"K6 {name}: a second call gave other bits")
        out.append(res)
    return out


def _check_decode_step(gen) -> list:
    """K7 against its plain version at the beam and greedy steps' shapes:
    the context within K7_TOL and the caches after the in-place write equal,
    the same bits from a second call; timed over CACHE_COPIES caches in turn
    (CUDA events, device time under torch.profiler and the wrapper's host
    time). No single PyTorch call computes this function (a cache write and
    a masked attention)."""
    from neuspeech1_tpu_torch.ops import decode_step as ds

    h, d = DECODE_HEADS, DECODE_HEAD_DIM
    out = []
    for name, rows, t_max, idx in DECODE_STEP_CASES:
        q, kn, vn = (torch.randn((rows, 1, h * d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     .view(rows, 1, h, d) for _ in range(3))
        caches = [tuple(torch.randn((rows, h, d, t_max), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                        for _ in range(2)) for _ in range(CACHE_COPIES)]
        kp, vp = (x.clone() for x in caches[0])
        ctx_k = ds.decode_step(q, kn, vn, *caches[0], idx)
        ctx_p = ds.decode_step_plain(q, kn, vn, kp, vp, idx)
        torch.cuda.synchronize()
        err = (ctx_k.float() - ctx_p.float()).abs().max().item()
        caches_equal = bool(torch.equal(caches[0][0], kp)
                            and torch.equal(caches[0][1], vp))
        same = _same_bits((ctx_k,), (ds.decode_step(q, kn, vn, *caches[0],
                                                    idx),))
        cycle = itertools.cycle(caches)
        res = {"phase": "kernels", "kernel": "K7", "case": name,
               "shape": [rows, h, d, t_max], "idx": idx, "max_abs_err": err,
               "tol": K7_TOL, "caches_equal": caches_equal,
               "ms": cuda_ms(lambda: ds.decode_step(q, kn, vn, *next(cycle),
                                                    idx)),
               "plain_ms": cuda_ms(lambda: ds.decode_step_plain(
                   q, kn, vn, *next(cycle), idx)),
               "library_ms": None,
               "device_ms": _device_ms(lambda: ds.decode_step(
                   q, kn, vn, *next(cycle), idx)),
               "host_us": _host_us(lambda: ds.decode_step(
                   q, kn, vn, *next(cycle), idx)),
               "same_bits": same,
               # K and V columns 0..idx-1 read, column idx written, q, k_new,
               # v_new read and the context written
               **bound(2 * rows * h * d * (2 * idx + 2 + 4),
                       4 * rows * h * d * (idx + 1))}
        emit(res)
        check(caches_equal, f"K7 {name}: caches differ from the plain write")
        check(bool(torch.isfinite(ctx_k.float()).all()), f"K7 {name}: non-finite")
        check(err <= K7_TOL, f"K7 {name}: kernel disagrees with plain version")
        check(same, f"K7 {name}: a second call gave other bits")
        out.append(res)
    return out


def _check_decode_step_multi(gen) -> list:
    """K8 against its plain version at the speculative serving path's
    shapes: the context within K8_TOL and the caches after the in-place
    writes equal, the same bits from a second call; timed over CACHE_COPIES
    caches in turn (CUDA events, device time under torch.profiler and the
    wrapper's host time). No single PyTorch
    call computes this function (G cache writes and a masked attention
    per query)."""
    from neuspeech1_tpu_torch.decode.spec import verify_mask
    from neuspeech1_tpu_torch.ops import decode_step as ds

    h, d = DECODE_HEADS, DECODE_HEAD_DIM
    out = []
    for name, rows, g, t_max, idx, kind in DECODE_STEP_MULTI_CASES:
        q, kn, vn = (torch.randn((rows, g, h * d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     .view(rows, g, h, d) for _ in range(3))
        caches = [tuple(torch.randn((rows, h, d, t_max), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                        for _ in range(2)) for _ in range(CACHE_COPIES)]
        if kind == "broadcast":
            valid = torch.zeros((1, t_max), dtype=torch.bool, device="cuda")
        else:
            valid = torch.rand((rows, t_max), generator=gen,
                               device="cuda") < ACCEPTED_SHARE
        valid[:, :4] = True  # the prompt
        valid[:, idx:] = False
        mask = verify_mask(valid, idx, g)
        kp, vp = (x.clone() for x in caches[0])
        ds.multi_launches = 0
        ctx_k = ds.decode_step_multi(q, kn, vn, mask, *caches[0], idx)
        launches = ds.multi_launches
        ctx_p = ds.decode_step_multi_plain(q, kn, vn, mask, kp, vp, idx)
        torch.cuda.synchronize()
        err = (ctx_k.float() - ctx_p.float()).abs().max().item()
        caches_equal = bool(torch.equal(caches[0][0], kp)
                            and torch.equal(caches[0][1], vp))
        same = _same_bits((ctx_k,), (ds.decode_step_multi(
            q, kn, vn, mask, *caches[0], idx),))
        # what this run's data needs: the K and V columns some query's mask
        # allows before the block (the kernel skips the holes), per row;
        # the block's G columns written; q, k_new, v_new and the mask read;
        # the context written. Operations: the score and PV products over
        # every (query, allowed column) pair.
        allowed = mask[:, 0].expand(rows, g, t_max)
        old_cols = int(allowed[:, :, :idx].any(dim=1).sum())
        pairs = int(allowed.sum())
        n_bytes = (2 * h * d * 2 * (old_cols + rows * g)
                   + 2 * rows * g * h * d * 4 + mask.numel())
        cycle = itertools.cycle(caches)
        res = {"phase": "kernels", "kernel": "K8", "case": name,
               "shape": [rows, g, h, d, t_max], "idx": idx, "mask": kind,
               "columns_read": old_cols, "launches": launches,
               "max_abs_err": err, "tol": K8_TOL,
               "caches_equal": caches_equal,
               "ms": cuda_ms(lambda: ds.decode_step_multi(
                   q, kn, vn, mask, *next(cycle), idx)),
               "plain_ms": cuda_ms(lambda: ds.decode_step_multi_plain(
                   q, kn, vn, mask, *next(cycle), idx)),
               "library_ms": None,
               "device_ms": _device_ms(lambda: ds.decode_step_multi(
                   q, kn, vn, mask, *next(cycle), idx)),
               "host_us": _host_us(lambda: ds.decode_step_multi(
                   q, kn, vn, mask, *next(cycle), idx)),
               "same_bits": same,
               **bound(n_bytes, 4 * h * d * pairs)}
        emit(res)
        check(launches == 1, f"K8 {name}: {launches} launches for one call")
        check(caches_equal, f"K8 {name}: caches differ from the plain write")
        check(bool(torch.isfinite(ctx_k.float()).all()),
              f"K8 {name}: non-finite")
        check(err <= K8_TOL, f"K8 {name}: kernel disagrees with plain version")
        check(same, f"K8 {name}: a second call gave other bits")
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


def serving_model(tmp: str):
    """whisper-base (bf16 compute) with the 'base' EEG stem over 208
    channels, weights from seed 0, written as a full-model directory under
    ``tmp``, and a word vocabulary for it: (config, model_dir, tokenizer
    spec). Its token layout is layout_for_vocab(50257, 99), so a 50257-word
    vocabulary is its tokenizer (the byte tokenizer needs eot_id 256)."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.init import init_params

    config, stem = common.preset_model("base", "base", in_channels=208)
    model_dir = common.save_full_model(
        os.path.join(tmp, "full_model"), init_params(config, stem, seed=0),
        config, stem)
    vocab = os.path.join(tmp, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(f"w{i}" for i in range(config.eot_id)) + "\n")
    return config, model_dir, f"word:{vocab}"


@contextlib.contextmanager
def count_model_calls():
    """Counts the calls the decode loops make into the model while the
    context is open: encoder calls; cached decoder calls; of those, the
    calls on a speculative (``k_tu``) self cache, the calls one token wide
    without a mask on the other self cache, and the calls on an int8 cross
    cache; and the chunks of at most K6's MAX_TQ rows that the
    cross-attention queries of the calls on a bf16 cross cache take (an
    utterance's beam rows fold into its query)."""
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.ops.decode_cross import MAX_TQ

    calls = {"encoder": 0, "cached_decoder": 0, "k_tu": 0, "width1": 0,
             "int8": 0, "cross_chunks": 0}
    encoder_apply, decoder_apply = tw.encoder_apply, tw.decoder_apply

    def counted_encoder(*args, **kw):
        calls["encoder"] += 1
        return encoder_apply(*args, **kw)

    def counted_decoder(model, tokens, enc_out, cache=None, cache_index=None,
                        lora=None, pos_ids=None, self_attn_mask=None):
        if cache is not None:
            calls["cached_decoder"] += 1
            if "k_tu" in cache["self"][0]:
                calls["k_tu"] += 1
            else:
                calls["width1"] += int(tokens.shape[1] == 1
                                       and self_attn_mask is None)
            if "k_qt" in cache["cross"][0]:
                calls["int8"] += 1
            else:
                rows = tokens.shape[0] // enc_out.shape[0] * tokens.shape[1]
                calls["cross_chunks"] += -(-rows // MAX_TQ)
        return decoder_apply(model, tokens, enc_out, cache, cache_index, lora,
                             pos_ids, self_attn_mask)

    tw.encoder_apply, tw.decoder_apply = counted_encoder, counted_decoder
    try:
        yield calls
    finally:
        tw.encoder_apply, tw.decoder_apply = encoder_apply, decoder_apply


def _expected_launches(config, calls) -> dict:
    """K1 once per encoder layer and encoder call, K6 once per decoder layer
    and query chunk of a cached decoder call on a bf16 cross cache (one
    chunk per call at the served shapes), K7 once per decoder layer and
    width-1 call, K8 once per decoder layer and call on a k_tu cache."""
    return {"K1": config.encoder_layers * calls["encoder"],
            "K2": 0, "K3": 0, "K4": 0, "K4_bwd": 0,
            "K6": config.decoder_layers * calls["cross_chunks"],
            "K7": config.decoder_layers * calls["width1"],
            "K8": config.decoder_layers * calls["k_tu"]}


def _check_serving_launches(name, config, calls, counts,
                            path=("K1", "K6", "K7")) -> None:
    """The launches equal the model calls' count, and each kernel of
    ``path`` ran."""
    expect = _expected_launches(config, calls)
    check(counts == expect, f"{name}: kernel launches {counts}, expected "
          f"{expect} from the model calls {calls}")
    check(all(counts[k] > 0 for k in path),
          f"{name}: a kernel of the path was never launched: {counts}")


def _jax_free() -> bool:
    return not any(m in ("jax", "neuspeech1_tpu")
                   or m.startswith(("jax.", "neuspeech1_tpu."))
                   for m in sys.modules)


def phase_slice(model) -> dict:
    """Greedy serving: 16 signals in two batches of 8, 32 new tokens."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import generate
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.serve import Transcriber

    config, model_dir, tokenizer = model
    t0 = time.perf_counter()
    tr = Transcriber(model_dir, tokenizer=tokenizer, batch_size=SLICE_BATCH,
                     max_new_tokens=SLICE_NEW_TOKENS, device="cuda")
    setup_s = time.perf_counter() - t0
    # the stem strides by 2 twice: 4 samples per encoder position
    signals = _signals(tr.stem.in_channels, 4 * config.max_source_positions)

    tr.transcribe(signals[:SLICE_BATCH])  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    _reset_counts()
    with count_model_calls() as calls:
        t0 = time.perf_counter()
        texts = tr.transcribe(signals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _kernel_counts()
    _check_serving_launches("slice", config, calls, launches)
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
    check(_jax_free(), "jax or the JAX package was imported")
    out = {
        "phase": "slice", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "signals": SLICE_SIGNALS,
        "batch_size": SLICE_BATCH, "max_new_tokens": SLICE_NEW_TOKENS,
        "launches": launches, "model_calls": calls,
        "flash_launches": launches["K1"], "setup_s": setup_s, "wall_s": wall,
        "utterances_per_s": statistics.median(rates),
        "utterances_per_s_all": rates,
        "request_latency_s": statistics.median(lat),
        "request_latency_all_s": lat,
        "encoder_max_abs_err": enc_max, "encoder_mean_abs_err": enc_mean,
        "encoder_tol": [ENC_MAX_TOL, ENC_MEAN_TOL],
        "jax_imported": not _jax_free(),
        "sample_text": texts[0][:80], "card": card(),
    }
    emit(out)
    return out


def _forced_logits(model, enc, tokens, prompt_len: int, steps: int,
                   lora=None):
    """The cached decoder's logits for B*K rows of ``tokens`` [B*K, L]: the
    prompt's prefill, then ``steps`` width-1 steps on the given tokens,
    with the decoder adapters of ``lora``; [B*K, prompt_len + steps, V]."""
    from neuspeech1_tpu_torch.models import whisper as tw

    cache = tw.init_cache(model, enc, max_len=prompt_len + steps,
                          self_batch=tokens.shape[0])
    logits, cache = tw.decoder_apply(model, tokens[:, :prompt_len], enc,
                                     cache=cache, cache_index=0, lora=lora)
    out = [logits]
    for i in range(prompt_len, prompt_len + steps):
        logits, cache = tw.decoder_apply(model, tokens[:, i:i + 1], enc,
                                         cache=cache, cache_index=i,
                                         lora=lora)
        out.append(logits)
    return torch.cat(out, dim=1)


def _agreement(a, b, prompt_len: int) -> dict:
    """How far two decodes of the same requests agree past the prompt: the
    share of equal token positions, and per row the first generated
    position where they differ (the generated length if none)."""
    eq = a[:, prompt_len:] == b[:, prompt_len:]
    n = eq.shape[1]
    first = [int(row.logical_not().nonzero()[0]) if not row.all() else n
             for row in eq]
    return {"share": eq.float().mean().item(), "first_diff": first,
            "first_diff_median": statistics.median(first)}


def _count_syncs(fn) -> int:
    """The synchronizing CUDA calls (the host waiting for the device) that
    one call of ``fn`` makes, as torch's sync debug mode reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _profile_request(fn) -> dict:
    """Device busy time, idle share and kernel launches of one call of
    ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
        # K3's launches (the one-pass kernel and its reduce, or the wide
        # path's) per step
        "k3_device_ms_per_step": sum(
            e.self_device_time_total for e in kernels
            if "lora_" in e.key) / 1e3 / PROFILE_TRACED_STEPS,
            "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


def phase_beam(model) -> dict:
    """The eval CLI's decode at full width: beam 5, repetition penalty 5.0,
    no-repeat-ngram 2, batch 16, 128 new tokens, one request of 16
    signals."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import generate
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.serve import Transcriber

    config, model_dir, tokenizer = model
    tr = Transcriber(model_dir, tokenizer=tokenizer, batch_size=BEAM_BATCH,
                     max_new_tokens=BEAM_NEW_TOKENS, device="cuda",
                     **BEAM_SETTINGS)
    signals = _signals(tr.stem.in_channels,
                       4 * config.max_source_positions)[:BEAM_BATCH]
    tr.transcribe(signals)  # warm-up
    torch.cuda.synchronize()

    _reset_counts()
    lat = []
    with count_model_calls() as calls:
        for _ in range(BEAM_REPEATS):
            t0 = time.perf_counter()
            texts = tr.transcribe(signals)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    launches = _kernel_counts()
    _check_serving_launches("beam", config, calls, launches)
    check(len(texts) == BEAM_BATCH, f"{len(texts)} texts for {BEAM_BATCH}")
    steps = calls["width1"] / BEAM_REPEATS
    med = statistics.median(lat)

    k = tr.gen.num_beams
    feats = common.upload_features(tr._prepare(signals), tr.model.dtype,
                                   tr.device)
    prompt = torch.as_tensor(np.repeat(tr.prompt, BEAM_BATCH, axis=0),
                             device=tr.device)
    p = prompt.shape[1]
    with torch.no_grad():
        tokens = generate(tr.model, feats, prompt, tr.gen)
        with _plain_kernels():
            tokens_p = generate(tr.model, feats, prompt, tr.gen)
            with _f32_compute(tr.model):
                tokens_32 = generate(tr.model, feats, prompt, tr.gen)
        # the cached decoder over 8 teacher-forced steps of the beam output,
        # each utterance's tokens on its K rows, on one set of encoder states
        enc = tw.encoder_apply(tr.model, feats)
        forced = tokens.repeat_interleave(k, dim=0)
        logits_k = _forced_logits(tr.model, enc, forced, p, BEAM_FORCED_STEPS)
        with _plain_kernels():
            logits_p = _forced_logits(tr.model, enc, forced, p,
                                      BEAM_FORCED_STEPS)
    torch.cuda.synchronize()
    ref_max = logits_p.float().abs().max().item()
    diff = (logits_k.float() - logits_p.float()).abs()
    rel = diff.max().item() / ref_max
    agree = {"kernels_vs_plain": _agreement(tokens, tokens_p, p),
             "kernels_vs_f32": _agreement(tokens, tokens_32, p),
             "plain_vs_f32": _agreement(tokens_p, tokens_32, p)}
    check(bool(torch.isfinite(logits_k.float()).all()), "non-finite logits")
    check(rel <= LOGITS_REL_TOL, f"beam: cached decoder logits with K6/K7 "
          f"{rel} of the largest logit off the plain versions")
    check(tuple(tokens.shape) == (BEAM_BATCH, tr.gen.max_length),
          f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < config.vocab_size)).all()),
          "token id outside the vocabulary")
    syncs = _count_syncs(lambda: tr.transcribe(signals))
    # the decode loop reads its stop condition once per step; the request
    # adds a few of its own (the upload, the tokens' copy to the host)
    check(syncs <= steps + 8, f"beam: {syncs} host syncs for {steps} steps")
    profile_k = _profile_request(lambda: tr.transcribe(signals))
    with _plain_kernels():
        profile_p = _profile_request(lambda: tr.transcribe(signals))
    check(_jax_free(), "jax or the JAX package was imported")
    out = {
        "phase": "beam", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, **BEAM_SETTINGS, "batch_size": BEAM_BATCH,
        "max_new_tokens": BEAM_NEW_TOKENS, "launches": launches,
        "model_calls": calls, "steps_per_request": steps,
        "request_latency_s": med, "request_latency_all_s": lat,
        "utterances_per_s": BEAM_BATCH / med,
        "utterances_per_s_all": [BEAM_BATCH / x for x in lat],
        "ms_per_step": 1e3 * med / steps,
        "forced_steps": BEAM_FORCED_STEPS,
        "logits_max_abs_err": diff.max().item(),
        "logits_mean_abs_err": diff.mean().item(),
        "logits_max_abs": ref_max, "logits_rel_err": rel,
        "logits_rel_tol": LOGITS_REL_TOL,
        "token_share_equal_plain": agree["kernels_vs_plain"]["share"],
        "token_agreement": agree,
        "profile_kernels": profile_k, "profile_plain": profile_p,
        "host_syncs_per_request": syncs,
        "kernels_per_step": profile_k["kernel_launches"] / steps,
        "plain_kernels_per_step": profile_p["kernel_launches"] / steps,
        "jax_imported": not _jax_free(),
        "sample_text": texts[0][:80], "card": card(),
    }
    emit(out)
    return out


def _forced_verify_logits(model, enc, tokens, prompt_len: int, gamma: int,
                          accepts):
    """The cached decoder's logits on the speculative (k_tu) cache for the
    rows of ``tokens`` [B, L]: the prompt's prefill, then one verify
    iteration per entry of ``accepts``, each feeding gamma tokens of
    ``tokens`` from the last accepted one and then accepting that many, so
    that the rejected columns stay as holes; [B, P + gamma * iterations,
    V]."""
    from neuspeech1_tpu_torch.decode.spec import verify_mask
    from neuspeech1_tpu_torch.models import whisper as tw

    b = tokens.shape[0]
    t_max = prompt_len + gamma * len(accepts)
    cache = tw.init_cache(model, enc, max_len=t_max, self_t_major=True)
    logits, cache = tw.decoder_apply(model, tokens[:, :prompt_len], enc,
                                     cache=cache, cache_index=0)
    out = [logits]
    valid = torch.zeros((b, t_max), dtype=torch.bool, device=tokens.device)
    valid[:, :prompt_len] = True
    n, phys = prompt_len + 1, prompt_len  # tokens accepted, next column
    ar = torch.arange(gamma, device=tokens.device)
    for m in accepts:
        logits, cache = tw.decoder_apply(
            model, tokens[:, n - 1:n - 1 + gamma], enc, cache=cache,
            cache_index=phys, pos_ids=(n - 1 + ar).expand(b, gamma),
            self_attn_mask=verify_mask(valid, phys, gamma))
        out.append(logits)
        valid[:, phys:phys + m] = True
        n += m
        phys += gamma
    return torch.cat(out, dim=1)


def _generated_lengths(tokens, prompt_len: int, eos_id: int):
    """Per row, the tokens generated up to and including the first eos (all
    of them where there is none)."""
    is_eos = tokens[:, prompt_len:] == eos_id
    return torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
                       is_eos.shape[1])


def _spec_f32_ties(trs, feats, prompt) -> dict:
    """Spec tokens against greedy tokens in f32 with the plain versions, for
    both drafters: a row may part from greedy only at a near-tie, where
    greedy's top-2 processed logit gap lies within F32_TIE_RTOL/ATOL.
    Returns, per drafter, the rows that part, where, and their gaps."""
    from neuspeech1_tpu_torch.decode.generate import _process_logits, generate
    from neuspeech1_tpu_torch.models import whisper as tw

    greedy = trs["greedy"]
    model, gen = greedy.model, greedy.gen
    p = prompt.shape[1]
    out = {}
    with torch.no_grad(), _plain_kernels(), _f32_compute(model):
        ref = generate(model, feats, prompt, gen)
        # greedy's logits at every position, as its cached steps take them
        logits = _forced_logits(model, tw.encoder_apply(model, feats), ref, p,
                                ref.shape[1] - p - 1)
        for name in ("spec_self", "spec_table"):
            got = generate(model, feats, prompt, trs[name].gen,
                           draft_table=trs[name]._draft_table)
            parts = []
            for r in (got != ref).any(dim=1).nonzero()[:, 0].tolist():
                j = int((got[r] != ref[r]).nonzero()[0])
                scores = _process_logits(logits[r:r + 1, j - 1], ref[r:r + 1],
                                         j, gen, p, None)[0]
                top = scores.topk(2).values.tolist()
                gap, tol = top[0] - top[1], F32_TIE_ATOL + F32_TIE_RTOL * abs(
                    top[0])
                parts.append({"row": r, "generated_position": j - p,
                              "top2_gap": gap, "tie_bound": tol})
                check(gap <= tol, f"spec {name} in f32: row {r} parts from "
                      f"greedy at generated position {j - p}, where greedy's "
                      f"top-2 gap {gap} is no near-tie (bound {tol})")
            out[name] = {"rows": prompt.shape[0], "rows_parting": parts}
    return out


def phase_spec(model) -> dict:
    """Self-speculative greedy serving at full width: gamma 4, batch 16,
    128 new tokens, one request of 16 signals per reading, with the
    self-prefix drafter and with the corpus-table drafter, beside plain
    greedy, and greedy and spec with the int8 cross cache."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import generate
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.serve import Transcriber

    config, model_dir, tokenizer = model
    kw = dict(tokenizer=tokenizer, batch_size=SPEC_BATCH,
              max_new_tokens=SPEC_NEW_TOKENS, device="cuda")
    greedy = Transcriber(model_dir, **kw)
    signals = _signals(greedy.stem.in_channels,
                       4 * config.max_source_positions)[:SPEC_BATCH]
    # the table drafter's corpus: the greedy texts of the same signals, so
    # that its drafts are greedy's own continuations (full acceptance, up to
    # pairs whose followers differ between rows)
    manifest = os.path.join(os.path.dirname(model_dir), "train.jsonl")
    with open(manifest, "w") as f:
        for text in greedy.transcribe(signals):
            f.write(json.dumps({"sentence": text}) + "\n")
    spec = dict(kw, spec_gamma=SPEC_GAMMA)
    trs = {"greedy": greedy,
           "spec_self": Transcriber(model_dir, **spec),
           "spec_table": Transcriber(model_dir, spec_draft_from=manifest,
                                     **spec),
           "greedy_int8": Transcriber(model_dir, int8_kv_cache=True, **kw),
           "spec_int8": Transcriber(model_dir, int8_kv_cache=True, **spec)}
    paths = {"greedy": ("K1", "K6", "K7"), "spec_self": ("K1", "K6", "K8"),
             "spec_table": ("K1", "K6", "K8"), "greedy_int8": ("K1", "K7"),
             "spec_int8": ("K1", "K8")}
    feats = common.upload_features(greedy._prepare(signals),
                                   greedy.model.dtype, greedy.device)
    prompt = torch.as_tensor(np.repeat(greedy.prompt, SPEC_BATCH, axis=0),
                             device=greedy.device)
    p = prompt.shape[1]

    reqs, tokens = {}, {}
    for name, tr in trs.items():
        tr.transcribe(signals)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        lat = []
        with count_model_calls() as calls:
            for _ in range(SPEC_REPEATS):
                t0 = time.perf_counter()
                texts = tr.transcribe(signals)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
        launches = _kernel_counts()
        _check_serving_launches(f"spec/{name}", config, calls, launches,
                                paths[name])
        if name.startswith("spec"):
            check(launches["K7"] == 0, f"spec/{name}: K7 launched {launches}")
        if name.endswith("int8"):
            check(launches["K6"] == 0, f"spec/{name}: K6 launched on the "
                  f"int8 cache {launches}")
        check(len(texts) == SPEC_BATCH, f"{len(texts)} texts for {SPEC_BATCH}")
        # iterations (greedy: steps) per request: the cached decoder calls
        # after the prompt's prefill
        iters = calls["cached_decoder"] / SPEC_REPEATS - 1
        with torch.no_grad():
            tokens[name] = generate(tr.model, feats, prompt, tr.gen,
                                    draft_table=tr._draft_table)
        check(tuple(tokens[name].shape) == (SPEC_BATCH, tr.gen.max_length),
              f"spec/{name}: tokens shape {tuple(tokens[name].shape)}")
        check(bool(((tokens[name] >= 0)
                    & (tokens[name] < config.vocab_size)).all()),
              f"spec/{name}: token id outside the vocabulary")
        n_gen = _generated_lengths(tokens[name], p, tr.gen.eos_id).float()
        syncs = _count_syncs(lambda: tr.transcribe(signals))
        # one wait per iteration, plus a few of the request's own (the
        # upload, the tokens' copy to the host)
        check(syncs <= iters + 8,
              f"spec/{name}: {syncs} host syncs for {iters} iterations")
        med = statistics.median(lat)
        reqs[name] = {
            "request_latency_s": med, "request_latency_all_s": lat,
            "utterances_per_s": SPEC_BATCH / med,
            "utterances_per_s_all": [SPEC_BATCH / x for x in lat],
            "iterations_per_request": iters,
            "accepted_tokens_per_iteration":
                ((n_gen - 1) / iters).mean().item(),
            "ms_per_iteration": 1e3 * med / iters,
            "host_syncs_per_request": syncs, "launches": launches,
            "model_calls": calls, "sample_text": texts[0][:60]}
        emit({"phase": "spec_request", "request": name, **reqs[name]})

    profiles = {name: _profile_request(lambda: trs[name].transcribe(signals))
                for name in ("greedy", "spec_self", "spec_table")}
    with _plain_kernels():
        profiles["spec_self_plain"] = _profile_request(
            lambda: trs["spec_self"].transcribe(signals))
    for name, prof in profiles.items():
        prof["kernels_per_iteration"] = prof["kernel_launches"] / reqs[
            name.removesuffix("_plain")]["iterations_per_request"]

    # the cached decoder over forced verify iterations (with holes), K8 and
    # K6 against their plain versions, on one set of encoder states
    model_k = greedy.model
    with torch.no_grad():
        enc = tw.encoder_apply(model_k, feats)
        logits_k = _forced_verify_logits(model_k, enc, tokens["greedy"], p,
                                         SPEC_GAMMA, SPEC_FORCED_ACCEPTS)
        with _plain_kernels():
            logits_p = _forced_verify_logits(model_k, enc, tokens["greedy"],
                                             p, SPEC_GAMMA,
                                             SPEC_FORCED_ACCEPTS)
    torch.cuda.synchronize()
    ref_max = logits_p.float().abs().max().item()
    diff = (logits_k.float() - logits_p.float()).abs()
    rel = diff.max().item() / ref_max
    check(bool(torch.isfinite(logits_k.float()).all()), "non-finite logits")
    check(rel <= LOGITS_REL_TOL, f"spec: cached decoder logits with K8/K6 "
          f"{rel} of the largest logit off the plain versions")
    # bf16 with the kernels: reported, not gated (the verify step's width-4
    # GEMMs round otherwise than greedy's width-1 steps)
    agree = {"spec_self_vs_greedy": _agreement(tokens["spec_self"],
                                               tokens["greedy"], p),
             "spec_table_vs_greedy": _agreement(tokens["spec_table"],
                                                tokens["greedy"], p),
             "spec_int8_vs_greedy_int8": _agreement(
                 tokens["spec_int8"], tokens["greedy_int8"], p)}
    ties = _spec_f32_ties(trs, feats, prompt)
    check(_jax_free(), "jax or the JAX package was imported")
    out = {
        "phase": "spec", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "batch_size": SPEC_BATCH,
        "max_new_tokens": SPEC_NEW_TOKENS, "gamma": SPEC_GAMMA,
        "table_drafter": f"corpus of the greedy texts of the same "
                         f"{SPEC_BATCH} signals: the full-acceptance case",
        "requests": reqs, "profiles": profiles,
        "forced_accepts": SPEC_FORCED_ACCEPTS,
        "logits_max_abs_err": diff.max().item(),
        "logits_mean_abs_err": diff.mean().item(),
        "logits_max_abs": ref_max, "logits_rel_err": rel,
        "logits_rel_tol": LOGITS_REL_TOL,
        "token_agreement_bf16": agree, "f32_spec_vs_greedy": ties,
        "f32_tie_tol": [F32_TIE_RTOL, F32_TIE_ATOL],
        "jax_imported": not _jax_free(), "card": card(),
    }
    emit(out)
    return out


def serving_adapters(config, seed: int = 5):
    """An unmerged adapter tree on the serving model: rank 32, alpha 64, on
    encoder and decoder self-attention q/k/v/out, decoder cross-attention
    q/out, and fc1/fc2 of both stacks; A ~ N(0, 1/r), B ~ N(0,
    TRAINED_B_STD^2) (a trained magnitude, so that the adapters move the
    output), f32 on the card, from a seeded generator."""
    from neuspeech1_tpu_torch.models.lora import _entry_shapes

    gen = torch.Generator().manual_seed(seed)
    r = LORA_RANK

    def entry(d_in, d_out):
        return {"A": torch.randn((d_in, r), generator=gen) / r ** 0.5,
                "B": TRAINED_B_STD * torch.randn((r, d_out), generator=gen),
                "alpha": torch.full((1, 1), 2.0 * r)}

    tree = {}
    for part, n, ffn in (("encoder", config.encoder_layers, config.encoder_ffn),
                         ("decoder", config.decoder_layers, config.decoder_ffn)):
        layers = []
        for _ in range(n):
            layer = {name: entry(*_entry_shapes(config.d_model, ffn, name))
                     for name in ("fc1", "fc2")}
            layer["self_attn"] = {m: entry(config.d_model, config.d_model)
                                  for m in ("q", "k", "v", "out")}
            if part == "decoder":
                layer["cross_attn"] = {m: entry(config.d_model,
                                                config.d_model)
                                       for m in ("q", "out")}
            layers.append(layer)
        tree[part] = {"layers": layers}

    def to_card(node):
        if isinstance(node, dict):
            return {k: to_card(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_card(v) for v in node]
        return node.to("cuda")
    return to_card(tree)


def _bf16_ties(model, enc, tokens, tokens_p, prompt_len: int, gen,
               lora) -> dict:
    """The kernels' greedy tokens against the plain versions', in bf16 with
    adapters. The cached decoder's logits along the plain tokens, kernels
    against plain versions, must stay within LOGITS_REL_TOL of the largest
    logit at every step. A row may part from the plain tokens only at a
    near-tie: where the plain versions' processed score of their own
    token exceeds that of the kernels' token by no more than LOGITS_REL_TOL
    of that position's largest |logit|, the error the kernels are held
    to. Returns the logits error and, per parting row, where it parts and
    that gap."""
    from neuspeech1_tpu_torch.decode.generate import _process_logits

    p = prompt_len
    steps = tokens_p.shape[1] - p - 1
    logits_k = _forced_logits(model, enc, tokens_p, p, steps, lora).float()
    with _plain_kernels():
        logits_p = _forced_logits(model, enc, tokens_p, p, steps,
                                  lora).float()
    rel = ((logits_k - logits_p).abs().max().item()
           / logits_p.abs().max().item())
    check(rel <= LOGITS_REL_TOL, f"lora: cached decoder logits along the "
          f"plain tokens with the kernels {rel} of the largest logit off "
          f"the plain versions")
    parts = []
    for r in (tokens != tokens_p).any(dim=1).nonzero()[:, 0].tolist():
        j = int((tokens[r] != tokens_p[r]).nonzero()[0])
        scores = _process_logits(logits_p[r:r + 1, j - 1], tokens_p[r:r + 1],
                                 j, gen, p, None)[0]
        gap = (scores[tokens_p[r, j]] - scores[tokens[r, j]]).item()
        tol = LOGITS_REL_TOL * logits_p[r, j - 1].abs().max().item()
        parts.append({"row": r, "generated_position": j - p, "gap": gap,
                      "tie_bound": tol})
        check(gap <= tol, f"lora: row {r} parts from the plain versions at "
              f"generated position {j - p}, where the gap {gap} between "
              f"their token's score and the kernels' is no near-tie "
              f"(bound {tol})")
    return {"logits_rel_err": rel, "rows_parting": parts}


def phase_lora(model) -> dict:
    """Greedy serving with unmerged encoder and decoder adapters (the decode
    path ``bench.py`` times with ``lora=``): batch 8, 32 new tokens through
    ``generate(..., lora=)``; K1/K6/K7 launches against the model calls and
    against the same request without adapters; the cached decoder's logits
    over forced steps with the adapters, kernels against plain versions;
    tokens equal to the plain versions' up to near-ties (`_bf16_ties`); and
    that the adapters move the logits."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import generate
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.serve import Transcriber

    config, model_dir, tokenizer = model
    tr = Transcriber(model_dir, tokenizer=tokenizer, batch_size=SLICE_BATCH,
                     max_new_tokens=SLICE_NEW_TOKENS, device="cuda")
    signals = _signals(tr.stem.in_channels,
                       4 * config.max_source_positions)[:SLICE_BATCH]
    feats = common.upload_features(tr._prepare(signals), tr.model.dtype,
                                   tr.device)
    prompt = torch.as_tensor(np.repeat(tr.prompt, SLICE_BATCH, axis=0),
                             device=tr.device)
    p = prompt.shape[1]
    lora = serving_adapters(config)

    runs = {}
    with torch.no_grad():
        for name, tree in (("no_adapters", None), ("adapters", lora)):
            generate(tr.model, feats, prompt, tr.gen, lora=tree)  # warm-up
            torch.cuda.synchronize()
            _reset_counts()
            with count_model_calls() as calls:
                t0 = time.perf_counter()
                tokens = generate(tr.model, feats, prompt, tr.gen, lora=tree)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = _kernel_counts()
            _check_serving_launches(f"lora/{name}", config, calls, launches)
            runs[name] = {"tokens": tokens, "launches": launches,
                          "model_calls": dict(calls), "latency_s": wall}
        if runs["adapters"]["model_calls"] == runs["no_adapters"]["model_calls"]:
            check(runs["adapters"]["launches"] == runs["no_adapters"]["launches"],
                  f"lora: adapters changed the kernel launches {runs}")
        tokens = runs["adapters"]["tokens"]
        with _plain_kernels():
            tokens_p = generate(tr.model, feats, prompt, tr.gen, lora=lora)
        enc = tw.encoder_apply(tr.model, feats, lora)
        logits_k = _forced_logits(tr.model, enc, tokens, p, LORA_FORCED_STEPS,
                                  lora)
        with _plain_kernels():
            logits_p = _forced_logits(tr.model, enc, tokens, p,
                                      LORA_FORCED_STEPS, lora)
        logits_bare = _forced_logits(tr.model, enc, tokens, p,
                                     LORA_FORCED_STEPS)
        ties = _bf16_ties(tr.model, enc, tokens, tokens_p, p, tr.gen, lora)
    torch.cuda.synchronize()
    ref_max = logits_p.float().abs().max().item()
    rel = (logits_k.float() - logits_p.float()).abs().max().item() / ref_max
    moved = (logits_bare.float() - logits_k.float()).abs().max().item() / ref_max
    check(bool(torch.isfinite(logits_k.float()).all()), "lora: non-finite logits")
    check(rel <= LOGITS_REL_TOL, f"lora: cached decoder logits with the "
          f"kernels {rel} of the largest logit off the plain versions")
    check(moved > LOGITS_REL_TOL, f"lora: the decoder adapters moved the "
          f"logits by only {moved} of the largest")
    check(tuple(tokens.shape) == (SLICE_BATCH, tr.gen.max_length),
          f"lora: tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < config.vocab_size)).all()),
          "lora: token id outside the vocabulary")
    check(_jax_free(), "jax or the JAX package was imported")
    out = {
        "phase": "lora", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "lora_rank": LORA_RANK,
        "lora_b_std": TRAINED_B_STD, "batch_size": SLICE_BATCH,
        "max_new_tokens": SLICE_NEW_TOKENS,
        "launches": runs["adapters"]["launches"],
        "launches_no_adapters": runs["no_adapters"]["launches"],
        "model_calls": runs["adapters"]["model_calls"],
        "latency_s": runs["adapters"]["latency_s"],
        "latency_no_adapters_s": runs["no_adapters"]["latency_s"],
        "forced_steps": LORA_FORCED_STEPS, "logits_rel_err": rel,
        "logits_rel_tol": LOGITS_REL_TOL, "adapters_moved_logits_rel": moved,
        "token_agreement_vs_plain": _agreement(tokens, tokens_p, p),
        "plain_tokens_logits_rel_err": ties["logits_rel_err"],
        "rows_parting_from_plain": ties["rows_parting"],
        "token_agreement_vs_no_adapters": _agreement(
            tokens, runs["no_adapters"]["tokens"], p),
        "jax_imported": not _jax_free(), "card": card(),
    }
    emit(out)
    return out


def _eval_corpus(tmp: str, vocab_size: int):
    """The eval phase's corpus (``data/synthetic.py``, EVAL_CLIPS clips of
    2-10 s over 208 channels) and a word vocabulary of ``vocab_size``
    words whose first entries are the corpus's words, so that its labels
    tokenize: (corpus dir, tokenizer spec)."""
    from neuspeech1_tpu_torch.data.synthetic import _WORDS, make_synthetic_corpus

    root = os.path.join(tmp, "eval_corpus")
    make_synthetic_corpus(root, n_clips=EVAL_CLIPS, n_channels=208,
                          min_dur=EVAL_DURATION_S[0],
                          max_dur=EVAL_DURATION_S[1], seed=0,
                          with_audio=False)
    vocab = os.path.join(tmp, "eval_vocab.txt")
    words = list(_WORDS) + [f"w{i}" for i in range(len(_WORDS), vocab_size)]
    with open(vocab, "w") as f:
        f.write("\n".join(words) + "\n")
    return root, f"word:{vocab}"


def _run_eval(argv) -> dict:
    """``cli.evaluation.main(argv)`` in process: its metrics, the phase
    timing it prints (seconds, to 0.01), its wall time and its output
    lines."""
    import ast
    import io

    from neuspeech1_tpu_torch.cli import evaluation

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        metrics = evaluation.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    timing = next(ast.literal_eval(ln.split("timing ", 1)[1])
                  for ln in lines if ln.startswith("[evaluation] timing "))
    return {"metrics": metrics, "timing": timing, "wall_s": wall,
            "lines": [ln for ln in lines if ln.startswith("[evaluation]")]}


@contextlib.contextmanager
def _native_loader_off():
    """The eval CLI with the Python clip reader: ``native_available`` (read
    when ``main`` runs) answers False."""
    from neuspeech1_tpu_torch.data import native_loader

    real = native_loader.native_available
    native_loader.native_available = lambda: False
    try:
        yield
    finally:
        native_loader.native_available = real


def _result_files(out_dir: str) -> dict:
    return {name: open(os.path.join(out_dir, name), "rb").read()
            for name in sorted(os.listdir(out_dir))}


def _direct_preds(model_dir, tokenizer_spec, manifest, device) -> list:
    """The CLI's decode without the CLI: the same dataset, collator and
    loader, each batch padded to EVAL_BATCH rows as the CLI pads it, then
    ``generate`` and ``batch_decode``."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import EEGDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      generate)

    params, config, stem = common.load_full_model(model_dir)
    tok = common.resolve_tokenizer(tokenizer_spec, config)
    model = common.commit_params(params, config, stem, device)
    ds = EEGDataset(manifest, tok, mode="test", modal_ch=208,
                    language="English", max_duration=30.0)
    loader = DataLoader(ds, Collator(pad_id=tok.pad_id,
                                     decoder_start_id=config.sot_id,
                                     max_label_len=128,
                                     eot_id=config.eot_id),
                        EVAL_BATCH, shuffle=False, drop_last=False)
    prompt = np.asarray([tok.prefix_tokens("English", "transcribe")])
    gen = GenerationConfig.for_model(
        config, max_length=prompt.shape[1] + EVAL_NEW_TOKENS,
        **BEAM_SETTINGS, **common.suppress_kwargs("default", tok))
    preds = []
    with torch.no_grad():
        for batch in loader:
            feats = batch["input_features"]
            b = feats.shape[0]
            feats = np.concatenate(
                [feats, np.repeat(feats[-1:], EVAL_BATCH - b, axis=0)])
            out = generate(model, common.upload_features(feats, model.dtype,
                                                         device),
                           torch.as_tensor(np.repeat(prompt, EVAL_BATCH, 0),
                                           device=device), gen)
            preds.extend(tok.batch_decode(out.cpu().numpy()[:b]))
    return preds


def _check_sequence_bias(train_manifest, tokenizer_spec, config,
                         beam_ms_per_step, device) -> dict:
    """``decode/logits_process.py::sequence_bias`` (plain PyTorch, run on
    every beam step of a biased decode) at the beam step's shape: the same
    bits on the card as on the CPU for the CLI's spec and for one whose
    sums round, and its ms per call beside the beam step's."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.logits_process import (SequenceBiasSpec,
                                                            sequence_bias)
    from neuspeech1_tpu_torch.data.synthetic import _WORDS
    from neuspeech1_tpu_torch.decode.sequence_bias import build_sequence_bias

    tok = common.resolve_tokenizer(tokenizer_spec, config)
    spec = build_sequence_bias(train_manifest, tok, bias=EVAL_BIAS_WEIGHTS[0])
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((EVAL_BIAS_ROWS, config.vocab_size), generator=gen)
    # token ids of the corpus's words (the vocabulary's first entries)
    tokens = torch.randint(0, len(_WORDS),
                           (EVAL_BIAS_ROWS, 4 + EVAL_NEW_TOKENS),
                           generator=gen)
    out = {"entries": int(spec.seqs.shape[0]),
           "max_entry_len": int(spec.seqs.shape[1])}
    for weight in EVAL_BIAS_WEIGHTS:
        s = SequenceBiasSpec.build({
            tuple(x for x in row if x >= 0): weight
            for row in spec.seqs.tolist()})
        cpu = sequence_bias(logits, tokens, EVAL_BIAS_CUR_LEN, s)
        dev_logits, dev_tokens = logits.to(device), tokens.to(device)
        card_out = sequence_bias(dev_logits, dev_tokens, EVAL_BIAS_CUR_LEN, s)
        torch.cuda.synchronize()
        moved = int((cpu != logits).sum())
        same = bool(torch.equal(cpu, card_out.cpu()))
        check(moved > 0, f"eval: sequence bias {weight} moved no score")
        check(same, f"eval: sequence_bias {weight}: card and CPU bits differ")
        out[f"bias_{weight}"] = {
            "scores_moved": moved, "same_bits_card_cpu": same,
            "ordered_sum": s.tables("cpu")[-1] is not None,
            "ms": cuda_ms(lambda: sequence_bias(
                dev_logits, dev_tokens, EVAL_BIAS_CUR_LEN, s))}
    out["beam_ms_per_step"] = beam_ms_per_step
    return out


def phase_eval(model, bm, device: str = "cuda") -> dict:
    """The eval CLI (``neuspeech1_tpu_torch.cli.evaluation``) in process at
    whisper-base width: a manifest of EVAL_CLIPS synthetic clips, the CLI's
    defaults (beam 5, repetition penalty 5.0, no-repeat-ngram 2, batch 16,
    128 new tokens) at ``--pipeline_depth 2`` with ``--per_sentence`` and
    ``--timing``. Checks K1/K6/K7 launches against the model calls, that the
    predictions equal ``generate`` on the same batches, that depth 1 writes
    the same files, that a ``--sequence_bias`` run finishes, and that
    ``sequence_bias`` gives the same bits on the card as on the CPU."""
    from neuspeech1_tpu_torch.data.native_loader import native_available
    from neuspeech1_tpu_torch.metrics import meteor

    config, model_dir, _ = model
    tmp = os.path.dirname(model_dir)
    corpus, tokenizer = _eval_corpus(tmp, config.eot_id)
    manifest = os.path.join(corpus, "all.jsonl")
    base = [f"--test_data={manifest}", f"--model_path={model_dir}",
            f"--tokenizer={tokenizer}", "--eeg_ch=208",
            f"--batch_size={EVAL_BATCH}",
            f"--max_new_tokens={EVAL_NEW_TOKENS}", "--per_sentence=True",
            "--timing=True", f"--device={device}"]
    out_dirs = {d: os.path.join(tmp, f"eval_out_depth{d}") for d in (2, 1)}

    _reset_counts()
    with count_model_calls() as calls:
        run = _run_eval(base + ["--pipeline_depth=2",
                                f"--output_dir={out_dirs[2]}"])
    launches = _kernel_counts()
    _check_serving_launches("eval", config, calls, launches)
    files = _result_files(out_dirs[2])
    rows = [json.loads(ln) for ln in
            files["all_beam5.jsonl"].decode().splitlines()]
    check(len(rows) == EVAL_CLIPS, f"eval: {len(rows)} rows for "
          f"{EVAL_CLIPS} clips")
    check(set(files) == {"all_beam5.txt", "all_beam5.jsonl",
                         "all_beam5.json", "all_beam5_per_sentence.jsonl"},
          f"eval: result files {sorted(files)}")
    metrics = run["metrics"]
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"eval: non-finite metric {metrics}")
    check(all(r["label"] for r in rows), "eval: a label did not tokenize")

    depth1 = _run_eval(base + ["--pipeline_depth=1",
                               f"--output_dir={out_dirs[1]}"])
    check(_result_files(out_dirs[1]) == files,
          "eval: --pipeline_depth 1 wrote other files than depth 2")
    py_dir = os.path.join(tmp, "eval_out_python_loader")
    with _native_loader_off():
        py_loader = _run_eval(base + ["--pipeline_depth=2",
                                      f"--output_dir={py_dir}"])
    check(any(ln == "[evaluation] native loader: False"
              for ln in py_loader["lines"]),
          "eval: the native clip reader ran when switched off")
    check(_result_files(py_dir) == files,
          "eval: the Python clip reader wrote other files than the native")
    direct = _direct_preds(model_dir, tokenizer, manifest, device)
    check([r["pred"] for r in rows] == direct,
          "eval: the CLI's predictions differ from generate's on the same "
          "batches")
    train = os.path.join(corpus, "train.jsonl")
    biased = _run_eval(base + ["--sequence_bias=True",
                               f"--train_data={train}",
                               f"--output_dir={os.path.join(tmp, 'eval_bias')}"])
    bias = _check_sequence_bias(train, tokenizer, config,
                                bm["ms_per_step"], device)
    check(_jax_free(), "jax or the JAX package was imported")
    timing = run["timing"]
    out = {
        "phase": "eval", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "clips": EVAL_CLIPS, "batch_size": EVAL_BATCH,
        "max_new_tokens": EVAL_NEW_TOKENS, **BEAM_SETTINGS,
        "timing_s": timing, "wall_s": run["wall_s"],
        "utterances_per_s_decode": EVAL_CLIPS / timing["decode"],
        "utterances_per_s_end_to_end": EVAL_CLIPS / timing["total"],
        "depth1_timing_s": depth1["timing"], "depth1_wall_s": depth1["wall_s"],
        "depth1_same_files": True,
        "python_loader_timing_s": py_loader["timing"],
        "python_loader_same_files": True,
        "bias_run_timing_s": biased["timing"],
        # the biased decode phase over the median of the three unbiased
        # runs' in this call
        "bias_decode_ratio": biased["timing"]["decode"] / sorted(
            r["timing"]["decode"] for r in (run, depth1, py_loader))[1],
        "native_loader": native_available(),
        "metrics": metrics, "meteor_stages": meteor.stages(),
        "launches": launches, "model_calls": calls,
        "preds_equal_generate": True, "sequence_bias": bias,
        "sample_pred": rows[0]["pred"][:80], "card": card(),
    }
    emit(out)
    return out


def _probe_variants():
    """Every variant of the TPU probes' sweeps, through the port's probe
    entry points (``neuspeech1_tpu_torch/perf``): dicts of the JAX tag, the
    kernel, the `pallas_call` it replaces, ``make(t_valid)`` -> run, and
    what its plain version and library call take."""
    from neuspeech1_tpu_torch.perf import btc_probe as bp
    from neuspeech1_tpu_torch.perf import bwd_probe as wp
    from neuspeech1_tpu_torch.perf import kernel_probe as kp
    from neuspeech1_tpu_torch.perf import mxu_probe as mp

    out = []

    def fwd(tag, replaces, make, mode="base", n_kb=1, btc=False):
        out.append(dict(tag=tag, kernel="probe_fwd", replaces=replaces,
                        make=make, mode=mode, n_kb=n_kb, btc=btc,
                        library="sdpa" if mode == "base" else None))

    for bq in (256, 512):
        for mode in kp.MODES:
            fwd(f"{mode}_bq{bq}", "perf/kernel_probe.py:43",
                functools.partial(kp.make_kernel, mode, bq), mode=mode)
    for n_kb in (2, 4):
        fwd(f"online_bq512_kb{n_kb}", "perf/kernel_probe.py:117",
            functools.partial(kp.make_online, 512, n_kb), n_kb=n_kb)
    for sem in (("parallel", "parallel"), ("parallel", "arbitrary")):
        for bq in (512, 256):
            fwd(f"sem_{'_'.join(sem)}_bq{bq}", "perf/kernel_probe.py:178",
                functools.partial(kp.make_semantics, bq, sem))
    for n_sub in (1, 2, 4):
        fwd(f"fwd_bq512_sub{n_sub}", "perf/mxu_probe.py:126",
            functools.partial(mp.make_fwd, 512, n_sub))
    for bq in (512, 256):
        fwd(f"fwd_btc_bq{bq}", "perf/btc_probe.py:53",
            functools.partial(bp.make_fwd_btc, bq), btc=True)
    for sem in bp.SEMS:
        fwd(f"fwd_sem_{'_'.join(x[:3] for x in sem)}", "perf/btc_probe.py:245",
            functools.partial(bp.make_fwd_btc_sem, 512, sem), btc=True)
    for bq in (256, 512):
        for bf16_ops in (False, True):
            ops = "bf16" if bf16_ops else "f32"
            out.append(dict(
                tag=f"bwd_bq{bq}_{ops}ops", kernel="probe_bwd",
                replaces="perf/bwd_probe.py:98", ops=ops, btc=False,
                make=functools.partial(wp.make_bwd, bq, bf16_ops=bf16_ops),
                library="sdpa_bwd" if bf16_ops else None))
    for bq in (512, 256, 192):
        out.append(dict(tag=f"bwd_btc_bq{bq}", kernel="probe_bwd",
                        replaces="perf/btc_probe.py:132", ops="f32", btc=True,
                        make=functools.partial(bp.make_bwd_btc, bq),
                        library=None))
    for kdim in (64, 128, 256, 512):
        out.append(dict(tag=f"dot_k{kdim}", kernel="probe_dot",
                        replaces="perf/mxu_probe.py:48", kdim=kdim,
                        make=functools.partial(mp.make_dot, kdim),
                        library="bmm"))
    return out


def _probe_arrays(v, gen, bh: int):
    """Inputs of one variant at ``bh`` heads (B = bh / 8 in the [B, T, H*D]
    layout), N(0, 1) bf16, lse ~ N(8, 0.1^2) for the backward, and
    (n_grid = bh / 2) for the dot."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    if v["kernel"] == "probe_dot":
        n = max(1, bh // 2)
        return (rnd(n, PROBE_DOT_M, v["kdim"]), rnd(n, v["kdim"], PROBE_TK))
    shape = ((max(1, bh // PROBE_H), PROBE_TK, PROBE_H * PROBE_D) if v["btc"]
             else (bh, PROBE_TK, PROBE_D))
    if v["kernel"] == "probe_fwd":
        return tuple(rnd(*shape) for _ in range(3))
    lse_shape = ((shape[0], PROBE_H, PROBE_TK) if v["btc"]
                 else (bh, PROBE_TK))
    lse = 8.0 + 0.1 * torch.randn(lse_shape, generator=gen, device="cuda")
    return tuple(rnd(*shape) for _ in range(5)) + (lse,)


def _probe_plain(v, args):
    from neuspeech1_tpu_torch.ops import probe_bwd, probe_dot, probe_fwd

    if v["kernel"] == "probe_dot":
        return (probe_dot.probe_dot_plain(*args),)
    if v["kernel"] == "probe_bwd":
        return probe_bwd.probe_bwd_plain(*args, PROBE_T, v["ops"], v["btc"])
    o, lse = probe_fwd.probe_fwd_plain(*args, PROBE_T, v["mode"], v["n_kb"],
                                       v["btc"])
    return (o, lse) if v["btc"] else (o,)


def _probe_library(v, args):
    """One PyTorch call of the same function, or None: SDPA with the key
    mask (forward; its autograd backward for the bf16 backward, which
    recomputes its own lse: timed only), ``torch.bmm`` for the dot."""
    import torch.nn.functional as F

    if v["library"] == "bmm":
        return lambda: torch.bmm(*args)
    if v["library"] is None:
        return None
    q, k, v_ = args[:3]
    if v["btc"]:
        b, t, c = q.shape
        q, k, v_ = (x.view(b, t, c // PROBE_D, PROBE_D).transpose(1, 2)
                    .contiguous() for x in (q, k, v_))
    else:
        q, k, v_ = (x.unsqueeze(1) for x in (q, k, v_))
    mask = (torch.arange(PROBE_TK, device="cuda") < PROBE_T).view(1, 1, 1, -1)
    if v["library"] == "sdpa":
        return lambda: F.scaled_dot_product_attention(q, k, v_,
                                                      attn_mask=mask)
    q, k, v_ = (x.detach().requires_grad_() for x in (q, k, v_))
    o = F.scaled_dot_product_attention(q, k, v_, attn_mask=mask)
    do = torch.randn_like(o)
    return lambda: torch.autograd.grad(o, (q, k, v_), do, retain_graph=True)


def _probe_cost(v, args):
    """(bytes, operations, peak) of one call: each input read once, each
    output written once; the products over the kept key columns."""
    if v["kernel"] == "probe_dot":
        a, b = args
        n, m, kd = a.shape
        width = b.shape[2]
        return 2 * n * (m * kd + kd * width + m * width), \
            2 * n * m * kd * width, BF16_FLOPS
    n_heads_rows = args[0].numel() // PROBE_D   # (B*H) * TK
    kept = PROBE_TK if v.get("mode") == "nomask" else PROBE_T
    if v["kernel"] == "probe_fwd":
        n_bytes = 4 * args[0].numel() * 2 + (4 * n_heads_rows if v["btc"]
                                             else 0)
        return n_bytes, 4 * n_heads_rows * kept * PROBE_D, BF16_FLOPS
    n_bytes = 8 * args[0].numel() * 2 + 4 * n_heads_rows
    return n_bytes, 10 * n_heads_rows * kept * PROBE_D, (
        BF16_FLOPS if v["ops"] == "bf16" else F32_FLOPS)


def _probe_err(v, got, ref) -> float:
    """The largest error over the outputs: of the largest |value| for the
    bf16 outputs, absolute for lse (f32)."""
    errs = []
    for g, r in zip(got, ref):
        if g.dtype == torch.float32:
            errs.append((g - r).abs().max().item())
        else:
            errs.append(_rel_err(g, r))
    return max(errs)


def phase_probes() -> dict:
    """The perf entry points: every variant of the TPU probes' sweeps (the
    port's ``perf/*`` make_* functions) first held against its plain
    version at full TK and a reduced B*H (a quick pre-check), then run at
    the probe's own shape: one call held against the plain version on the
    same inputs, then timed beside its bound, the plain version and the
    library call. The launches of probe_fwd, probe_bwd and probe_dot are
    counted over that full-shape sweep alone."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    variants = _probe_variants()

    def make(v, n_grid):
        return (v["make"](n_grid) if v["kernel"] == "probe_dot"
                else v["make"](t_valid=PROBE_T))

    def checked(v, run, args, where):
        """The kernel's outputs against the plain version's on ``args``."""
        got = run(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = _probe_plain(v, args)
        torch.cuda.synchronize()
        tol = PROBE_TOL[v["kernel"] if v["kernel"] != "probe_bwd"
                        else f"probe_bwd_{v['ops']}"]
        err = _probe_err(v, got, ref)
        check(all(bool(torch.isfinite(g.float()).all()) or v.get("mode") ==
                  "noexp" for g in got),
              f"probe {v['tag']} ({where}): non-finite output")
        check(err <= tol, f"probe {v['tag']} ({where}): kernel {err} off its "
              f"plain version (bound {tol})")
        return err, tol

    for v in variants:
        checked(v, make(v, PROBE_DOT_CHECK_GRID),
                _probe_arrays(v, gen, PROBE_CHECK_BH), "reduced")

    lines = []
    _reset_counts()
    for v in variants:
        args = _probe_arrays(v, gen, PROBE_BH)
        run = make(v, PROBE_DOT_GRID)
        err, tol = checked(v, run, args, "full shape")
        torch.cuda.empty_cache()
        lib = _probe_library(v, args)
        n_bytes, flops, peak = _probe_cost(v, args)
        res = {"phase": "probes", "k": v["tag"], "kernel": v["kernel"],
               "replaces": v["replaces"], "max_abs_err": err, "tol": tol,
               "ms": cuda_ms(lambda: run(*args), iters=PROBE_ITERS,
                             warmup=PROBE_WARMUP),
               "plain_ms": cuda_ms(lambda: _probe_plain(v, args), iters=3,
                                   warmup=1),
               "library_ms": None if lib is None else cuda_ms(lib),
               **bound(n_bytes, flops, peak)}
        emit(res)
        lines.append(res)
        del args, lib
        torch.cuda.empty_cache()
    launches = _probe_counts()
    per_variant = 1 + PROBE_WARMUP + PROBE_ITERS
    check(all(n > 0 for n in launches.values()),
          f"probes: a kernel of the perf path never launched: {launches}")
    check(launches == {k: per_variant * sum(v["kernel"] == k
                                            for v in variants)
                       for k in launches},
          f"probes: launches {launches} against {len(variants)} variants "
          f"x {per_variant} calls")

    # the TPU probe's two library yardsticks: two batched products with a
    # bf16 score tensor (xla_batched_2dots) and a library flash kernel
    # (official_tuned), at the forward's shape
    fwd = next(v for v in variants if v["tag"] == "base_bq512")
    q, k, v_ = _probe_arrays(fwd, gen, PROBE_BH)
    for tag, fn in (
            ("xla_batched_2dots",
             lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v_)),
            ("official_tuned", _probe_library(fwd, (q, k, v_)))):
        res = {"phase": "probes", "k": tag, "kernel": None,
               "library_ms": cuda_ms(fn)}
        emit(res)
        lines.append(res)
    del q, k, v_
    torch.cuda.empty_cache()
    check(_jax_free(), "jax or the JAX package was imported")
    out = {"phase": "probes", "variants": len(variants), "launches": launches,
           "card": card()}
    emit(out)
    return {**out, "lines": lines}


def phase_bench() -> dict:
    """``neuspeech1_tpu_torch.bench`` once, in process: its JSON line
    (training samples/s and mfu, greedy decode tokens/s with the trained,
    unmerged adapters, int8 and bf16 cross caches), with the kernels'
    launches over the whole run. Its decode's K6 and K7 shapes (batch 64,
    4 prompt + 48 new tokens) are held against the plain versions in the
    kernels phase (the ``bench_*`` cases)."""
    from neuspeech1_tpu_torch import bench
    from neuspeech1_tpu_torch.cli import common

    config, stem = common.preset_model("base", "base", in_channels=208)
    _reset_counts()
    res = bench.run(config, stem)
    launches = _kernel_counts()
    torch.cuda.synchronize()
    for key in ("value", "train_step_ms", "mfu", "decode_tokens_per_sec",
                "decode_fp_tokens_per_sec", "decode_e2e_tokens_per_sec"):
        check(isinstance(res[key], float) and math.isfinite(res[key])
              and res[key] > 0, f"bench: {key} = {res[key]}")
    check(res["remat"] is False, f"bench: remat {res['remat']}")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K6", "K7")),
          f"bench: a kernel of its path never launched: {launches}")
    print(json.dumps(res), flush=True)
    out = {"phase": "bench", "launches": launches,
           "jax_imported": not _jax_free(), "card": card()}
    emit(out)
    check(_jax_free(), "jax or the JAX package was imported")
    return {**out, "result": res}


def _train_setup(batch_size: int, device: str = "cuda",
                 seq_parallel_axis=None):
    """The bench configuration on the card: whisper-base with the 'base'
    stem over 208 channels, f32 masters computing in bf16, LoRA r=32 alpha=64
    on encoder q/k/v/out/fc1/fc2 from seeds, AdamW with warmup, and a
    synthetic batch from a seeded numpy generator (bench.py's recipe);
    with ``seq_parallel_axis`` the encoder's self-attention runs the ring
    over that axis of the ambient mesh."""
    import dataclasses

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    config, stem = common.preset_model("base", "base", in_channels=208)
    config = dataclasses.replace(config, seq_parallel_axis=seq_parallel_axis)
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
    from neuspeech1_tpu_torch.ops import decode_cross as dc
    from neuspeech1_tpu_torch.ops import decode_step as ds
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    return {"K1": fa.launches, "K2": fa.bwd_launches, "K3": lb.launches,
            "K4": fa.bias_launches, "K4_bwd": fa.bias_bwd_launches,
            "K6": dc.launches, "K7": ds.launches, "K8": ds.multi_launches}


def _probe_counts():
    from neuspeech1_tpu_torch.ops import probe_bwd, probe_dot, probe_fwd

    return {"probe_fwd": probe_fwd.launches, "probe_bwd": probe_bwd.launches,
            "probe_dot": probe_dot.launches}


def _reset_counts():
    from neuspeech1_tpu_torch.ops import decode_cross as dc
    from neuspeech1_tpu_torch.ops import decode_step as ds
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb
    from neuspeech1_tpu_torch.ops import probe_bwd, probe_dot, probe_fwd

    fa.launches = fa.bwd_launches = lb.launches = 0
    fa.bias_launches = fa.bias_bwd_launches = 0
    dc.launches = ds.launches = ds.multi_launches = 0
    probe_fwd.launches = probe_bwd.launches = probe_dot.launches = 0


def _adapter_b_max(frozen) -> float:
    from neuspeech1_tpu_torch.models.lora import entries

    return max(e["B"].abs().max().item() for _, e in entries(frozen.lora))


@contextlib.contextmanager
def _plain_kernels():
    """Every CUDA kernel wrapper of the serving and training paths replaced
    by its plain version while the context is open (a swap for comparison
    only)."""
    from neuspeech1_tpu_torch.ops import decode_cross as dc
    from neuspeech1_tpu_torch.ops import decode_step as ds
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    swaps = [
        (fa, "_flash_fwd_cuda",
         lambda q, k, v, causal, kv_len: fa.flash_attention_bthd_plain(
             q, k, v, causal, kv_len, return_lse=True)),
        (fa, "_flash_bwd_cuda", fa.flash_attention_bthd_bwd_plain),
        (fa, "_flash_bias_fwd_cuda", fa.flash_bias_fwd_plain),
        (fa, "_flash_bias_bwd_cuda", fa.flash_bias_bwd_plain),
        (lb, "_lora_bwd_cuda", lb.lora_adapter_bwd_plain),
        (dc, "_decode_cross_cuda", dc.decode_cross_plain),
        (ds, "_decode_step_cuda", ds.decode_step_plain),
        (ds, "_decode_step_multi_cuda", ds.decode_step_multi_plain),
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
def _replaced_config(model, **changes):
    """The model with its config's ``changes`` while the context is open."""
    import dataclasses

    config = model.config
    model.config = dataclasses.replace(config, **changes)
    try:
        yield
    finally:
        model.config = config


def _f32_compute(model):
    """The model computing in f32 with plain attention while the context is
    open (its masters are f32 already): the reference of the gradient
    checks. Run it under `_plain_kernels`, since K3 takes bf16 only."""
    return _replaced_config(model, dtype="float32", flash_attention="off")


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
    check(not any(_kernel_counts().values()),
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
    expect = {"K1": 2 * n_layers, "K2": 2 * n_layers, "K3": 2 * n_layers,
              "K4": 0, "K4_bwd": 0, "K6": 0, "K7": 0, "K8": 0}

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
    check(_jax_free(), "jax or the JAX package was imported")
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
        "jax_imported": not _jax_free(), "card": card(),
    }
    emit(out)
    return out


@contextlib.contextmanager
def _one_rank_mesh():
    """A one-rank NCCL process group (a FileStore in a temp dir) and a
    (data 1, seq 1) DeviceMesh over it, ambient while the context is open;
    the group is destroyed at exit."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh

    with tempfile.TemporaryDirectory() as tmp:
        pmesh.initialize_distributed(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh("cuda", data=1, seq=1)
            with pmesh.set_mesh(mesh):
                yield mesh
        finally:
            dist.destroy_process_group()


def phase_train_profile(trace_dir=None, seq_parallel: bool = False) -> dict:
    """Where the training step's time goes: CUDA events around forward
    (loss), backward and the optimizer over a few steps, then the device's
    busy and idle share under torch.profiler. Prints one JSON line and
    writes the chrome trace into ``trace_dir`` when one is given. With
    ``seq_parallel``, the step of the ring phase (``seq_parallel_axis``
    over a one-rank NCCL group)."""
    if seq_parallel:
        with _one_rank_mesh():
            return _train_profile(trace_dir, "seq")
    return _train_profile(trace_dir, None)


def _train_profile(trace_dir, seq_parallel_axis) -> dict:
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.train.optimizer import global_norm
    from neuspeech1_tpu_torch.train.trainstep import (
        make_loss_fn, sum_seq_sharded_grads)

    config, tx, state, frozen, step, batch = _train_setup(
        TRAIN_BATCH, seq_parallel_axis=seq_parallel_axis)
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
        if seq_parallel_axis is not None:
            grads = sum_seq_sharded_grads(
                grads, pmesh.axis_ring(seq_parallel_axis))
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
        name = "sp_" if seq_parallel_axis else ""
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"{name}train_step_trace.json"))
    out = {
        "phase": "train_profile", "batch_size": TRAIN_BATCH,
        "seq_parallel_axis": seq_parallel_axis,
        "events_ms_median": {k: statistics.median(v)
                             for k, v in phases.items()},
        "events_ms_all": phases,
        "profiled_steps": PROFILE_TRACED_STEPS, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        # K3's launches (the one-pass kernel and its reduce, or the wide
        # path's) per step
        "k3_device_ms_per_step": sum(
            e.self_device_time_total for e in kernels
            if "lora_" in e.key) / 1e3 / PROFILE_TRACED_STEPS,
        "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3,
                            e.count] for e in top],
        "card": card(),
    }
    emit(out)
    return out


def _local_ring(gen, kv_valid_len: int) -> dict:
    """Ring attention over a LocalRing of RING_N threads on the card at
    whisper-base widths, each rank calling the ring's forward and backward
    bodies on its shard (CUDA autograd runs every backward on one worker
    thread per device, where the ranks' waits in permute would deadlock),
    against K1/K2 on the whole sequence with kv_len = kv_valid_len."""
    from neuspeech1_tpu_torch.ops import flash_attention as fa
    from neuspeech1_tpu_torch.parallel.ring_attention import (
        LocalRing, ring_bwd, ring_fwd, shard_bias)

    b, t, h, d = RING_BATCH, RING_T, DECODE_HEADS, DECODE_HEAD_DIM
    q, k, v, do = (_bthd(gen, b, t, h, d) for _ in range(4))
    t_loc = t // RING_N

    def rank(ring):
        rows = slice(ring.rank * t_loc, (ring.rank + 1) * t_loc)
        ql, kl, vl, dol = (x[:, rows] for x in (q, k, v, do))
        bias = shard_bias(t_loc, ring.rank, kv_valid_len, q.device)
        o, lse = ring_fwd(ql, kl, vl, bias, ring)
        return (o, *ring_bwd(ql, kl, vl, bias, o, lse, dol, ring))

    _reset_counts()
    t0 = time.perf_counter()
    parts = LocalRing.run(rank, RING_N)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _kernel_counts()
    o, dq, dk, dv = (torch.cat([p[i] for p in parts], 1) for i in range(4))
    o_ref, lse_ref = fa.flash_attention_bthd(q, k, v, kv_len=kv_valid_len,
                                             return_lse=True)
    refs = fa._flash_bwd_cuda(q, k, v, o_ref, do, lse_ref, False,
                              kv_valid_len)
    torch.cuda.synchronize()
    o_err = (o.float() - o_ref.float()).abs().max().item()
    errs = {f"{n}_rel_err": _rel_err(g, r)
            for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
    res = {"phase": "ring", "part": "local_ring", "ranks": RING_N,
           "shape": [b, t, h, d], "kv_valid_len": kv_valid_len,
           "fully_masked_shards": RING_N - -(-kv_valid_len // t_loc),
           "launches": {"K4": counts["K4"], "K4_bwd": counts["K4_bwd"]},
           "o_max_abs_err": o_err, **errs, "o_tol": RING_O_TOL,
           "rel_tol": RING_GRAD_REL_TOL, "seconds": seconds}
    emit(res)
    check(counts["K4"] == RING_N ** 2 and counts["K4_bwd"] == RING_N ** 2,
          f"LocalRing({RING_N}): K4 launches {counts}, expected "
          f"{RING_N ** 2} forward and backward")
    check(all(torch.isfinite(x.float()).all() for x in (o, dq, dk, dv)),
          f"LocalRing({RING_N}) kv_valid_len {kv_valid_len}: non-finite")
    check(not dk[:, kv_valid_len:].any() and not dv[:, kv_valid_len:].any(),
          "ring: dk/dv of masked keys are not 0")
    check(o_err <= RING_O_TOL and max(errs.values()) <= RING_GRAD_REL_TOL,
          f"LocalRing({RING_N}) kv_valid_len {kv_valid_len}: ring disagrees "
          "with K1/K2 on the whole sequence")
    return res


def _sp_train_step(tr) -> dict:
    """The training step with ``seq_parallel_axis='seq'`` over a one-rank
    NCCL group and a (data 1, seq 1) DeviceMesh: launches per step, the
    schedule's first steps, ms per step and samples/s beside the train
    phase's; then one step's loss and gradients against the non-SP kernel
    step on the same weights."""
    from neuspeech1_tpu_torch.models.lora import entries
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.train.trainstep import make_loss_fn

    with _one_rank_mesh() as mesh:
        config, _, state, frozen, step, batch = _train_setup(
            TRAIN_BATCH, seq_parallel_axis="seq")
        stem = frozen.model.stem_config
        # the encoder's self-attention on K4, the decoder's cross-attention
        # on K1/K2, the fc adapters on K3
        n_layers = config.encoder_layers
        expect = {"K1": n_layers, "K2": n_layers, "K3": 2 * n_layers,
                  "K4": n_layers, "K4_bwd": n_layers, "K6": 0, "K7": 0,
                  "K8": 0}
        check(pmesh.axis_ring("seq").size == 1
              and pmesh.local_mesh_info(mesh)["process_count"] == 1,
              "the SP mesh is not one rank")

        def run_step():
            _reset_counts()
            t0 = time.perf_counter()
            m = step(state, frozen, batch)
            loss = float(m["loss"])  # a device -> host copy: the step ran
            seconds = time.perf_counter() - t0
            counts = _kernel_counts()
            check(counts == expect, f"SP step launches {counts}, expected "
                  f"{expect}")
            check(math.isfinite(loss) and float(m["grad_norm"]) > 0,
                  f"SP step {state.step}: loss {loss}")
            return loss, seconds, counts

        warm = [run_step() for _ in range(TRAIN_WARMUP)]
        timed = [run_step() for _ in range(TRAIN_STEPS)]
        # gradients where they carry signal: every LoRA B refilled at a
        # trained magnitude, as the train phase's second check (with B near
        # 0 the adapters' A gradients are bf16 noise)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for _, e in entries(frozen.lora):
                e["B"].copy_(TRAINED_B_STD * torch.randn(e["B"].shape,
                                                         generator=gen))
        small = {k: v[:GRAD_CHECK_BATCH] for k, v in batch.items()}
        loss_fn = make_loss_fn(config, stem, fold_lora=True)
        loss_sp, g_sp = _grads(loss_fn, state, frozen, small)
        with _replaced_config(frozen.model, seq_parallel_axis=None):
            loss_1, g_1 = _grads(loss_fn, state, frozen, small)
    ms = [1e3 * t[1] for t in timed]
    med = statistics.median(ms)
    errs = _leaf_errs(g_sp, g_1)
    out = {"phase": "ring", "part": "sp_train_step", "seq": 1,
           "backend": "nccl", "batch_size": TRAIN_BATCH,
           "launches_per_step": timed[-1][2],
           "warmup_losses": [w[0] for w in warm],
           "losses": [t[0] for t in timed], "step_ms": med, "step_ms_all": ms,
           "samples_per_s": TRAIN_BATCH / (med / 1e3),
           "train_phase_step_ms": tr["step_ms"],
           "train_phase_samples_per_s": tr["samples_per_s"],
           "grad_check_batch": GRAD_CHECK_BATCH,
           "loss": {"sp": loss_sp, "non_sp": loss_1},
           "sp_vs_non_sp": errs, "grad_rel_tol": GRAD_REL_TOL}
    emit(out)
    check(set(g_sp) == set(g_1), "SP and non-SP steps reach other leaves")
    check(errs["max"] <= GRAD_REL_TOL,
          f"SP step grads off the non-SP step: {errs['leaf']} {errs['max']}")
    check(abs(loss_sp - loss_1) <= LOSS_TOL * abs(loss_1),
          f"SP loss {loss_sp}, non-SP {loss_1}")
    return out


def phase_ring(tr) -> dict:
    """Sequence-parallel attention: a LocalRing of RING_N threads on the
    card at both kv_valid_len, then the SP training step at seq = 1."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    local = [_local_ring(gen, n) for n in RING_KV_VALID]
    sp = _sp_train_step(tr)
    torch.cuda.synchronize()
    check(_jax_free(), "jax or the JAX package was imported")
    out = {"phase": "ring", "local_ring": local, "sp_step": sp,
           "jax_imported": not _jax_free(), "card": card()}
    emit({k: v for k, v in out.items() if k not in ("local_ring", "sp_step")})
    return out


def summary(kernels, sl, bm, sp, tr, rg, pr, ev) -> dict:
    """One entry per kernel: launches on its path (training for K1, K2, K3;
    the sequence-parallel training step for K4; beam serving for K6, K7;
    speculative serving with the self-prefix drafter for K8; the perf
    probes' full-shape sweep for the probe kernels; greedy serving, and for
    K1, K6 and K7 the eval CLI's run (``eval_launches``), beside them), the error and the times of its case at that path's shape, its
    bound and the library call's time (for a probe kernel, of one variant
    named in ``case``, with every variant's ms beside)."""
    def first(kernel, case):
        return next(r for r in kernels
                    if r["kernel"] == kernel and r["case"] == case)

    def timing(r, prefix=""):
        return {"ms": r[prefix + "ms"], "plain_ms": r[prefix + "plain_ms"],
                "bound_ms": r[prefix + "bound_ms"],
                "bound_by": r[prefix + "bound_by"],
                "library_ms": r[prefix + "library_ms"]}

    def device(r):
        """The device and host times and bits of K3 and the decode
        kernels."""
        return {key: r[key] for key in ("device_ms", "library_device_ms",
                                        "host_us", "same_bits") if key in r}

    k1, k2 = first("K1", "train_encoder"), first("K2", "train_encoder")
    k5, k3 = first("K5", "bhtd_fwd_bwd"), first("K3", "fc1")
    k6, k6_btc = first("K6", "beam_step"), first("K6", "btc")
    k7 = first("K7", "beam_last")
    k8 = first("K8", "verify_late")
    k4, k4_bwd = first("K4", "sp_step_n1"), first("K4_bwd", "sp_step_n1")
    sp_launches = rg["sp_step"]["launches_per_step"]
    ring_launches = [r["launches"] for r in rg["local_ring"]]
    spec_launches = {n: r["launches"]["K8"]
                     for n, r in sp["requests"].items()}
    launches = tr["launches_per_step"]
    src = "neuspeech1_tpu_torch/csrc/"
    fa_py = "neuspeech1_tpu/ops/flash_attention.py"
    k5_bwd = {"ms": k5["bwd_ms"], "plain_ms": k5["bwd_plain_ms"],
              "bound_ms": k5["bwd_bound_ms"], "bound_by": k5["bwd_bound_by"],
              "library_ms": k5["bwd_library_ms"]}
    def probe(kernel, case, replaces):
        rows = [r for r in pr["lines"] if r["kernel"] == kernel]
        r = next(x for x in rows if x["k"] == case)
        return {"name": kernel, "route": "cuda", "source": src + kernel + ".cu",
                "replaces": replaces, "launches": pr["launches"][kernel],
                "path": "perf probes (neuspeech1_tpu_torch/perf)",
                "case": case, "max_abs_err": max(x["max_abs_err"]
                                                 for x in rows),
                **timing(r), "variant_ms": {x["k"]: x["ms"] for x in rows}}

    probes = [
        probe("probe_fwd", "base_bq512",
              "perf/kernel_probe.py:43 (and :117, :178; perf/mxu_probe.py:126; "
              "perf/btc_probe.py:53, :245)"),
        probe("probe_bwd", "bwd_bq512_bf16ops",
              "perf/bwd_probe.py:98 (and perf/btc_probe.py:132)"),
        probe("probe_dot", "dot_k512", "perf/mxu_probe.py:48"),
    ]
    return {"kernels": [
        {"name": "flash_fwd_btc (K1)", "route": "cuda",
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":494",
         "launches": launches["K1"], "serving_launches": sl["launches"]["K1"],
         "beam_launches": bm["launches"]["K1"],
         "eval_launches": ev["launches"]["K1"],
         "max_abs_err": k1["o_max_abs_err"], **timing(k1)},
        {"name": "flash_bwd_btc (K2)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":599",
         "launches": launches["K2"], "max_abs_err": k2["max_abs_err"],
         **timing(k2)},
        # K5: the same two kernels on [B, H, T, D] strides. No path of the
        # port calls that entry; its launches are those of its own run in
        # the kernels phase (counted from 0)
        {"name": "flash_fwd_btc on [B,H,T,D] (K5 forward)", "route": "cuda",
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":80",
         "launches": k5["launches"]["K1"], "path": "flash_attention entry",
         "max_abs_err": k5["o_max_abs_err"], **timing(k5)},
        {"name": "flash_bwd_btc on [B,H,T,D] (K5 backward)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":194",
         "launches": k5["launches"]["K2"], "path": "flash_attention entry",
         "max_abs_err": k5["grad_max_abs_err"], **k5_bwd},
        {"name": "lora_bwd (K3)", "route": "cuda",
         "source": src + "lora_bwd.cu",
         "replaces": "neuspeech1_tpu/ops/lora_bwd.py:47",
         "launches": launches["K3"], "max_abs_err": k3["max_abs_err"],
         **timing(k3), **device(k3)},
        {"name": "flash_fwd_btc_bias (K4 forward)", "route": "cuda",
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":742",
         "launches": sp_launches["K4"],
         "local_ring_launches": [r["K4"] for r in ring_launches],
         "max_abs_err": k4["o_max_abs_err"], **timing(k4)},
        {"name": "flash_bwd_btc_bias (K4 backward)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":786",
         "launches": sp_launches["K4_bwd"],
         "local_ring_launches": [r["K4_bwd"] for r in ring_launches],
         "max_abs_err": k4_bwd["max_abs_err"], **timing(k4_bwd)},
        {"name": "decode_cross (K6, [B,H,T,D] cache)", "route": "cuda",
         "source": src + "decode_cross.cu", "replaces": fa_py + ":869",
         "launches": bm["launches"]["K6"],
         "greedy_launches": sl["launches"]["K6"],
         "eval_launches": ev["launches"]["K6"],
         "max_abs_err": k6["max_abs_err"], **timing(k6),
         **device(k6)},
        # the [B, T, H*D] cache entry: no serving path holds that layout,
        # so its launches are those of its own run (counted from 0)
        {"name": "decode_cross_btc (K6, [B,T,H*D] cache)", "route": "cuda",
         "source": src + "decode_cross.cu", "replaces": fa_py + ":940",
         "launches": k6_btc["launches"], "path": "decode_cross_btc entry",
         "max_abs_err": k6_btc["max_abs_err"], **timing(k6_btc),
         **device(k6_btc)},
        {"name": "decode_step (K7)", "route": "cuda",
         "source": src + "decode_step.cu",
         "replaces": "neuspeech1_tpu/ops/decode_step.py:106",
         "launches": bm["launches"]["K7"],
         "greedy_launches": sl["launches"]["K7"],
         "eval_launches": ev["launches"]["K7"],
         "max_abs_err": k7["max_abs_err"], **timing(k7), **device(k7)},
        {"name": "decode_step_multi (K8)", "route": "cuda",
         "source": src + "decode_step_multi.cu",
         "replaces": "neuspeech1_tpu/ops/decode_step.py:189",
         "launches": spec_launches["spec_self"],
         "table_drafter_launches": spec_launches["spec_table"],
         "int8_launches": spec_launches["spec_int8"],
         "max_abs_err": k8["max_abs_err"], **timing(k8), **device(k8)},
    ] + probes}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[1:2] in (["--profile-train"], ["--profile-train-sp"]) \
            and len(argv) <= 3:
        phase_build()
        phase_train_profile(argv[2] if len(argv) == 3 else None,
                            seq_parallel=argv[1] == "--profile-train-sp")
        return 0
    if argv[1:]:
        print(f"usage: {argv[0]} [--profile-train[-sp] [TRACE_DIR]]",
              file=sys.stderr)
        return 2
    phase_build()
    kernels = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        model = serving_model(tmp)
        sl = phase_slice(model)
        bm = phase_beam(model)
        sp = phase_spec(model)
        phase_lora(model)
        ev = phase_eval(model, bm)
    tr = phase_train()
    rg = phase_ring(tr)
    pr = phase_probes()
    phase_bench()
    emit(summary(kernels, sl, bm, sp, tr, rg, pr, ev))
    print(card(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
