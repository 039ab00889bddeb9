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
            no-repeat-ngram 2, batch 16, 64 new tokens) on the same model:
            latency and utterances/s, launches of K1, K6 and K7 against the
            encoder, cached decoder and width-1 calls, the cached decoder's
            logits over 8 teacher-forced steps against the plain versions,
            and the share of tokens equal to the plain path's and to an
            f32 reference's.
5. spec     self-speculative greedy serving (gamma 4, batch 16, 64 new
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
7. finetune the fine-tune CLI (``neuspeech1_tpu_torch.cli.finetune.main``)
            in process at whisper-base width and its defaults (AdaLoRA
            init_r 12 -> target_r 4 with the orthogonality loss,
            --remat=auto, --device_cache=auto, the fold), batch 64, on 160
            synthetic 2-10 s clips, 14 steps on a schedule that runs every
            phase of the rank allocator, eval loss and eval-WER at 7 and
            14: ms per step beside the train phase's LoRA step, K1/K2/K3
            launches per step, the allocator's host ms and its budgets,
            the remat decision and memory plan beside the measured peak,
            checkpoint saves; a resume from step 14 (bit-exact); 4 steps
            with remat and rotating device shards; one step's gradients
            (with and without remat; kernels against the plain versions
            and f32); merge_lora and the eval CLI on the merged model
            against the eval CLI on the adapter.
8. speech   the speech modality at whisper-base width with the 'speech' stem
            (80 mel bins, 3000 frames -> 1500), bf16, weights from a seed:
            the eval phase's 48 clips with their 16 kHz wavs, split 8:1:1 by
            ``cli.manifest_tools``; the log-mel on the card
            (``ops/audio.py::log_mel_spectrogram_torch``) against the numpy
            one; the speech eval CLI (``cli.evaluation_speech.main``) at its
            defaults (batch 8, beam 5, 128 new tokens): decode and end-to-end
            seconds, K1/K6/K7 launches against the model calls, predictions
            against ``generate`` on the same batches, the encoder on speech
            features through K1 against the plain path; then
            ``cli.finetune.main --modal=speech`` at its defaults (AdaLoRA
            12 -> 4, batch 64, 128 labels) on the finetune phase's 160 + 32
            clips with wavs, 6 steps and one eval: K1/K2/K3 launches per
            step against the finetune phase's, finite losses, the adapter,
            and the step's rate (CUDA events) beside the CLI's (the host's
            log-mel loader lies between them).
9. ring     sequence-parallel (ring) attention: a LocalRing of 4 threads on
            the card at whisper-base widths (B=8, T=1536) through K4's
            forward and backward bodies, against K1/K2 on the whole
            sequence at kv_valid_len 1500 and 1000; then the training step
            with ``seq_parallel_axis`` over a one-rank NCCL group from
            ``parallel/mesh.py`` (whisper-base, batch 64): K4 launches per
            step, ms per step and samples/s beside the train phase's, and
            one step's loss and gradients against the non-SP kernel step.
10. lora    greedy serving (batch 8, 32 new tokens) through ``generate(...,
            lora=)`` with unmerged rank-32 adapters on encoder and decoder
            (self-attention q/k/v/out, cross-attention q/out, fc1/fc2):
            K1/K6/K7 launches against the model calls and the request
            without adapters, the cached decoder's logits over 8 forced
            steps against the plain versions, tokens equal to the plain
            versions' up to near-ties, and that the adapters move the
            logits.
11. eval    the eval CLI (``neuspeech1_tpu_torch.cli.evaluation.main``) in
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
12. modes   every other decode mode of serving on the same model, 16
            clips and 64 new tokens a request, each request timed (median
            of 2) with K1/K6/K7 launches held against the model calls:
            sampling (temperature 0.7, top-k 50, top-p 0.9; one seed gives
            one set of tokens, top-k 1 gives greedy's up to ties, tokens
            against the plain versions on one noise source), beam-sample
            at the eval CLI's settings (one seed, one set of tokens; zero
            noise gives beam search's), contrastive search (alpha 1, k 5:
            K6 at 5 query rows, K7 at 80 rows; tokens against the plain
            versions), int8 weights (the round trip's error, tokens against
            bf16 weights) and token timestamps on 4 clips (the grammar in
            greedy and beam decoding, starts and ends, the cross-attention
            maps against an f32 computation); then the eval CLI in process
            with --do_sample, --penalty_alpha=1 --top_k=5 and --timestamps.
13. probes  the perf entry points (``neuspeech1_tpu_torch/perf``): every
            variant of the TPU probes' sweeps (kernel_probe, mxu_probe,
            btc_probe, bwd_probe) held against its plain version at full
            TK and 8 heads, then at the probe's shape (B*H = 512, TK =
            1536, D = 64; the dot at 256 x [512, K] @ [K, 1536]) held
            against it again and timed beside its bound, the plain version
            and a library call (SDPA, its backward, ``torch.bmm``), each a
            line tagged as the JAX probe tags it; launches of probe_fwd,
            probe_bwd and probe_dot over the full-shape sweep.
14. bench   ``neuspeech1_tpu_torch.bench`` once in process: its JSON line
            (samples/s, step ms, mfu, greedy decode tokens/s with adapters).
15. parallel data parallelism and GPipe as LocalRing threads on the card,
            remat under sequence parallelism, the fine-tune CLI under
            torchrun's environment, the profiler's trace.
16. sharded FSDP and tensor parallelism in four processes on the card over
            a gloo group (``parallel/sharding.py``): the LoRA step over
            {tensor: 2} and the --ft_full step over {fsdp: 2, tensor: 2}
            against the one-rank step, greedy serving over {tensor: 2} and
            {data: 2}, the fine-tune CLI at --mesh_fsdp=2 --mesh_tensor=2
            (whole-tensor checkpoints, resume, eval-WER).
17. composed the mesh's parallel axes composed, in four processes on the
            card over a gloo group (CUDA tensors' ring and pipeline hops
            staged through pinned host memory): the LoRA step over {pipe:
            2, seq: 2} (ring attention inside GPipe stages) and {tensor: 2,
            seq: 2}, the --ft_full step over {fsdp: 2, pipe: 2} through the
            trainer with a save and a resume, each against the one-rank
            step, with K1-K4 launches as predicted; a greedy request under
            {pipe: 2, seq: 2} through ``Transcriber(mesh=)``; then
            ``perf/serve_bench``, ``perf/spec_bench`` and
            ``perf/trace_step`` in process.
18. family  the Whisper sizes past whisper-base and the drives of
            ``perf/model_panel.py`` and ``perf/flagship_drive.py``: K1/K2,
            K3, K6 and K7 against their plain versions at 12 and 20 heads,
            fc panels 768/3072 and 1280/5120, and head dim 24; the panel's
            whisper-small (batch 32) and large-v3 (batch 8, remat) training
            rows, a few steps each with K1/K2/K3 counted per step and a
            falling loss, then timed; its large-v3 greedy rows (128 mel
            bins, batch 8 with the bf16 cross cache, batch 32 with the
            int8 one), tokens against the plain versions; a greedy request
            through each stem kind ('base' over 208 and 273 channels,
            'replace', 'premel', 'speech'); the Schoffelen transfer
            (``flagship_drive`` phase S: a 208-channel adapter, the
            recipe's flags on 273 channels, merge_lora, the eval CLI); the
            CPU-scale convergence gate of tests/test_convergence.py (400
            steps, held-out WER at most 0.15) and flagship phase A
            (whisper-base --ft_full, 600 steps at batch 32: the eval loss
            falls from 300 to 600, held-out WER at 600 at most 0.5).

Then it prints each phase's wall seconds, the kernel summary (with each kernel's bound: the least time
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
import gc
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

KERNEL_CASES = (
    # the serving path: encoder self-attention at whisper-base width
    dict(name="encoder", b=8, t=1500, h=8, d=64, bwd=True),
    dict(name="encoder_kv_len", b=8, t=1500, h=8, d=64, kv_len=1400,
         bwd=True),
    dict(name="causal", b=8, t=448, h=8, d=64, causal=True, bwd=True),
    # the training path at batch 64: encoder self and decoder cross
    dict(name="train_encoder", b=64, t=1500, h=8, d=64, bwd=True),
    dict(name="train_cross", b=64, t=64, t_kv=1500, h=8, d=64, bwd=True),
    # the same at the tensor-parallel shapes: each of 2 tensor ranks holds
    # 4 of the 8 heads
    dict(name="tp_train_encoder", b=64, t=1500, h=4, d=64, bwd=True),
    dict(name="tp_train_cross", b=64, t=64, t_kv=1500, h=4, d=64, bwd=True),
    # the decoder's cross-attention on a microbatch of 16 rows: GPipe's 2
    # microbatches of the composed phase's batch of 32
    dict(name="pp_train_cross", b=16, t=64, t_kv=1500, h=8, d=64, bwd=True),
    dict(name="d32", b=2, t=300, h=4, d=32, bwd=True),
    dict(name="d128_causal", b=2, t=300, h=4, d=128, causal=True, bwd=True),
)
# (name, N, din, dout, r): the fc1 and fc2 adapters of the training step at
# batch 64 (N = 64 x 1500 tokens, not a multiple of the TPU block), and a
# ragged N at AdaLoRA's initial rank
LORA_CASES = (
    ("fc1", 96000, 512, 2048, 32),
    ("fc2", 96000, 2048, 512, 32),
    # fc1's and fc2's blocks on one of 2 tensor ranks
    ("tp_fc1", 96000, 512, 1024, 32),
    ("tp_fc2", 96000, 1024, 512, 32),
    # the composed phase's: a GPipe microbatch of 16 rows on a 768-frame
    # sequence shard, and 32 rows on one beside 2 tensor ranks
    ("pp_sp_fc1", 12288, 512, 2048, 32),
    ("tp_sp_fc1", 24576, 512, 1024, 32),
    ("ragged_r12", 10007, 512, 2048, 12),
)
# The routed experts' grouped GEMM at Kimi-VL-A3B's language model
# (hidden 2048, 64 experts of width 1408, top-6) on the moe-llm-train-b32
# step's tokens: 32 x (375 prefix + 128 text) positions, each routed to 6
# experts by the router over N(0, 1) states (weights N(0, 0.02), correction
# bias N(0, 0.1^2)), so the groups are as uneven as `route` makes them.
# (name, w's [E, K, N], trans_w): the fused gate-up and the down products
# and their input gradients.
MOE_TOKENS = 32 * (375 + 128)
MOE_EXPERTS, MOE_HIDDEN, MOE_WIDTH, MOE_TOP_K = 64, 2048, 1408, 6
MOE_CASES = (
    ("gate_up", (MOE_EXPERTS, MOE_HIDDEN, 2 * MOE_WIDTH), False),
    ("down", (MOE_EXPERTS, MOE_WIDTH, MOE_HIDDEN), False),
    ("down_dgrad", (MOE_EXPERTS, MOE_WIDTH, MOE_HIDDEN), True),
    ("gate_up_dgrad", (MOE_EXPERTS, MOE_HIDDEN, 2 * MOE_WIDTH), True),
)
# The grouped GEMM against its f32 gold (per-expert f32 products): one
# bf16 rounding of the output (2^-8 relative) on top of f32 sums in
# another order, so the largest error within 2^-7 of the largest output and
# the error's norm within 4e-3 of the output's (tests/
# test_torch_cuda_kernels.py's bounds).
MOE_MAX_TOL = 2.0 ** -7
MOE_NORM_TOL = 4e-3
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
# K6 and K7 on one of 2 tensor ranks (4 of the 8 heads): the greedy and
# beam steps of the cases above
SHARDED_DECODE_HEADS = 4
SHARDED_DECODE_CROSS_CASES = (
    ("tp_greedy", 8, 1, 1500, None, "bhtd"),
    ("tp_beam_step", 16, 5, 1500, None, "bhtd"),
)
SHARDED_DECODE_STEP_CASES = (
    ("tp_greedy_last", 8, 36, 35),
    ("tp_beam_last", 80, 132, 131),
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
BEAM_NEW_TOKENS = 64
BEAM_REPEATS = 2
BEAM_FORCED_STEPS = 8
# Speculative serving: the JAX package's measured gamma, at the beam phase's
# batch and budget
SPEC_BATCH = 16
SPEC_NEW_TOKENS = 64
SPEC_GAMMA = 4
SPEC_REPEATS = 2
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
# The f32-operand backward's outputs bit-equal to the plain f32 version's:
# at least the share of the FFMA kernel this design replaced, less one
# point. That kernel's least share over tests/test_torch_cuda_kernels.py's
# inputs and this phase's full-shape ones was 0.99994 (perf/flash_trees.py
# CHECKOUT TAG probes; NVIDIA H100 80GB HBM3, 700.00 W); the bf16-operand
# mode's is 0.62. The 1e-2 bound above cannot tell f32 passes from bf16
# ones; this can.
PROBE_BWD_F32_SHARE_FLOOR = 0.9899
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
# The other decode modes of serving (the `modes` phase), on the serving
# model at the beam phase's batch and budget: sampling at the warpers' usual
# settings; beam-sample at the eval CLI's defaults (beam 5, rp 5.0, ngram 2);
# contrastive search at the reference's strategy (utils/process_str.py:64-65:
# penalty_alpha 1, top_k 5); int8 weights greedily; token timestamps on
# MODES_TS_CLIPS clips
MODES_BATCH = 16
MODES_NEW_TOKENS = 64
MODES_REPEATS = 2
SAMPLE_SETTINGS = dict(do_sample=True, temperature=0.7, top_k=50, top_p=0.9,
                       sample_seed=0)
CONTRASTIVE_SETTINGS = dict(penalty_alpha=1.0, top_k=5)
MODES_TS_CLIPS = 4
# cross-attention probabilities (6 layers x 8 heads over 1500 frames per
# token) from the bf16 serving model against the same maps computed in f32
# on the same weights, tokens and encoder states: bf16 rounds the decoder's
# hidden states and the scores at 2^-8 relative, which moves a probability
# p by p times its score's error. Bounds relative to the f32 maps: the
# largest error within 2^-4 of the largest p, the mean error within 2^-6 of
# the mean p (1 / 1500). (They measured 0.55% and 0.09%, max p 1.6e-3, on
# an H100; the first bounds, 0.1 and 1e-4 absolute, were set before that
# reading and were far looser.)
MAPS_MAX_REL_TOL = 2.0 ** -4
MAPS_MEAN_REL_TOL = 2.0 ** -6
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
    # the composed phase's ring of 2 over 1536 frames, the second shard's
    # block (its last 36 keys masked): a GPipe microbatch of 16 rows with
    # 8 heads, and 32 rows with the 4 heads of a tensor rank
    ("pp_sp_block", 16, 768, 8, 64, 36),
    ("tp_sp_block", 32, 768, 4, 64, 36),
)
# The ring phase: a LocalRing of RING_N threads on the card at whisper-base
# widths, 1500 frames padded to 1536, and kv_valid_len 1000, which masks the
# fourth shard entirely
# The finetune phase: the CLI at its defaults on FT_TRAIN train and FT_VAL
# val clips (2-10 s, 208 channels), batch 64, its default 128 labels, with a
# schedule short enough that every phase of the rank allocator runs in
# FT_STEPS steps (warm-up to step 2, allocations every 2 steps, the pattern
# frozen at step FT_STEPS - 4); then FT_REMAT_STEPS steps with remat and a
# FT_ROTATE_MB cache budget (the corpus is about 400 MB in bf16, so its
# shards rotate), and the eval CLI on FT_EVAL val clips.
FT_TRAIN, FT_VAL, FT_EVAL = 160, 32, 16
FT_BATCH, FT_LABEL_LEN, FT_RANK = 64, 128, 12
FT_STEPS, FT_REMAT_STEPS, FT_ROTATE_MB = 14, 4, 200
FT_SPLIT_STEPS = 5
# merge_lora's adapted weights against a float64 merge, relative to each
# layer's largest |delta| (beside f32's rounding of W + delta): a merge
# that drops E or misscales B by 2% or more lands above it. The check runs
# on the trained adapter and on it with E redrawn at TRAINED_E_STD
MERGE_REL_TOL = 1e-2
TRAINED_E_STD = 0.1
FT_SCHEDULE = ("--adalora_tinit=2", "--adalora_tfinal=4",
               "--adalora_deltaT=2", "--warmup_steps=2", "--eval_steps=7",
               "--save_steps=7", "--logging_steps=1", "--eval_wer=True")
# speech: whisper-base with the 'speech' stem (80 mel bins, 3000 frames ->
# 1500), the speech eval CLI at its defaults (batch 8, beam 5, 128 new
# tokens) on the eval phase's EVAL_CLIPS clips with their wavs, and the
# fine-tune CLI with --modal=speech at its defaults on the finetune phase's
# clips with their wavs, SPEECH_FT_STEPS steps on a schedule that runs every
# phase of the rank allocator (an allocation at step 4, the pattern frozen
# from step 5) and one eval (loss and eval-WER) at the last step. The
# log-mel on the card against the numpy one: the bound the JAX package
# holds between its jnp and numpy versions (tests/test_signal_ops.py:80)
SPEECH_EVAL_BATCH = 8
SPEECH_FT_STEPS = 6
SPEECH_FT_SCHEDULE = ("--adalora_tinit=2", "--adalora_tfinal=2",
                      "--adalora_deltaT=2", "--warmup_steps=2",
                      f"--eval_steps={SPEECH_FT_STEPS}",
                      f"--save_steps={SPEECH_FT_STEPS}", "--logging_steps=1",
                      "--eval_wer=True")
MEL_RTOL, MEL_ATOL = 1e-3, 1e-4
# options: the training step's options at the train phase's setup
# (whisper-base, batch 64, 64 labels, LoRA r=32, the fold). Each timed
# setting runs OPT_WARM steps, then OPT_TIMED timed ones (median).
OPT_WARM, OPT_TIMED = 3, 4
OPT_AUGMENT = {
    "noise": {"prob": 0.5, "min_snr_dB": 5, "max_snr_dB": 20},
    "mask": {"prob": 0.5, "kwargs": {"unit": [1, 40], "mask_prob": 0.25,
                                     "random_type": 1}},
    "taylor": {"prob": 0.5},
    "spec_augment": {"mask_time_prob": 0.05, "mask_time_length": 10,
                     "mask_time_min_masks": 2}}
OPT_DROPOUT = 0.1
# the draws held by their distributions: OPT_DRAWS batches of draws on the
# card, each rate within Z_BINOMIAL standard deviations of its probability
OPT_DRAWS = 16
Z_BINOMIAL = 5.0
# measured SNR of a noisy (row, channel) over its 6000 samples against the
# drawn SNR: the ratio of two means of squares over 6000 samples spreads by
# 10 log10(e) sqrt(2 / 6000) = 0.079 dB (one standard deviation), and the
# power is taken from the bf16 batch (2^-8 relative, 0.017 dB); 0.7 dB is
# about 8.5 standard deviations, past the extreme of 13,312 estimates
SNR_TOL_DB = 0.7
# int8 against the bf16 step, per trainable leaf |g_int8 - g_bf16| / |g_bf16|:
# on the CPU in f32 (tests/test_torch_int8_matmul.py's setup) int8 moves a
# leaf by up to 4.7% under fwd and full (median 1.9% and 2.6%); three times
# that, plus the bf16 paths' own GRAD_REL_TOL. The loss: int8 moved it by
# 3.5e-5 relative on the CPU; 1e-2 leaves room for bf16.
INT8_GRAD_REL_TOL = 0.2
INT8_LOSS_REL_TOL = 1e-2
# the fine-tune CLI with augmentation and int8: steps per run
OPT_CLI_STEPS = 3
# parallel: the train phase's step with the data axis on DP_N LocalRing
# threads of the card (64 / DP_N rows a rank), DP_STEPS steps, its ce loss
# within DP_LOSS_RTOL and its pre-clip gradient norm within
# DP_GRAD_NORM_RTOL of the one-rank step's (bf16); GPipe on PIPE_N
# LocalRing threads in PIPE_M microbatches at the largest of PIPE_BATCHES
# that fits on the card, per stack (tried from the largest down; the
# batches that ran out of memory and the pass's peak memory are printed),
# outputs and input gradients within PIPE_O_TOL (relative) of the plain
# loop's; remat under SP for REMAT_SP_POLICIES; the fine-tune CLI under a
# torchrun environment for PAR_CLI_STEPS steps then two more after a
# resume; and the names the profiler's trace must hold
# (the ce losses came out equal on the card; the gradient norms 5.6e-4
# apart at both steps, NVIDIA H100 80GB HBM3, 700 W; a reduction off by the
# rank count would put them 0.5 or 1 apart). The batches: run alone, the
# encoder fit 512 rows at 77.4 GiB and not 576, the decoder 2048 at 61.2
# GiB and not 2560; after the script's earlier phases the encoder's 512
# ran out and the decoder fit 2304 at 68.8 GiB (same card), so each list
# steps down to a fallback
# The sharded phase: SHARD_PROCS processes share the card over a gloo group
# (NCCL refuses two ranks on one GPU); a collective that waits past
# SHARD_GROUP_TIMEOUT_S fails its rank, and the phase fails if its ranks
# run past SHARD_TIMEOUT_S. The LoRA 'fc' step at TRAIN_BATCH over {tensor:
# 2} and the --ft_full step at SHARD_FSDP_BATCH over {fsdp: 2, tensor: 2},
# SHARD_STEPS steps each against the one-rank step, with the data-parallel
# check's bounds; greedy serving of SHARD_CLIPS clips, SHARD_NEW_TOKENS new
# tokens; the fine-tune CLI for SHARD_CLI_STEPS steps, then a resume
SHARD_PROCS, SHARD_STEPS, SHARD_FSDP_BATCH = 4, 2, 32
SHARD_LOSS_RTOL, SHARD_GRAD_NORM_RTOL = LOSS_TOL, 5e-3
SHARD_CLIPS, SHARD_NEW_TOKENS = 8, 16
SHARD_CLI_STEPS, SHARD_CLI_BATCH, SHARD_EVAL_BATCH = 4, 32, 8
SHARD_GROUP_TIMEOUT_S, SHARD_TIMEOUT_S = 300, 900
# The composed phase: COMPOSED_PROCS processes share the card over a gloo
# group, as the sharded phase's do, on the grids of COMPOSED_GRIDS (name,
# axes, --ft_full): the LoRA 'fc' step or the --ft_full step at
# COMPOSED_BATCH, COMPOSED_STEPS steps, GPipe at COMPOSED_M (= P)
# microbatches, against the one-rank step with the sharded phase's bounds
# (the --ft_full grid through the trainer: a step, a save, a resume, a
# step); a greedy request of SHARD_CLIPS clips, SHARD_NEW_TOKENS new tokens
COMPOSED_PROCS, COMPOSED_BATCH, COMPOSED_STEPS, COMPOSED_M = 4, 32, 2, 2
COMPOSED_GRIDS = (("pipe_seq", {"pipe": 2, "seq": 2}, False),
                  ("tensor_seq", {"tensor": 2, "seq": 2}, False),
                  ("fsdp_pipe", {"fsdp": 2, "pipe": 2}, True))
DP_N, DP_STEPS, DP_LOSS_RTOL = 2, 2, LOSS_TOL
DP_GRAD_NORM_RTOL = 5e-3
PIPE_N, PIPE_M = 2, 4
PIPE_BATCHES = {"encoder": (576, 512, 480, 448, 384, 256),
                "decoder": (2560, 2304, 2048, 1024)}
PIPE_O_TOL = 2e-2
REMAT_SP_POLICIES = (None, "flash_qkv")
PAR_CLI_STEPS = 4
PROFILE_NAMES = ("train_step", "flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                 "lora_bwd_kernel")
RING_N = 4
RING_BATCH = 8
RING_T = 1536
RING_KV_VALID = (1500, 1000)
# The family phase: the Whisper sizes past whisper-base
# (perf/model_panel.py's rows), every stem kind, the Schoffelen transfer
# and the convergence drives. Kernel cases at the new shapes: whisper-small's
# training step at batch 32 (12 heads of 64) and large-v3's at batch 8 (20
# heads; its serving encoder has the same shape), and the CPU-scale
# convergence gate's head dim 24, which the wrappers pad to 32
FAMILY_KERNEL_CASES = (
    dict(name="small_train_encoder", b=32, t=1500, h=12, d=64, bwd=True),
    dict(name="small_train_cross", b=32, t=64, t_kv=1500, h=12, d=64,
         bwd=True),
    dict(name="large_train_encoder", b=8, t=1500, h=20, d=64, bwd=True),
    dict(name="large_train_cross", b=8, t=64, t_kv=1500, h=20, d=64,
         bwd=True),
    dict(name="gate_encoder_d24", b=16, t=80, h=2, d=24, bwd=True),
    dict(name="gate_cross_d24", b=16, t=32, t_kv=80, h=2, d=24, bwd=True),
)
# K3 at the fc adapters of both steps: N = batch x 1500 tokens (large-v3's
# 1280 + 5120 columns take the kernel's wide path)
FAMILY_LORA_CASES = (
    ("small_fc1", 48000, 768, 3072, 32),
    ("small_fc2", 48000, 3072, 768, 32),
    ("large_fc1", 12000, 1280, 5120, 32),
    ("large_fc2", 12000, 5120, 1280, 32),
)
# K6 and K7 at large-v3's greedy decode (20 heads of 64, 4 prompt + 32 new
# tokens: batch 8, and batch 32 of the int8-cache row, whose cross
# attention runs plain PyTorch), and at the gate's eval decode (2 heads of
# 24, batch 16, 48 positions)
FAMILY_HEADS = 20
FAMILY_DECODE_CROSS_CASES = (("large_greedy", 8, 1, 1500, None, "bhtd"),)
FAMILY_DECODE_STEP_CASES = (("large_greedy_last", 8, 36, 35),
                            ("large_bs32_last", 32, 36, 35))
GATE_HEADS, GATE_HEAD_DIM = 2, 24
GATE_DECODE_CROSS_CASES = (("gate_greedy_d24", 16, 1, 80, None, "bhtd"),)
GATE_DECODE_STEP_CASES = (("gate_greedy_d24_last", 16, 48, 47),)
# the training rows' own steps before the panel times them: the schedule
# warms up over FAMILY_WARMUP steps (step 1 at lr 0), then the loss on the
# fixed batch must fall
FAMILY_WARMUP, FAMILY_STEPS = 1, 4
FAMILY_NEW_TOKENS = 32
# greedy requests through each stem kind at whisper-base width
FAMILY_STEMS = (("base", 208), ("base", 273), ("replace", 208),
                ("premel", 208), ("speech", None))
FAMILY_STEM_CLIPS, FAMILY_STEM_TOKENS = 4, 16
# the transfer at a few steps on 96-clip corpora
FAMILY_TRANSFER_CLIPS = 96
FAMILY_TRANSFER_FLAGS = (
    "--max_steps=6", "--eval_steps=6", "--save_steps=6", "--logging_steps=1",
    "--warmup_steps=1", "--adalora_tinit=1", "--adalora_tfinal=2",
    "--adalora_deltaT=1")
# flagship phase A at 600 steps: the eval loss must fall from step 300 to
# 600 and the held-out WER at 600 stay at most this (the JAX package's
# runs at 600 steps: 0.104-0.51, BASELINE.md)
PHASE_A_WER = 0.5


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
    from neuspeech1_tpu_torch.ops import moe_gemm
    from neuspeech1_tpu_torch.ops import probe_bwd, probe_dot, probe_fwd

    loaders = {"flash_fwd_btc": fa._library, "flash_bwd_btc": fa._bwd_library,
               "lora_bwd": lb._library, "moe_grouped_gemm": moe_gemm._library,
               "decode_cross": dc._library,
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = _check_flash(gen)
    results.append(_check_bhtd_layout(gen))
    results.extend(_check_lora_bwd(gen))
    results.extend(_check_flash_bias(gen))
    results.extend(_check_decode_cross(gen))
    results.extend(_check_decode_cross(gen, SHARDED_DECODE_CROSS_CASES,
                                       SHARDED_DECODE_HEADS))
    results.extend(_check_decode_step(gen))
    results.extend(_check_decode_step(gen, SHARDED_DECODE_STEP_CASES,
                                      SHARDED_DECODE_HEADS))
    results.extend(_check_decode_step_multi(gen))
    results.extend(_check_moe_gemm(gen))
    return results


def _check_flash(gen, cases=KERNEL_CASES, profiled: bool = True) -> list:
    """K1 (and K2 where a case says ``bwd``, with its kernels' device times
    where ``profiled``) against the plain versions at ``cases``' shapes,
    timed beside SDPA."""
    import torch.nn.functional as F

    from neuspeech1_tpu_torch.ops import flash_attention as fa

    results = []
    for case in cases:
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
            results.append(_check_flash_bwd(case, q, k, v, o_k, lse_k, gen,
                                            profiled))
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


def _profiled(fn, calls: int, read, seen, windows: int = 8):
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


def _check_flash_bwd(case, q, k, v, o, lse, gen,
                     profiled: bool = True) -> dict:
    """K2 against its plain version on the forward kernel's o and lse;
    with ``profiled``, its three kernels' device times."""
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
           **({"split_ms": _bwd_split_ms(lambda: fa._flash_bwd_cuda(*args))}
              if profiled else {}),
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


def _check_lora_bwd(gen, cases=LORA_CASES, profiled: bool = True) -> list:
    """K3 against its plain version at the fc1 / fc2 shapes of the training
    step (N = 64 x 1500 tokens) and at a ragged N with rank 12: CUDA
    events and, with ``profiled``, device time under torch.profiler (both
    of the call's launches) and the wrapper's host time; a second call
    gives the same bits."""
    from neuspeech1_tpu_torch.ops import lora_bwd as lb

    out = []
    for name, n, din, dout, r in cases:
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
               **({"device_ms": _device_ms(lambda: lb.lora_adapter_bwd(
                   x, dy, a, bm)),
                   "host_us": _host_us(lambda: lb.lora_adapter_bwd(
                       x, dy, a, bm))} if profiled else {}),
               "same_bits": same,
               # None: past the one-pass plan, the wide path
               "plan": plan and plan._asdict(),
               "resident_clusters": plan and lb.resident_clusters(plan),
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


def _check_decode_cross(gen, cases=DECODE_CROSS_CASES,
                        h: int = DECODE_HEADS, d: int = DECODE_HEAD_DIM,
                        profiled: bool = True) -> list:
    """K6 against its plain version at the greedy and beam decoder's shapes
    (``cases``, at ``h`` heads), through both cache layouts; timed over
    CACHE_COPIES caches in turn, beside SDPA on the same [B, H, Tq, D] x
    [B, H, T, D] inputs: CUDA events, device time under torch.profiler and
    the wrapper's host time; and a second call on the same inputs gives the
    same bits."""
    import torch.nn.functional as F

    from neuspeech1_tpu_torch.ops import decode_cross as dc

    out = []
    for name, b, t_q, t, kv_len, layout in cases:
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
               **({"device_ms": _device_ms(lambda: kernel(next(cycle))),
                   "library_device_ms": _device_ms(sdpa),
                   "host_us": _host_us(lambda: kernel(next(cycle)))}
                  if profiled else {}),
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


def _check_decode_step(gen, cases=DECODE_STEP_CASES,
                       h: int = DECODE_HEADS, d: int = DECODE_HEAD_DIM,
                       profiled: bool = True) -> list:
    """K7 against its plain version at the beam and greedy steps' shapes
    (``cases``, at ``h`` heads): the context within K7_TOL and the caches
    after the in-place write equal, the same bits from a second call; timed
    over CACHE_COPIES caches in turn (CUDA events, device time under
    torch.profiler and the wrapper's host time). No single PyTorch call
    computes this function (a cache write and a masked attention)."""
    from neuspeech1_tpu_torch.ops import decode_step as ds

    out = []
    for name, rows, t_max, idx in cases:
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
               **({"device_ms": _device_ms(lambda: ds.decode_step(
                   q, kn, vn, *next(cycle), idx)),
                   "host_us": _host_us(lambda: ds.decode_step(
                       q, kn, vn, *next(cycle), idx))} if profiled else {}),
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


def _moe_rows(gen):
    """(offs int32 [E + 1], rows): the router's dropless groups over the
    step's tokens (`MOE_TOKENS`), as ``models/moe_lm.py`` forms them."""
    from neuspeech1_tpu_torch.models import moe_lm

    x = torch.randn((MOE_TOKENS, MOE_HIDDEN), generator=gen, device="cuda")
    gate_w = 0.02 * torch.randn((MOE_EXPERTS, MOE_HIDDEN), generator=gen,
                                device="cuda")
    bias = 0.1 * torch.randn(MOE_EXPERTS, generator=gen, device="cuda")
    idx, _ = moe_lm.select(x.to(torch.bfloat16), gate_w.to(torch.bfloat16),
                           bias, MOE_TOP_K, True, 2.446)
    r = moe_lm.route(idx, MOE_EXPERTS)
    return r.offs, r.token.numel()


def _moe_launches_per_layer(gen) -> int:
    """Grouped GEMM launches in one step of a routed layer on the training
    path: ``moe_lm.lm_apply`` under remat over a frozen language model of
    the published widths cut to one dense and one routed layer, at the
    step's tokens, forward and backward to its input."""
    from neuspeech1_tpu_torch.config import MoELMConfig
    from neuspeech1_tpu_torch.models import moe_lm
    from neuspeech1_tpu_torch.ops import moe_gemm

    c = MoELMConfig(num_hidden_layers=2)
    with torch.device("meta"):
        lm = moe_lm.MoELM(c)
    lm = lm.to_empty(device="cuda").to(torch.bfloat16).requires_grad_(False)
    with torch.no_grad():
        for name, t in itertools.chain(lm.named_parameters(),
                                       lm.named_buffers()):
            if name.endswith("norm.weight"):
                t.fill_(1.0)
            else:
                t.normal_(0.0, 0.02, generator=gen)
        for m in lm.modules():
            if isinstance(m, moe_lm.Router):
                m.e_score_correction_bias = 0.1 * torch.randn(
                    MOE_EXPERTS, generator=gen, device="cuda")
    h = torch.randn((32, MOE_TOKENS // 32, MOE_HIDDEN), generator=gen,
                    device="cuda", dtype=torch.bfloat16).requires_grad_(True)
    torch.cuda.synchronize()
    moe_gemm.launches = 0
    logits = moe_lm.lm_apply(lm, h, 375, remat=True)
    torch.autograd.backward(logits, torch.randn_like(logits))
    torch.cuda.synchronize()
    n = moe_gemm.launches
    check(h.grad is not None and bool(torch.isfinite(h.grad).all()),
          "moe_grouped_gemm: the layer's input gradient is not finite")
    del lm, h, logits
    return n


def _check_moe_gemm(gen) -> list:
    """The routed experts' grouped GEMM against its plain version at the
    language-model cell's shapes (`MOE_CASES` on the router's groups):
    CUDA events for the kernel, the plain loop over experts and, where the
    installed PyTorch has one, ``torch._grouped_mm``; device time under
    torch.profiler; the same bits twice. Then the launches of one routed
    layer's step on the training path: the forward's two products, remat's
    recompute of them and the two input-gradient products."""
    from neuspeech1_tpu_torch.ops import moe_gemm as mg

    offs, rows = _moe_rows(gen)
    counts = (offs[1:] - offs[:-1]).tolist()
    out = []
    for name, shape, trans in MOE_CASES:
        e, kw, nw = shape
        k, n = (nw, kw) if trans else (kw, nw)
        x = torch.randn((rows, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn(shape, generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        got = mg.grouped_gemm(x, w, offs, trans)
        again = mg.grouped_gemm(x, w, offs, trans)
        gold = mg.grouped_gemm_plain(x.float(), w.float(), offs, trans)
        torch.cuda.synchronize()
        err = (got.float() - gold).abs()
        max_abs = err.max().item()
        max_rel = max_abs / gold.abs().max().item()
        norm_rel = ((got.float() - gold).norm() / gold.norm()).item()
        del gold, err
        library_ms, library_error = None, None
        grouped_mm = getattr(torch, "_grouped_mm", None)
        if grouped_mm is not None:
            wl = w.transpose(1, 2) if trans else w
            ends = offs[1:].contiguous()
            try:
                grouped_mm(x, wl, offs=ends)
                library_ms = cuda_ms(lambda: grouped_mm(x, wl, offs=ends))
            except (RuntimeError, ValueError) as exc:
                library_error = str(exc).splitlines()[0][:200]
        # reads x and every expert's weights once, writes y, all bf16
        n_bytes = 2 * (rows * k + e * k * n + rows * n) + 4 * (e + 1)
        res = {"phase": "kernels", "kernel": "moe_grouped_gemm",
               "case": name, "shape": [rows, k, n, e], "trans_w": trans,
               "rows_per_expert": [min(counts), max(counts)],
               "empty_experts": sum(c == 0 for c in counts),
               "max_abs_err": max_abs, "max_rel_err": max_rel, "norm_rel_err": norm_rel,
               "max_tol": MOE_MAX_TOL, "norm_tol": MOE_NORM_TOL,
               "ms": cuda_ms(lambda: mg.grouped_gemm(x, w, offs, trans)),
               "plain_ms": cuda_ms(lambda: mg.grouped_gemm_plain(
                   x, w, offs, trans), iters=3, warmup=1),
               "library_ms": library_ms,
               **({"library_error": library_error} if library_error
                  else {}),
               "device_ms": _device_ms(lambda: mg.grouped_gemm(
                   x, w, offs, trans)),
               "same_bits": torch.equal(got, again),
               **bound(n_bytes, 2.0 * rows * k * n)}
        res["tflops"] = _tflops(2.0 * rows * k * n, res["device_ms"])
        emit(res)
        check(bool(torch.isfinite(got).all()),
              f"moe_grouped_gemm {name}: non-finite output")
        check(max_rel <= MOE_MAX_TOL and norm_rel <= MOE_NORM_TOL,
              f"moe_grouped_gemm {name}: kernel disagrees with plain "
              "version")
        check(res["same_bits"], f"moe_grouped_gemm {name}: a second call "
              "gave other bits")
        out.append(res)
        del x, w, got, again
    n = _moe_launches_per_layer(gen)
    res = {"phase": "kernels", "kernel": "moe_grouped_gemm",
           "case": "routed_layer_step", "launches": n, "expected": 6}
    emit(res)
    check(n == 6, f"moe_grouped_gemm: {n} launches in a routed layer's "
          "step under remat, not 2 forward + 2 recompute + 2 backward")
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
                        lora=None, pos_ids=None, self_attn_mask=None,
                        return_hidden=False):
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
                             pos_ids, self_attn_mask, return_hidden)

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
                   lora=None, int8_cross: bool = False):
    """The cached decoder's logits for B*K rows of ``tokens`` [B*K, L]: the
    prompt's prefill, then ``steps`` width-1 steps on the given tokens,
    with the decoder adapters of ``lora`` (on an int8 cross cache with
    ``int8_cross``); [B*K, prompt_len + steps, V]."""
    from neuspeech1_tpu_torch.models import whisper as tw

    cache = tw.init_cache(model, enc, max_len=prompt_len + steps,
                          self_batch=tokens.shape[0], int8_cross=int8_cross)
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
    no-repeat-ngram 2, batch 16, 64 new tokens, one request of 16
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
    64 new tokens, one request of 16 signals per reading, with the
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
               lora, name: str = "lora") -> dict:
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
    int8 = gen.int8_kv_cache
    logits_k = _forced_logits(model, enc, tokens_p, p, steps, lora,
                              int8).float()
    with _plain_kernels():
        logits_p = _forced_logits(model, enc, tokens_p, p, steps, lora,
                                  int8).float()
    rel = ((logits_k - logits_p).abs().max().item()
           / logits_p.abs().max().item())
    check(rel <= LOGITS_REL_TOL, f"{name}: cached decoder logits along the "
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
        check(gap <= tol, f"{name}: row {r} parts from the plain versions at "
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


def _eval_corpus(tmp: str, vocab_size: int, with_audio: bool = False):
    """The eval phase's corpus (``data/synthetic.py``, EVAL_CLIPS clips of
    2-10 s over 208 channels, with their 16 kHz wavs when ``with_audio``)
    and a word vocabulary of ``vocab_size`` words whose first entries are
    the corpus's words, so that its labels tokenize: (corpus dir,
    tokenizer spec)."""
    from neuspeech1_tpu_torch.data.synthetic import _WORDS, make_synthetic_corpus

    root = os.path.join(tmp, "eval_corpus")
    make_synthetic_corpus(root, n_clips=EVAL_CLIPS, n_channels=208,
                          min_dur=EVAL_DURATION_S[0],
                          max_dur=EVAL_DURATION_S[1], seed=0,
                          with_audio=with_audio)
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


def _request(tr, signals, gen, generator=None):
    """One request as ``Transcriber.transcribe`` serves it, in the mode of
    ``gen`` (contrastive search has no Transcriber argument: the eval CLI
    and ``generate`` run it): the tokens [B, max_length] on the card."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import generate

    feats = common.upload_features(tr._prepare(signals), tr.model.dtype,
                                   tr.device)
    prompt = torch.as_tensor(np.repeat(tr.prompt, feats.shape[0], axis=0),
                             device=tr.device)
    return generate(tr.model, feats, prompt, gen, generator=generator)


def _timed_requests(name, config, fn, steps_of) -> dict:
    """``fn`` once to warm up, then MODES_REPEATS timed calls (host clock
    after ``synchronize``) with the kernels' launches counted from 0 and
    held against the model calls; ``steps_of(calls)`` gives the decode steps
    of one request from the calls of all of them."""
    fn()
    torch.cuda.synchronize()
    _reset_counts()
    lat = []
    with count_model_calls() as calls:
        for _ in range(MODES_REPEATS):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    launches = _kernel_counts()
    _check_serving_launches(name, config, calls, launches)
    med = statistics.median(lat)
    steps = steps_of(calls) / MODES_REPEATS
    return {"out": out, "launches": launches, "model_calls": calls,
            "request_latency_s": med, "request_latency_all_s": lat,
            "utterances_per_s": MODES_BATCH / med,
            "utterances_per_s_all": [MODES_BATCH / x for x in lat],
            "steps_per_request": steps, "ms_per_step": 1e3 * med / steps,
            "launches_per_request": {k: v / MODES_REPEATS
                                     for k, v in launches.items() if v}}


def _first_diffs_tied(model, feats, prompt, ref, other, p: int) -> dict:
    """Where two decodes of the same requests part, is the first differing
    token a tie of ``ref``'s logits? The cached decoder's logits along
    ``ref`` (prefill, then width-1 steps on a cache of ``ref``'s length:
    the greedy decode's own computation), compared at each row's first
    difference between ``ref``'s token and ``other``'s."""
    from neuspeech1_tpu_torch.models import whisper as tw

    eq = (ref[:, p:] == other[:, p:])
    rows = [i for i in range(ref.shape[0]) if not bool(eq[i].all())]
    if not rows:
        return {"rows_differing": 0, "all_ties": True}
    first = {i: p + int(eq[i].logical_not().nonzero()[0]) for i in rows}
    with torch.no_grad():
        enc = tw.encoder_apply(model, feats)
        cache = tw.init_cache(model, enc, max_len=ref.shape[1])
        step, cache = tw.decoder_apply(model, ref[:, :p], enc, cache=cache,
                                       cache_index=0)
        logits = [step]
        for j in range(p, max(first.values())):
            step, cache = tw.decoder_apply(model, ref[:, j:j + 1], enc,
                                           cache=cache, cache_index=j)
            logits.append(step)
        logits = torch.cat(logits, dim=1)
    ties = [bool(logits[i, j - 1, ref[i, j]] == logits[i, j - 1, other[i, j]])
            for i, j in first.items()]
    return {"rows_differing": len(rows), "first_diff": list(first.values()),
            "ties": ties, "all_ties": all(ties)}


def _grammar_violations(tokens, p: int, config) -> list:
    """The generated part of each row (up to its first eot) against the
    timestamp grammar's fixed rules (``decode/timestamps.py``): no
    <|notimestamps|>; a first token that is a timestamp no later than
    begin + 50; after two timestamps no third; after a timestamp that
    follows text (or the prompt) a timestamp or eot; each timestamp past the
    largest before it, or equal to it where it follows such a lone
    timestamp. Returns (row, position, rule) for each break."""
    ts = config.timestamp_begin
    bad = []
    for i, row in enumerate(tokens.tolist()):
        gen = row[p:]
        if config.eot_id in gen:
            gen = gen[:gen.index(config.eot_id)]
        if gen and not ts <= gen[0] <= ts + 50:
            bad.append((i, p, "first"))
        top = ts - 1
        for j, t in enumerate(gen):
            if t == config.notimestamps_id:
                bad.append((i, p + j, "notimestamps"))
            prev = gen[j - 1] >= ts if j >= 1 else False
            prev2 = gen[j - 2] >= ts if j >= 2 else False
            if prev and prev2 and t >= ts:
                bad.append((i, p + j, "third timestamp"))
            if prev and not prev2 and t < config.eot_id:
                bad.append((i, p + j, "text after a lone timestamp"))
            if t >= ts:
                if t < (top if prev and not prev2 else top + 1):
                    bad.append((i, p + j, "decreasing"))
                top = max(top, t)
    return bad


def _modes_eval(model, device: str = "cuda") -> dict:
    """The eval CLI in process on the eval phase's corpus in the other
    modes: beam-sample (``--do_sample`` at the CLI's beam 5), contrastive
    search (``--penalty_alpha=1 --top_k=5``) and the timestamp grammar
    (``--timestamps``): launches against the model calls, the tag and files
    of each, its ``--timing`` phases and utterances/s."""
    config, model_dir, _ = model
    tmp = os.path.dirname(model_dir)
    corpus, tokenizer = _eval_corpus(tmp, config.eot_id)
    base = [f"--test_data={os.path.join(corpus, 'all.jsonl')}",
            f"--model_path={model_dir}", f"--tokenizer={tokenizer}",
            "--eeg_ch=208", f"--batch_size={EVAL_BATCH}",
            f"--max_new_tokens={EVAL_NEW_TOKENS}", "--per_sentence=True",
            "--timing=True", f"--device={device}"]
    runs = {"beam_sample5": ["--do_sample=True"],
            "contrastive5": ["--penalty_alpha=1", "--top_k=5"],
            "beam5": ["--timestamps=True"]}
    out = {}
    for tag, flags in runs.items():
        out_dir = os.path.join(tmp, f"eval_modes_{tag}")
        _reset_counts()
        with count_model_calls() as calls:
            run = _run_eval(base + flags + [f"--output_dir={out_dir}"])
        launches = _kernel_counts()
        _check_serving_launches(f"modes eval {tag}", config, calls, launches)
        files = _result_files(out_dir)
        names = {f"all_{tag}{ext}" for ext in
                 (".txt", ".jsonl", ".json", "_per_sentence.jsonl")}
        check(set(files) == names, f"modes eval {tag}: files {sorted(files)}")
        rows = files[f"all_{tag}.jsonl"].decode().splitlines()
        check(len(rows) == EVAL_CLIPS, f"modes eval {tag}: {len(rows)} rows")
        check(all(math.isfinite(float(v)) for v in run["metrics"].values()),
              f"modes eval {tag}: non-finite metric {run['metrics']}")
        timing = run["timing"]
        out[" ".join(flags)] = {
            "tag": tag, "timing_s": timing, "wall_s": run["wall_s"],
            "utterances_per_s_decode": EVAL_CLIPS / timing["decode"],
            "utterances_per_s_end_to_end": EVAL_CLIPS / timing["total"],
            "launches": launches, "model_calls": calls,
            "metrics": {k: float(v) for k, v in run["metrics"].items()}}
    return out


def phase_modes(model, device: str = "cuda") -> dict:
    """Every other decode mode of serving on the serving model, each request
    of MODES_BATCH clips and MODES_NEW_TOKENS new tokens timed (median of
    MODES_REPEATS) with K1/K6/K7 launches held against the model calls:
    sampling, beam-sample, contrastive search, int8 weights and token
    timestamps, then the eval CLI in those modes."""
    import dataclasses

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode import generate as dg
    from neuspeech1_tpu_torch.decode.timestamps import cross_attention_maps
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.models.quantize import quantization_error
    from neuspeech1_tpu_torch.serve import Transcriber

    config, model_dir, tokenizer = model
    kw = dict(tokenizer=tokenizer, batch_size=MODES_BATCH,
              max_new_tokens=MODES_NEW_TOKENS, device=device)
    signals = _signals(208, 4 * config.max_source_positions)[:MODES_BATCH]
    out = {"phase": "modes", "model": "whisper-base", "stem": "base/208",
           "batch_size": MODES_BATCH, "max_new_tokens": MODES_NEW_TOKENS}

    def width1(calls):
        return calls["width1"]

    # ---- sampling
    tr = Transcriber(model_dir, **kw, **SAMPLE_SETTINGS)
    gen = tr.gen
    p = tr.prompt.shape[1]
    req = _timed_requests("modes sample", config,
                          lambda: tr.transcribe(signals), width1)
    feats = common.upload_features(tr._prepare(signals), tr.model.dtype,
                                   tr.device)
    prompt = torch.as_tensor(np.repeat(tr.prompt, MODES_BATCH, axis=0),
                             device=tr.device)

    def seeded(g, seed=0):
        return dg.generate(tr.model, feats, prompt, g,
                           generator=torch.Generator(device=device)
                           .manual_seed(seed))

    with torch.no_grad():
        a, b = seeded(gen), seeded(gen)
        check(torch.equal(a, b), "modes sample: one seed, other tokens")
        top1 = seeded(dataclasses.replace(gen, top_k=1))
        greedy = dg.greedy_decode(tr.model, feats, prompt,
                                  dataclasses.replace(gen, do_sample=False))
        ties = _first_diffs_tied(tr.model, feats, prompt, greedy, top1, p)
        check(ties["all_ties"], f"modes sample: top_k=1 parts from greedy "
              f"where greedy's logits hold no tie: {ties}")
        noise = [dg.gumbel_noise(torch.Generator(device=device).manual_seed(7))
                 for _ in range(2)]
        tok_k = dg.sample_decode(tr.model, feats, prompt, gen,
                                 sample_noise=noise[0])
        with _plain_kernels():
            tok_p = dg.sample_decode(tr.model, feats, prompt, gen,
                                     sample_noise=noise[1])
    prof = _profile_request(lambda: tr.transcribe(signals))
    req.pop("out")
    out["sample"] = {
        **{k: v for k, v in SAMPLE_SETTINGS.items()}, **req,
        "same_seed_same_tokens": True, "top_k_1_vs_greedy": ties,
        "token_agreement_kernels_vs_plain": _agreement(tok_k, tok_p, p),
        "kernels_per_step": prof["kernel_launches"] / req["steps_per_request"],
        "device_idle_share": prof["device_idle_share"],
        "device_busy_ms": prof["device_busy_ms"]}

    # ---- beam-sample at the eval CLI's settings
    tr = Transcriber(model_dir, **kw, **BEAM_SETTINGS, do_sample=True)
    req = _timed_requests("modes beam_sample", config,
                          lambda: tr.transcribe(signals), width1)
    with torch.no_grad():
        a, b = seeded(tr.gen), seeded(tr.gen)
        check(torch.equal(a, b), "modes beam_sample: one seed, other tokens")
        zero = dg.beam_search(tr.model, feats, prompt, tr.gen,
                              sample_noise=lambda c, shape: torch.zeros(
                                  shape, device=device))[0]
        beam = dg.beam_search(tr.model, feats, prompt, dataclasses.replace(
            tr.gen, do_sample=False))[0]
    check(torch.equal(zero, beam), "modes beam_sample: zero noise and "
          "identity warpers part from beam search")
    req.pop("out")
    out["beam_sample"] = {**BEAM_SETTINGS, **req,
                          "same_seed_same_tokens": True,
                          "zero_noise_equals_beam_search": True}

    # ---- contrastive search (the reference's strategy)
    tr = Transcriber(model_dir, **kw)
    gen_c = dataclasses.replace(tr.gen, **CONTRASTIVE_SETTINGS)
    req = _timed_requests("modes contrastive", config,
                          lambda: _request(tr, signals, gen_c), width1)
    calls = req["model_calls"]
    check(calls["width1"] == calls["cached_decoder"] - MODES_REPEATS,
          f"modes contrastive: calls {calls}")
    with torch.no_grad():
        tok_k = req.pop("out")
        with _plain_kernels():
            tok_p = _request(tr, signals, gen_c)
    prof = _profile_request(lambda: _request(tr, signals, gen_c))
    out["contrastive"] = {
        **CONTRASTIVE_SETTINGS, **req,
        "k6_query_rows": CONTRASTIVE_SETTINGS["top_k"],
        "k7_rows": MODES_BATCH * CONTRASTIVE_SETTINGS["top_k"],
        "token_agreement_kernels_vs_plain": _agreement(tok_k, tok_p, p),
        "kernels_per_step": prof["kernel_launches"] / req["steps_per_request"],
        "device_idle_share": prof["device_idle_share"],
        "device_busy_ms": prof["device_busy_ms"]}

    # ---- int8 weights, greedily, beside the bf16 weights
    with torch.no_grad():
        bf16 = _request(tr, signals, tr.gen)
    tr8 = Transcriber(model_dir, **kw, int8_weights=True)
    req = _timed_requests("modes int8_weights", config,
                          lambda: tr8.transcribe(signals), width1)
    with torch.no_grad():
        i8 = _request(tr8, signals, tr8.gen)
    params, _, _ = common.load_full_model(model_dir)
    req.pop("out")
    out["int8_weights"] = {
        **req, "quantization_error": quantization_error(params),
        "token_agreement_with_bf16": _agreement(i8, bf16, p)}

    # ---- token timestamps, and the grammar in greedy and beam decoding
    trt = Transcriber(model_dir, **dict(kw, batch_size=MODES_TS_CLIPS))
    clips = signals[:MODES_TS_CLIPS]
    trt.transcribe_with_timestamps(clips[:1])    # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    with count_model_calls() as calls:
        t0 = time.perf_counter()
        rows = trt.transcribe_with_timestamps(clips)
        torch.cuda.synchronize()
        ts_s = time.perf_counter() - t0
    launches = _kernel_counts()
    _check_serving_launches("modes timestamps", config, calls, launches)
    check(calls["encoder"] == 2 * MODES_TS_CLIPS,
          f"modes timestamps: {calls['encoder']} encoder calls")
    check(len(rows) == MODES_TS_CLIPS and all(rows),
          f"modes timestamps: rows {[len(r) for r in rows]}")
    check(all(0.0 <= r["start"] <= r["end"] <= 30.0 for row in rows
              for r in row), "modes timestamps: a start past its end or 30 s")
    ts_prompt = torch.as_tensor(np.repeat(np.asarray(
        [tr.tokenizer.prefix_tokens(tr.language, tr.task, True)]),
        MODES_BATCH, axis=0), device=device)
    pt = ts_prompt.shape[1]
    grammar = {}
    with torch.no_grad():
        for name, g in (("greedy", dataclasses.replace(
                tr.gen, timestamps=True, max_length=pt + MODES_NEW_TOKENS)),
                        ("beam5", dataclasses.replace(
                            tr.gen, timestamps=True, **BEAM_SETTINGS,
                            max_length=pt + MODES_NEW_TOKENS))):
            toks = dg.generate(tr.model, feats, ts_prompt, g)
            bad = _grammar_violations(toks.cpu(), pt, config)
            check(not bad, f"modes timestamps: {name} breaks the grammar: "
                  f"{bad[:5]}")
            n_ts = int((toks[:, pt:] >= config.timestamp_begin).sum())
            check(n_ts >= MODES_BATCH, f"modes timestamps: {name} wrote "
                  f"{n_ts} timestamps")
            grammar[name] = {"timestamps": n_ts, "violations": 0}
        maps_toks = toks[:MODES_TS_CLIPS]
        enc = tw.encoder_apply(tr.model, feats[:MODES_TS_CLIPS])
        maps = cross_attention_maps(tr.model, maps_toks, enc)
        with _f32_compute(tr.model):
            maps32 = cross_attention_maps(tr.model, maps_toks, enc)
    diff = (maps - maps32).abs()
    maps_max, maps_mean = diff.max().item(), diff.mean().item()
    p_max, p_mean = maps32.max().item(), maps32.mean().item()
    check(bool(torch.isfinite(maps).all()), "modes timestamps: non-finite maps")
    check(maps_max <= MAPS_MAX_REL_TOL * p_max
          and maps_mean <= MAPS_MEAN_REL_TOL * p_mean,
          f"modes timestamps: maps off f32 by max {maps_max} (largest p "
          f"{p_max}), mean {maps_mean} (mean p {p_mean})")
    out["timestamps"] = {
        "clips": MODES_TS_CLIPS, "wall_s": ts_s, "launches": launches,
        "model_calls": calls, "tokens_per_clip": [len(r) for r in rows],
        "sample_row": rows[0][:4], "grammar": grammar,
        "maps_max_abs_err": maps_max, "maps_mean_abs_err": maps_mean,
        "maps_max_p": p_max, "maps_mean_p": p_mean,
        "maps_rel_tol": [MAPS_MAX_REL_TOL, MAPS_MEAN_REL_TOL]}

    out["eval"] = _modes_eval(model, device)
    check(_jax_free(), "jax or the JAX package was imported")
    out["card"] = card()
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
                library="sdpa_bwd" if bf16_ops else "sdpa_bwd_f32"))
    for bq in (512, 256, 192):
        out.append(dict(tag=f"bwd_btc_bq{bq}", kernel="probe_bwd",
                        replaces="perf/btc_probe.py:132", ops="f32", btc=True,
                        make=functools.partial(bp.make_bwd_btc, bq),
                        library="sdpa_bwd_f32"))
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
    mask (forward; its autograd backward for the backward, which recomputes
    its own lse: timed only; on f32 copies of the inputs for the
    f32-operand backward), ``torch.bmm`` for the dot."""
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
    if v["library"] == "sdpa_bwd_f32":
        q, k, v_ = (x.float() for x in (q, k, v_))
    q, k, v_ = (x.detach().requires_grad_() for x in (q, k, v_))
    o = F.scaled_dot_product_attention(q, k, v_, attn_mask=mask)
    do = torch.randn_like(o)
    return lambda: torch.autograd.grad(o, (q, k, v_), do, retain_graph=True)


def _probe_cost(v, args):
    """(bytes, operations, peak) of one call: each input read once, each
    output written once; the products over the kept key columns (the
    f32-operand backward's as the bf16 tensor-core passes of its exact
    split)."""
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
    # s and dp one bf16 pass each; dv, dk and dq one per term of the split
    # of p and ds (three in f32 mode): 5 or 11 passes
    from neuspeech1_tpu_torch.ops.probe_bwd import PASSES

    passes = 2 + 3 * PASSES[v["ops"]]
    n_bytes = 8 * args[0].numel() * 2 + 4 * n_heads_rows
    return n_bytes, 2 * passes * n_heads_rows * kept * PROBE_D, BF16_FLOPS


def _sdpa_f32_library(gen) -> dict:
    """What SDPA's f32 backward with the key mask runs: its device kernels
    (by name, under the profiler) and how far its gradients lie from a
    float64 computation of the same function on 8 heads, relative to the
    largest |gradient|: about 1e-6 for f32 products, 1e-3 for TF32. Only
    an f32-class result stands as the f32-operand backward's library
    call."""
    import torch.nn.functional as F

    shape = (8, 1, PROBE_TK, PROBE_D)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    mask = (torch.arange(PROBE_TK, device="cuda") < PROBE_T).view(1, 1, 1, -1)

    def grads(dtype):
        xs = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*xs, attn_mask=mask)
        return torch.autograd.grad(o, xs, do.to(dtype))

    names = _profiled(
        lambda: grads(torch.float32), 1,
        lambda events: sorted({e.key[:120] for e in events
                               if e.device_type.name == "CUDA" and any(
                                   w in e.key.lower() for w in (
                                       "fmha", "attention", "flash", "gemm",
                                       "cudnn", "cutlass", "softmax", "bmm",
                                       "mem_eff"))}), bool)
    err = max(_rel_err(a, b) for a, b in zip(grads(torch.float32),
                                             grads(torch.float64)))
    return {"kernels": names, "rel_err_vs_f64": err,
            "f32_products": err <= 1e-5}


def _bit_share(got, ref) -> float:
    """The share of the outputs' elements bit-equal to the reference's."""
    same = sum(int((g == r).sum()) for g, r in zip(got, ref))
    return same / sum(r.numel() for r in ref)


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
        """The kernel's outputs against the plain version's on ``args``;
        (the outputs, the error, its bound)."""
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
        return got, err, tol

    for v in variants:
        checked(v, make(v, PROBE_DOT_CHECK_GRID),
                _probe_arrays(v, gen, PROBE_CHECK_BH), "reduced")

    # SDPA's f32 backward stands as the f32-operand backward's library call
    # only if its products are f32
    sdpa_f32 = _sdpa_f32_library(gen)
    emit({"phase": "probes", "k": "sdpa_bwd_f32", **sdpa_f32})
    lines = []
    _reset_counts()
    for v in variants:
        args = _probe_arrays(v, gen, PROBE_BH)
        run = make(v, PROBE_DOT_GRID)
        got, err, tol = checked(v, run, args, "full shape")
        share = {}
        if v["kernel"] == "probe_bwd":
            # the outputs bit-equal to the f32 gold: the f32 mode's at its
            # floor, the bf16 mode's for comparison
            share["f32_gold_share"] = _bit_share(
                got, _probe_plain(dict(v, ops="f32"), args))
            check(v["ops"] != "f32" or share["f32_gold_share"] >=
                  PROBE_BWD_F32_SHARE_FLOOR,
                  f"probe {v['tag']}: {share['f32_gold_share']} of the "
                  f"outputs bit-equal to the f32 gold, under the floor "
                  f"{PROBE_BWD_F32_SHARE_FLOOR}")
        del got
        torch.cuda.empty_cache()
        lib = (None if v["library"] == "sdpa_bwd_f32"
               and not sdpa_f32["f32_products"] else _probe_library(v, args))
        n_bytes, flops, peak = _probe_cost(v, args)
        res = {"phase": "probes", "k": v["tag"], "kernel": v["kernel"],
               "replaces": v["replaces"], "max_abs_err": err, "tol": tol,
               **share,
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
    # the wrappers' host time per call (20 calls queued without a
    # synchronize, the least of 5 runs), after the launches are counted
    for v, res in zip(variants, lines):
        args = _probe_arrays(v, gen, PROBE_BH)
        run = make(v, PROBE_DOT_GRID)
        res["host_us"] = _host_us(lambda: run(*args), calls=20, repeats=5)
        emit({"phase": "probes", "k": v["tag"], "host_us": res["host_us"]})
        del args
        torch.cuda.empty_cache()

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
           "sdpa_bwd_f32": sdpa_f32, "card": card()}
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
                 seq_parallel_axis=None, shard: bool = False,
                 ft_full: bool = False, pipeline_axis=None):
    """The bench configuration on the card: whisper-base with the 'base'
    stem over 208 channels, f32 masters computing in bf16, LoRA r=32 alpha=64
    on encoder q/k/v/out/fc1/fc2 from seeds, AdamW with warmup, and a
    synthetic batch from a seeded numpy generator (bench.py's recipe);
    with ``seq_parallel_axis`` the encoder's self-attention runs the ring
    over that axis of the ambient mesh, with ``pipeline_axis`` both stacks
    run GPipe over that axis (P microbatches); with ``shard`` the model is
    split
    over the ambient mesh's fsdp and tensor axes
    (``parallel/sharding.py::shard_params``); with ``ft_full`` every leaf
    trains and there are no adapters."""
    import dataclasses

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    config, stem = common.preset_model("base", "base", in_channels=208)
    config = dataclasses.replace(config, seq_parallel_axis=seq_parallel_axis,
                                 pipeline_axis=pipeline_axis)
    model = module_from_params(init_params(config, stem, seed=0), config, stem,
                               device=device, dtype=torch.float32)
    if shard:
        from neuspeech1_tpu_torch.parallel import sharding

        sharding.shard_params(model)
    lora = (None if ft_full else
            init_lora(config, rank=32, alpha=64, seed=1, device=device))
    tx = optimizer.make_optimizer(peak_lr=1e-3, warmup_steps=500,
                                  total_steps=100_000)
    state, frozen = trainstep.init_train_state(
        model, lora, tx, optimizer.default_trainable_pred(ft_full=ft_full))
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
    """The model with its config's ``changes`` while the context is open;
    yields that config, the one a loss or step on the model must be built
    from (`train/trainstep.py::check_model_config`)."""
    import dataclasses

    config = model.config
    model.config = dataclasses.replace(config, **changes)
    try:
        yield model.config
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


def _grad_check(name, make_loss, state, frozen, batch, expect) -> dict:
    """One step's gradients on the kernels, on the plain versions and on
    the f32 reference, at the adapters' present state, through the loss
    ``make_loss`` builds from a config (the model's, then the f32
    reference's). Checks the kernels
    against the plain versions (GRAD_REL_TOL, LOSS_TOL), and that the
    kernels lie no further from the f32 reference than WITNESS_FACTOR
    times the plain versions do (worst leaf)."""
    _reset_counts()
    loss_fn = make_loss(frozen.model.config)
    loss_k, g_k = _grads(loss_fn, state, frozen, batch)
    check(_kernel_counts() == expect, f"gradient check {name} missed a kernel")
    _reset_counts()
    with _plain_kernels():
        loss_p, g_p = _grads(loss_fn, state, frozen, batch)
        with _f32_compute(frozen.model) as c32:
            loss_32, g_32 = _grads(make_loss(c32), state, frozen, batch)
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
    make_loss = functools.partial(make_loss_fn, stem=stem, fold_lora=True)
    checks = [_grad_check("after_timed_steps", make_loss, state, frozen, small,
                          expect)]
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for _, e in entries(frozen.lora):
            e["B"].copy_(TRAINED_B_STD * torch.randn(e["B"].shape,
                                                     generator=gen))
    checks.append(_grad_check("trained_b", make_loss, state, frozen, small,
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
        loss_sp, g_sp = _grads(make_loss_fn(config, stem, fold_lora=True),
                               state, frozen, small)
        with _replaced_config(frozen.model, seq_parallel_axis=None) as c1:
            loss_1, g_1 = _grads(make_loss_fn(c1, stem, fold_lora=True),
                                 state, frozen, small)
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


# --------------------------------------------------------------------------
# finetune: the fine-tune CLI at its defaults, resume, remat, merge
# --------------------------------------------------------------------------

def _finetune_corpus(tmp: str, vocab_size: int, with_audio: bool = False):
    """FT_TRAIN + FT_VAL synthetic 2-10 s clips over 208 channels
    (``data/synthetic.py``; with their 16 kHz wavs when ``with_audio``),
    written as their own train and val manifests, the first FT_EVAL val
    clips as a third, and the eval phase's word vocabulary: (corpus dir,
    tokenizer spec)."""
    from neuspeech1_tpu_torch.data.manifest import write_jsonlines
    from neuspeech1_tpu_torch.data.synthetic import (_WORDS,
                                                     make_synthetic_corpus)

    root = os.path.join(tmp, "ft_corpus")
    rows = make_synthetic_corpus(root, n_clips=FT_TRAIN + FT_VAL,
                                 n_channels=208, min_dur=EVAL_DURATION_S[0],
                                 max_dur=EVAL_DURATION_S[1], seed=1,
                                 with_audio=with_audio)
    write_jsonlines(os.path.join(root, "train.jsonl"), rows[:FT_TRAIN])
    write_jsonlines(os.path.join(root, "val.jsonl"), rows[FT_TRAIN:])
    write_jsonlines(os.path.join(root, "eval.jsonl"),
                    rows[FT_TRAIN:FT_TRAIN + FT_EVAL])
    vocab = os.path.join(tmp, "ft_vocab.txt")
    words = list(_WORDS) + [f"w{i}" for i in range(len(_WORDS), vocab_size)]
    with open(vocab, "w") as f:
        f.write("\n".join(words) + "\n")
    return root, f"word:{vocab}"


def _step_launches(config) -> dict:
    """K1, K2 and K3 per training step at FT_LABEL_LEN labels: K1 and K2
    in every encoder self-attention and every decoder cross-attention (and
    decoder self-attention from ``decoder_flash_self_min_q`` labels on), K3
    in every encoder fc adapter."""
    blocks = config.encoder_layers + config.decoder_layers * (
        1 + (FT_LABEL_LEN >= config.decoder_flash_self_min_q))
    return {"K1": blocks, "K2": blocks, "K3": 2 * config.encoder_layers,
            "K4": 0, "K4_bwd": 0, "K6": 0, "K7": 0, "K8": 0}


@contextlib.contextmanager
def _instrumented_finetune(rec: dict):
    """Records, while open, what a finetune run does: each train step's
    kernel launches and a CUDA event on each side of it (no synchronize:
    the loop runs as it would; `_run_finetune` reads the step's device span
    from the events after the run), each
    ``Trainer._adalora_update``'s host ms (no synchronize inside) and, at
    an allocation, the kept ranks beside the schedule's budget, each
    checkpoint save's ms and bytes, and the state a resume restored."""
    from neuspeech1_tpu_torch.models import lora as tl
    from neuspeech1_tpu_torch.train import trainer as trmod
    from neuspeech1_tpu_torch.train import trainstep as ts
    from neuspeech1_tpu_torch.train.checkpoint import CheckpointManager

    make_step = ts.make_train_step
    update = trmod.Trainer._adalora_update
    save = CheckpointManager.save
    restore = CheckpointManager.restore_latest

    def timed_make_step(*a, **k):
        step = make_step(*a, **k)

        def timed(state, frozen, batch):
            before = _kernel_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = step(state, frozen, batch)
            ev[1].record()
            rec["steps"].append({
                "step": state.step, "events": ev,
                "launches": {n: c - before[n]
                             for n, c in _kernel_counts().items()}})
            return m

        return timed

    def timed_update(self, step_num):
        pattern = self._adalora_pattern
        t0 = time.perf_counter()
        update(self, step_num)
        host_ms = 1e3 * (time.perf_counter() - t0)
        lora = self.frozen.lora
        cfg = self.adalora
        total = cfg["total_steps"]
        budget, mask_ind = tl.adalora_budget_schedule(
            step_num, tl.adalora_total_ranks(lora),
            cfg["target_r"] * tl.adalora_matrix_count(lora), cfg["tinit"],
            cfg["tfinal"], total, cfg["deltaT"])
        allocated = (pattern is None and
                     (mask_ind or step_num == total - cfg["tfinal"]))
        entry = {"step": step_num, "host_ms": host_ms,
                 "allocated": allocated,
                 "pattern_applied": pattern is not None}
        if allocated:
            entry["budget"] = budget
            entry["kept"] = int(sum(e["mask"].sum().item()
                                    for _, e in tl.adalora_entries(lora)))
        rec["adalora"].append(entry)

    def timed_save(self, state, eval_loss=None, force=False):
        t0 = time.perf_counter()
        done = save(self, state, eval_loss=eval_loss, force=force)
        self.wait()
        path = os.path.join(self.directory, str(int(state.step)), "state.pt")
        if done and os.path.exists(path):
            rec["saves"].append({"step": int(state.step),
                                 "ms": 1e3 * (time.perf_counter() - t0),
                                 "bytes": os.path.getsize(path)})
        return done

    def kept_restore(self, state, step=None):
        out = restore(self, state, step=step)
        rec["restored"] = {"step": state.step, "trainable": {
            k: t.detach().to("cpu", copy=True)
            for k, t in state.trainable.items()}}
        return out

    ts.make_train_step = timed_make_step
    trmod.Trainer._adalora_update = timed_update
    CheckpointManager.save = timed_save
    CheckpointManager.restore_latest = kept_restore
    try:
        yield rec
    finally:
        ts.make_train_step = make_step
        trmod.Trainer._adalora_update = update
        CheckpointManager.save = save
        CheckpointManager.restore_latest = restore


def _run_finetune(argv) -> dict:
    """``cli.finetune.main(argv)`` in process, instrumented: the recorded
    steps, allocations, saves and restore, its [finetune] and [train]
    lines, the metrics.jsonl records, the final trainable tensors on the
    host, the peak device memory and the wall time."""
    import io

    from neuspeech1_tpu_torch.cli import finetune

    rec = {"steps": [], "adalora": [], "saves": [], "restored": None}
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _instrumented_finetune(rec), contextlib.redirect_stdout(buf):
        state = finetune.main(argv)
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    for s in rec["steps"]:
        start, end = s.pop("events")
        s["ms"] = start.elapsed_time(end)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["lines"] = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith(("[finetune]", "[train] resumed"))]
    out_dir = next(a.split("=", 1)[1] for a in argv
                   if a.startswith("--output_dir="))
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rec["records"] = [json.loads(ln) for ln in f]
    rec["final"] = {k: t.detach().to("cpu", copy=True)
                    for k, t in state.trainable.items()}
    rec["state_step"] = state.step
    return rec


def _ft_model(base_npz, config, stem, adapter=None, device="cuda"):
    """(state, frozen) of a training model with f32 masters from the base
    npz and AdaLoRA adapters (init_r FT_RANK): fresh ones (E = 0) from the
    CLI's seed, or ``adapter``'s (an adapter_final.npz: the trained tree and
    the stem overrides)."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                     load_npz,
                                                     module_from_params)
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    params = load_npz(base_npz)
    if adapter is None:
        lora = init_lora(config, rank=FT_RANK, alpha=32.0, adalora=True,
                         seed=2, device=device)
    else:
        params, lora_np = common.apply_adapter(params,
                                               common.load_adapter(adapter))
        lora = lora_from_params(lora_np, device=device)
    model = module_from_params(params, config, stem, device=device,
                               dtype=torch.float32)
    return trainstep.init_train_state(model, lora, optimizer.make_optimizer())


def _ft_batch(corpus, tokenizer, config, n: int, device="cuda"):
    """The first ``n`` train clips collated as the CLI collates them, on
    the device."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import EEGDataset
    from neuspeech1_tpu_torch.data.device_cache import to_device_batch

    tok = common.resolve_tokenizer(tokenizer, config)
    ds = EEGDataset(os.path.join(corpus, "train.jsonl"), tok, mode="train",
                    modal_ch=208, language="English")
    coll = Collator(pad_id=tok.pad_id, decoder_start_id=config.sot_id,
                    max_label_len=FT_LABEL_LEN, feature_dtype="bfloat16",
                    eot_id=config.eot_id)
    return to_device_batch(coll([ds[i] for i in range(n)]), device)


def _remat_settings():
    """(name, config changes) of no remat and every remat policy of
    ``models/whisper.py::REMAT_POLICIES`` (None, full recompute, is
    'full')."""
    from neuspeech1_tpu_torch.models.whisper import REMAT_POLICIES

    return [("none", {})] + [
        (p or "full", {"remat": True, "remat_policy": p})
        for p in REMAT_POLICIES]


def _remat_extra_k1(name: str, config) -> int:
    """K1 launches a policy adds to a step: the backward runs each encoder
    layer's flash forward again unless the policy keeps its o and lse
    (full recompute, 'dots' and 'attn' do not)."""
    return config.encoder_layers if name in ("full", "dots", "attn") else 0


def _remat_grad_check(config, stem, state, frozen, batch,
                      orth_reg_weight: float = 0.5) -> dict:
    """One step's loss and gradients with each encoder layer under a
    checkpoint, for every remat policy, against the step without, on the
    kernels: the same bounds as the kernels against the plain versions; K1
    runs once more per layer where the policy recomputes the flash forward
    (`_remat_extra_k1`), and K2 and K3 as often as without remat."""
    import dataclasses

    from neuspeech1_tpu_torch.train.trainstep import make_loss_fn

    out = {}
    ref = None
    for name, changes in _remat_settings():
        c = dataclasses.replace(config, **changes)
        with _replaced_config(frozen.model, **changes):
            _reset_counts()
            loss, grads = _grads(make_loss_fn(
                c, stem, orth_reg_weight=orth_reg_weight, fold_lora=True),
                state, frozen, batch)
            counts = _kernel_counts()
        if ref is None:
            ref = (loss, grads, counts)
            continue
        errs = _leaf_errs(grads, ref[1])
        out[name] = {"loss": loss, "loss_no_remat": ref[0],
                     "grad_rel_err": errs["max"], "leaf": errs["leaf"],
                     "K1": counts["K1"], "K1_no_remat": ref[2]["K1"]}
        check(errs["max"] <= GRAD_REL_TOL,
              f"remat {name}: grads off the step without remat: "
              f"{errs['leaf']} {errs['max']}")
        check(abs(loss - ref[0]) <= LOSS_TOL * abs(ref[0]),
              f"remat {name}: loss {loss}, without remat {ref[0]}")
        want = dict(ref[2], K1=ref[2]["K1"] + _remat_extra_k1(name, config))
        check(counts == want, f"remat {name}: launches {counts}, expected "
              f"{want}")
    return out


def _adalora_split(config, stem, state, frozen, batch) -> dict:
    """Where the AdaLoRA step's time goes, at the CLI's batch and labels on
    the trained adapters: ms per step (one synchronize after each, median
    of FT_SPLIT_STEPS after one warm-up) with neither the orthogonality
    loss nor the importance EMAs, with the loss, and with both; the
    `train` phase's LoRA step (r=32, alpha 64, the same targets) on the
    same model and batch; and the loss's forward and backward and one EMA
    update alone (CUDA events)."""
    from neuspeech1_tpu_torch.models import lora as tl
    from neuspeech1_tpu_torch.train import optimizer
    from neuspeech1_tpu_torch.train.trainstep import (init_train_state,
                                                      make_train_step)

    tx = optimizer.make_optimizer()
    lora_r32 = init_train_state(frozen.model, tl.init_lora(
        config, rank=32, alpha=64, seed=1,
        device=next(frozen.model.parameters()).device), tx)
    out = {}
    for name, (st, fr), kw in (
            ("no_orth_no_ema", (state, frozen), {}),
            ("orth", (state, frozen), {"orth_reg_weight": 0.5}),
            ("orth_ema", (state, frozen),
             {"orth_reg_weight": 0.5, "track_adalora_importance": True}),
            ("lora_r32", lora_r32, {})):
        step = make_train_step(config, stem, tx, fold_lora=True, **kw)
        ms = []
        for _ in range(FT_SPLIT_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, fr, batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(ms[1:])
    del lora_r32
    lora = frozen.lora

    def orth():
        tl.adalora_orth_loss(lora).backward()

    out["orth_loss_fwd_bwd"] = cuda_ms(orth)
    for _, e in tl.adalora_entries(lora):
        for n in ("A", "B"):
            e[n].grad = None
    grads = {p: {n: torch.randn_like(e[n]) for n in tl.IPT_NAMES}
             for p, e in tl.adalora_entries(lora)}
    out["ema_update"] = cuda_ms(
        lambda: tl.adalora_ipt_update(state.ipt, lora, grads))
    return out


def _merge_weight_check(base_npz, adapter, merged_dir,
                        every_layer: bool = False) -> dict:
    """merge_lora's ``params.npz`` against the merge computed here in
    float64 from the base npz and the adapter npz (W + A diag(E) B *
    alpha / r), layer by layer: each adapted weight off it by at most
    MERGE_REL_TOL of the layer's largest |delta| plus the f32 rounding of
    W + delta (2^-23 of its largest entry), so a merge that drops E,
    scales B wrongly or skips an adapter fails wherever f32 can hold the
    delta; a layer whose ranks were all pruned (delta 0) must come back
    bit for bit. Some layer's delta must be nonzero, and with
    ``every_layer`` each layer's must lie 100 times above its rounding, so
    that a 2% misscaling fails in every layer; every leaf no adapter
    touches must equal the base's or the adapter's override."""
    from neuspeech1_tpu_torch.models.convert import load_npz

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    def adapters(tree, prefix=""):
        if "A" in tree:
            yield prefix, tree
            return
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from adapters(v, f"{prefix}{k}/")

    ad = load_npz(adapter)
    want = dict(flat(load_npz(base_npz)))
    want.update(flat(ad.get("model") or {}))
    got = dict(flat(load_npz(os.path.join(merged_dir, "params.npz"))))
    check(set(got) == set(want), "merge: the merged model's leaves differ "
          f"from the base's: {sorted(set(got) ^ set(want))[:8]}")
    layers = []
    for prefix, e in adapters(ad.get("lora") or {}):
        a = np.asarray(e["A"], np.float64)
        if "E" in e:
            a = a * np.asarray(e["E"], np.float64).transpose(0, 2, 1)
        alpha = np.asarray(e["alpha"], np.float64).reshape(-1, 1, 1)
        delta = a @ np.asarray(e["B"], np.float64) * alpha / a.shape[-1]
        path = f"{prefix}w"
        w_eff = want.pop(path).astype(np.float64) + delta
        merged = got.pop(path)
        for i in range(delta.shape[0]):
            err = float(np.abs(merged[i] - w_eff[i]).max())
            dmax = float(np.abs(delta[i]).max())
            floor = 2.0 ** -23 * float(np.abs(w_eff[i]).max())
            layers.append({"path": path, "layer": i, "err": err,
                           "delta": dmax, "floor": floor})
            check(err <= (MERGE_REL_TOL * dmax + floor if dmax else 0.0),
                  f"merge: {path} layer {i} off the float64 merge by {err}, "
                  f"largest delta {dmax}, f32 rounding {floor}")
    live = [x for x in layers if x["delta"] > 0]
    check(bool(live), "merge: every adapted layer's delta is 0")
    if every_layer:
        low = [x for x in layers if x["delta"] <= 100 * x["floor"]]
        check(not low, f"merge: deltas within 100x f32 rounding: {low[:4]}")
    same = [k for k in want if np.array_equal(got[k], want[k])]
    check(len(same) == len(want), "merge: leaves changed that no adapter "
          f"touches: {sorted(set(want) - set(same))[:8]}")
    return {"layers": len(layers), "layers_pruned_to_zero":
            len(layers) - len(live), "untouched_leaves_equal": len(same),
            "worst_err_over_delta": max(x["err"] / x["delta"] for x in live),
            "delta_range": [min(x["delta"] for x in live),
                            max(x["delta"] for x in live)],
            "delta_over_rounding_max": max(x["delta"] / x["floor"]
                                           for x in live),
            "rel_tol": MERGE_REL_TOL}


def _nonzero_e(adapter: str) -> int:
    """The nonzero AdaLoRA E entries of an adapter npz."""
    with np.load(adapter) as f:
        return int(sum(np.count_nonzero(f[k]) for k in f.files
                       if k.endswith("/E")))


def _refill_e(adapter: str, out: str) -> str:
    """``adapter`` with every AdaLoRA E redrawn from N(0, TRAINED_E_STD^2)
    (seeded), pruned ranks included: a trained magnitude, where the
    fine-tune phase's 14 steps leave E near its initial 0."""
    gen = np.random.default_rng(4)
    with np.load(adapter) as f:
        flat = {k: (TRAINED_E_STD * gen.standard_normal(f[k].shape)).astype(
            f[k].dtype) if k.endswith("/E") else f[k] for k in f.files}
    check(any(k.endswith("/E") for k in flat), "merge: the adapter has no E")
    np.savez(out, **flat)
    return out


def _pred_tokens(out_dir) -> list:
    name = next(f for f in os.listdir(out_dir)
                if f.endswith(".jsonl") and "per_sentence" not in f)
    with open(os.path.join(out_dir, name)) as f:
        return [json.loads(ln)["pred"].split() for ln in f]


def phase_finetune(tr, bm, device: str = "cuda") -> dict:
    """``neuspeech1_tpu_torch.cli.finetune.main`` in process at whisper-base
    width and its defaults (AdaLoRA init_r 12 -> target_r 4, orthogonality
    0.5, --remat=auto, --device_cache=auto, the fold), batch 64, on
    FT_TRAIN + FT_VAL synthetic clips, with a schedule short enough that
    every phase of the rank allocator runs; then a resume, a run with
    remat and rotating shards, one step's gradients against the plain
    versions and f32 (AdaLoRA, orthogonality on), and merge_lora plus the
    eval CLI on the merged model against the eval CLI on the adapter."""
    from neuspeech1_tpu_torch.cli import merge_lora
    from neuspeech1_tpu_torch.models.lora import adalora_budget_schedule
    from neuspeech1_tpu_torch.train import memory as trainmem
    from neuspeech1_tpu_torch.train.trainstep import make_loss_fn

    with tempfile.TemporaryDirectory() as tmp:
        from neuspeech1_tpu_torch.cli import common

        config, model_dir, _ = serving_model(tmp)
        _, _, stem = common.load_full_model(model_dir)
        base_npz = os.path.join(model_dir, "params.npz")
        corpus, tokenizer = _finetune_corpus(tmp, config.eot_id)
        config = common.resolve_tokenizer(tokenizer, config).config
        argv = [f"--train_data={corpus}/train.jsonl",
                f"--val_data={corpus}/val.jsonl",
                f"--base_model={base_npz}", f"--tokenizer={tokenizer}",
                "--eeg_ch=208", f"--per_device_train_batch_size={FT_BATCH}",
                f"--label_max_length={FT_LABEL_LEN}", f"--device={device}",
                *FT_SCHEDULE]
        tinit, tfinal, delta_t = 2, 4, 2
        expect = _step_launches(config)

        # 1. the CLI's defaults, FT_STEPS steps
        run_dir = os.path.join(tmp, "ft_run")
        _reset_counts()
        run = _run_finetune(argv + [f"--max_steps={FT_STEPS}",
                                    f"--output_dir={run_dir}"])
        launches = _kernel_counts()
        for s in run["steps"]:
            check(s["launches"] == expect, f"finetune step {s['step']}: "
                  f"launches {s['launches']}, expected {expect}")
        check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K6", "K7")),
              f"finetune: a kernel of the path never launched: {launches}")
        check(len(run["steps"]) == FT_STEPS, f"finetune: "
              f"{len(run['steps'])} steps")
        losses = [r["loss"] for r in run["records"] if "loss" in r]
        check(all(math.isfinite(x) for x in losses),
              f"finetune: losses {losses}")
        evals = [r for r in run["records"] if "eval_loss" in r]
        check(len(evals) == FT_STEPS // 7 and all(
            math.isfinite(r["eval_loss"]) and 0 <= r["eval_wer"]
            for r in evals), f"finetune: evals {evals}")
        allocs = [a for a in run["adalora"] if a["allocated"]]
        want = [s for s in range(1, FT_STEPS + 1)
                if tinit < s <= FT_STEPS - tfinal and s % delta_t == 0]
        check([a["step"] for a in allocs] == want,
              f"finetune: allocations at {[a['step'] for a in allocs]}, "
              f"the schedule says {want}")
        for a in allocs:
            check(a["kept"] == a["budget"], f"finetune: {a['kept']} ranks "
                  f"kept at step {a['step']}, budget {a['budget']}")
        check(all(a["pattern_applied"] for a in run["adalora"]
                  if a["step"] > FT_STEPS - tfinal),
              "finetune: the frozen pattern was not re-applied")
        corpus_bytes = FT_TRAIN * 208 * 6000 * 2
        plan = trainmem.train_memory_plan(
            config, stem, FT_BATCH,
            trainable_count=trainmem.trainable_count_estimate(
                config, stem, ft_full=False, adalora=True),
            corpus_bytes=corpus_bytes, label_len=FT_LABEL_LEN,
            device=device)
        timed = [s["ms"] for s in run["steps"][2:]]
        step_ms = statistics.median(timed)
        # the CLI's own rate: its loop between two logging records, with
        # nothing added (at --logging_steps=1 the loop reads the loss at
        # every step; the records after an eval step hold that eval)
        cli_rate = {r["step"]: r["samples_per_sec"] for r in run["records"]
                    if "samples_per_sec" in r}

        # the 14-step adapter, kept before the resume below rewrites
        # adapter_final.npz; its nonzero E are the ranks the last
        # allocation kept
        adapter = os.path.join(tmp, "ft_adapter_final_14.npz")
        os.replace(os.path.join(run_dir, "adapter_final.npz"), adapter)
        nonzero_e = {"after_steps": _nonzero_e(adapter)}
        check(nonzero_e["after_steps"] == allocs[-1]["kept"],
              f"finetune: {nonzero_e['after_steps']} nonzero E in the "
              f"adapter, {allocs[-1]['kept']} ranks kept")

        # 2. resume from the latest checkpoint, two more steps
        resumed = _run_finetune(argv + [
            f"--max_steps={FT_STEPS + 2}", f"--output_dir={run_dir}",
            "--resume_from_checkpoint=latest"])
        restored = resumed["restored"]
        check(restored is not None and restored["step"] == FT_STEPS,
              f"resume: restored {restored and restored['step']}")
        check(set(restored["trainable"]) == set(run["final"]) and all(
            torch.equal(restored["trainable"][k], t)
            for k, t in run["final"].items()),
            "resume: the restored tensors differ from the saved ones")
        check([s["step"] for s in resumed["steps"]] ==
              [FT_STEPS + 1, FT_STEPS + 2],
              f"resume: steps {[s['step'] for s in resumed['steps']]}")
        # the importance EMAs and the frozen pattern are not saved (the
        # JAX package's semantics), so a resume inside the final phase
        # masks on zero scores (ROADMAP queue 3): recorded, not checked
        nonzero_e["after_resume"] = _nonzero_e(
            os.path.join(run_dir, "adapter_final.npz"))

        # 3. remat and rotating shards, a fresh run
        remat_dir = os.path.join(tmp, "ft_remat")
        remat = _run_finetune(argv + [
            f"--max_steps={FT_REMAT_STEPS}", f"--output_dir={remat_dir}",
            "--remat=True", f"--device_cache_budget_mb={FT_ROTATE_MB}",
            "--eval_wer=False"])
        check(any("rotating" in ln for ln in remat["lines"]),
              f"remat run: the corpus did not rotate: {remat['lines']}")
        for s in remat["steps"]:
            check(s["launches"] == expect, f"remat step {s['step']}: "
                  f"launches {s['launches']}, expected {expect}")

        # 4. one step's gradients: remat against none, then the kernels
        # against the plain versions and f32 at E = 0 and trained
        batch = _ft_batch(corpus, tokenizer, config, GRAD_CHECK_BATCH,
                          device)
        state, frozen = _ft_model(base_npz, config, stem, adapter, device)
        remat_check = _remat_grad_check(config, stem, state, frozen, batch)
        make_loss = functools.partial(make_loss_fn, stem=stem,
                                      orth_reg_weight=0.5, fold_lora=True)
        checks = [_grad_check("adalora_trained", make_loss, state, frozen,
                              batch, expect)]
        split = _adalora_split(config, stem, state, frozen, _ft_batch(
            corpus, tokenizer, config, FT_BATCH, device))
        del state, frozen
        state, frozen = _ft_model(base_npz, config, stem, device=device)
        checks.insert(0, _grad_check("adalora_e0", make_loss, state, frozen,
                                     batch, expect))
        del state, frozen
        torch.cuda.empty_cache()

        # 5. merge, then the eval CLI on the merged model and on the adapter
        merged = merge_lora.main([
            f"--lora_model={adapter}", f"--base_model={base_npz}",
            f"--tokenizer={tokenizer}", "--eeg_ch=208", f"--device={device}",
            f"--output_dir={os.path.join(tmp, 'ft_merged')}"])
        wide = _refill_e(adapter, os.path.join(tmp, "ft_adapter_e.npz"))
        merge_weights = {
            "trained": _merge_weight_check(base_npz, adapter, merged),
            "e_redrawn": _merge_weight_check(base_npz, wide, merge_lora.main([
                f"--lora_model={wide}", f"--base_model={base_npz}",
                f"--tokenizer={tokenizer}", "--eeg_ch=208",
                f"--device={device}",
                f"--output_dir={os.path.join(tmp, 'ft_merged_e')}"]),
                every_layer=True)}
        eval_common = [f"--test_data={corpus}/eval.jsonl",
                       f"--tokenizer={tokenizer}", "--eeg_ch=208",
                       f"--batch_size={EVAL_BATCH}", "--timing=True",
                       f"--max_new_tokens={EVAL_NEW_TOKENS}",
                       f"--device={device}"]
        ev_dirs = {k: os.path.join(tmp, f"ft_eval_{k}")
                   for k in ("merged", "adapter")}
        _reset_counts()
        ev_merged = _run_eval(eval_common + [
            f"--model_path={merged}", f"--output_dir={ev_dirs['merged']}"])
        eval_launches = _kernel_counts()
        ev_adapter = _run_eval(eval_common + [
            f"--base_model={base_npz}", f"--lora_model={adapter}",
            f"--output_dir={ev_dirs['adapter']}"])
        toks = {k: _pred_tokens(d) for k, d in ev_dirs.items()}
        pairs = [(a, b) for ra, rb in zip(toks["merged"], toks["adapter"])
                 for a, b in itertools.zip_longest(ra, rb)]
        share = sum(a == b for a, b in pairs) / max(len(pairs), 1)
        rows_equal = sum(ra == rb for ra, rb in
                         zip(toks["merged"], toks["adapter"]))
        allowance = bm["token_agreement"]["kernels_vs_plain"]["share"]
        check(len(toks["merged"]) == len(toks["adapter"]) == FT_EVAL,
              "merge: eval rows")
        check(share >= allowance, f"merge: tokens of the merged model agree "
              f"{share} with the adapter's, under the beam phase's "
              f"kernels-vs-plain {allowance}")
        check(_jax_free(), "jax or the JAX package was imported")

    first_alloc = FT_STEPS - tfinal
    n_mats = 6 * config.encoder_layers  # q, k, v, out, fc1, fc2 per layer
    out = {
        "phase": "finetune", "model": "whisper-base", "stem": "base/208",
        "dtype": config.dtype, "masters": "float32", "adalora_init_r": FT_RANK,
        "adalora_target_r": 4, "orth_reg_weight": 0.5, "fold": "fc",
        "batch_size": FT_BATCH, "label_len": FT_LABEL_LEN,
        "train_clips": FT_TRAIN, "val_clips": FT_VAL, "steps": FT_STEPS,
        "schedule": FT_SCHEDULE, "cli_lines": run["lines"],
        "memory_plan_gb": {k: v / 2**30 for k, v in plan.items()
                           if k.endswith("bytes") or k == "total_no_remat"},
        "memory_plan_fits_no_remat": plan["fits_no_remat"],
        "peak_mem_gb": run["peak_mem_gb"],
        "plan_over_peak": (plan["total_no_remat"] / 2**30)
        / run["peak_mem_gb"],
        "step_ms": step_ms, "step_ms_all": [s["ms"] for s in run["steps"]],
        "step_samples_per_s": FT_BATCH / (step_ms / 1e3),
        "cli_samples_per_s": statistics.median(
            v for k, v in cli_rate.items() if k > 2),
        "cli_samples_per_s_by_step": cli_rate,
        "lora_step_ms": tr["step_ms"],
        "step_ms_over_lora_step": step_ms / tr["step_ms"],
        "launches_per_step": run["steps"][-1]["launches"],
        "launches_per_step_expected": expect, "launches": launches,
        "adalora_host_ms": {
            "allocation": [a["host_ms"] for a in allocs],
            "pattern": [a["host_ms"] for a in run["adalora"]
                        if a["pattern_applied"]],
            "other": [a["host_ms"] for a in run["adalora"]
                      if not a["allocated"] and not a["pattern_applied"]]},
        "allocations": [{k: a[k] for k in ("step", "budget", "kept")}
                        for a in allocs],
        "schedule_budgets": {s: adalora_budget_schedule(
            s, FT_RANK * n_mats, 4 * n_mats, tinit, tfinal, FT_STEPS,
            delta_t)[0] for s in want},
        "frozen_pattern_from_step": first_alloc,
        "losses": losses, "evals": evals, "saves": run["saves"],
        "wall_s": run["wall_s"],
        "resume": {"from_step": restored["step"], "bit_exact": True,
                   "steps": [s["step"] for s in resumed["steps"]],
                   "lines": resumed["lines"]},
        "remat": {"steps": FT_REMAT_STEPS, "budget_mb": FT_ROTATE_MB,
                  "lines": remat["lines"],
                  "step_ms": statistics.median(
                      s["ms"] for s in remat["steps"][1:]),
                  "step_ms_all": [s["ms"] for s in remat["steps"]],
                  "peak_mem_gb": remat["peak_mem_gb"],
                  "no_remat_peak_mem_gb": run["peak_mem_gb"],
                  "grad_check": remat_check},
        "grad_rel_err_max": {c["state"]: c["kernels_vs_plain"]["max"]
                             for c in checks},
        "adalora_split_ms": split,
        "nonzero_e": nonzero_e, "merge_weights": merge_weights,
        "merge_eval": {"token_share_equal": share, "rows_equal": rows_equal,
                       "allowance": allowance, "launches": eval_launches,
                       "merged_metrics": ev_merged["metrics"],
                       "adapter_metrics": ev_adapter["metrics"],
                       "merged_timing_s": ev_merged["timing"]},
        "jax_imported": not _jax_free(), "card": card(),
    }
    emit(out)
    return out


# --------------------------------------------------------------------------
# speech: the log-mel front end, the speech eval CLI and --modal=speech
# fine-tuning
# --------------------------------------------------------------------------

def speech_model(tmp: str):
    """whisper-base (bf16 compute) with the 'speech' stem over 80 mel bins,
    weights from seed 1, written as a full-model directory under ``tmp``:
    (config, model_dir)."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.config import StemConfig
    from neuspeech1_tpu_torch.models.init import init_params

    config, _ = common.preset_model("base")
    stem = StemConfig("speech")
    model_dir = common.save_full_model(
        os.path.join(tmp, "speech_model"), init_params(config, stem, seed=1),
        config, stem)
    return config, model_dir


def _check_log_mel(manifest, device) -> dict:
    """``log_mel_spectrogram_torch`` on the card against the numpy
    ``log_mel_spectrogram`` on the manifest's clips (padded to 30 s), and
    the time of each: the batch on the card (CUDA events), one clip on the
    host (the median over the clips)."""
    from neuspeech1_tpu_torch.data.manifest import read_jsonlines
    from neuspeech1_tpu_torch.data.synthetic import read_wav
    from neuspeech1_tpu_torch.ops import audio

    clips = [read_wav(r["speech"]["path"])[0]
             for r in read_jsonlines(manifest)]
    host_ms, ref = [], []
    for a in clips:
        t0 = time.perf_counter()
        ref.append(audio.log_mel_spectrogram(a))
        host_ms.append(1e3 * (time.perf_counter() - t0))
    ref = torch.from_numpy(np.stack(ref))
    batch = torch.from_numpy(np.stack([audio.pad_or_trim(a) for a in clips])
                             ).to(device)
    got = audio.log_mel_spectrogram_torch(batch).cpu()
    check(tuple(got.shape) == (len(clips), audio.N_MELS, audio.N_FRAMES),
          f"speech: log-mel shape {tuple(got.shape)}")
    err = (got - ref).abs()
    within = bool((err <= MEL_ATOL + MEL_RTOL * ref.abs()).all())
    check(within, f"speech: the card's log-mel is off the numpy one by "
          f"{err.max().item()} (rtol {MEL_RTOL}, atol {MEL_ATOL})")
    return {"clips": len(clips), "max_abs_err": err.max().item(),
            "tol": [MEL_RTOL, MEL_ATOL],
            "card_ms_per_batch": cuda_ms(
                lambda: audio.log_mel_spectrogram_torch(batch)),
            "host_ms_per_clip": statistics.median(host_ms),
            "host_ms_per_clip_all": [min(host_ms), max(host_ms)]}


@contextlib.contextmanager
def _timed_generate(spans: list):
    """``decode.generate.generate`` (read by a CLI when its ``main`` runs)
    with each call's host seconds appended to ``spans``, up to a
    synchronize after it."""
    from neuspeech1_tpu_torch.decode import generate as gmod

    real = gmod.generate

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    gmod.generate = timed
    try:
        yield spans
    finally:
        gmod.generate = real


def _run_speech_eval(argv) -> dict:
    """``cli.evaluation_speech.main(argv)`` in process: its metrics, the
    seconds of its decode calls, its wall time and its output lines."""
    import io

    from neuspeech1_tpu_torch.cli import evaluation_speech

    buf, spans = io.StringIO(), []
    t0 = time.perf_counter()
    with _timed_generate(spans), contextlib.redirect_stdout(buf):
        metrics = evaluation_speech.main(argv)
    torch.cuda.synchronize()
    return {"metrics": metrics, "decode_s": sum(spans),
            "wall_s": time.perf_counter() - t0,
            "lines": [ln for ln in buf.getvalue().splitlines()
                      if ln.startswith("[evaluation_speech]")]}


def _direct_speech_preds(model_dir, tokenizer_spec, manifest, device):
    """The speech eval CLI's decode without the CLI: the same dataset,
    collator and loader, ``generate`` at the CLI's defaults, then
    ``batch_decode`` and the punctuation removal. Returns the predictions
    and the first batch's features on the device, with the model."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import SpeechDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      generate)
    from neuspeech1_tpu_torch.utils import text as tx

    params, config, stem = common.load_full_model(model_dir)
    tok = common.resolve_tokenizer(tokenizer_spec, config)
    model = common.commit_params(params, config, stem, device)
    ds = SpeechDataset(manifest, tok, language="English")
    loader = DataLoader(ds, Collator(pad_id=tok.pad_id,
                                     decoder_start_id=config.sot_id,
                                     max_label_len=128),
                        SPEECH_EVAL_BATCH, shuffle=False, drop_last=False)
    prompt = np.asarray([tok.prefix_tokens("English", "transcribe")])
    gen = GenerationConfig.for_model(
        config, max_length=prompt.shape[1] + EVAL_NEW_TOKENS, num_beams=5,
        **common.suppress_kwargs("default", tok))
    preds, first = [], None
    for batch in loader:
        feats = common.upload_features(batch["input_features"], model.dtype,
                                       device, compact=False)
        first = feats if first is None else first
        out = generate(model, feats,
                       torch.as_tensor(np.repeat(prompt, feats.shape[0], 0),
                                       device=device), gen)
        preds.extend(tok.batch_decode(out.cpu().numpy()))
    return tx.remove_punctuation(preds), first, model


def _speech_encoder_check(model, feats, config) -> dict:
    """The encoder on one batch of speech features through K1 against the
    plain attention path (the slice phase's bound)."""
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    before = _kernel_counts()["K1"]
    with torch.no_grad():
        enc_k = tw.encoder_apply(model, feats)
        launched = _kernel_counts()["K1"] - before
        kernel_fn = tw.flash_attention_bthd
        tw.flash_attention_bthd = fa.flash_attention_bthd_plain
        try:
            enc_p = tw.encoder_apply(model, feats)
        finally:
            tw.flash_attention_bthd = kernel_fn
    torch.cuda.synchronize()
    diff = (enc_k.float() - enc_p.float()).abs()
    enc_max, enc_mean = diff.max().item(), diff.mean().item()
    check(tuple(enc_k.shape) == (feats.shape[0], config.max_source_positions,
                                 config.d_model),
          f"speech: encoder states shape {tuple(enc_k.shape)}")
    check(bool(torch.isfinite(enc_k.float()).all()),
          "speech: non-finite encoder states")
    check(enc_max <= ENC_MAX_TOL and enc_mean <= ENC_MEAN_TOL,
          f"speech: encoder states off the plain path by max {enc_max}, "
          f"mean {enc_mean}")
    return {"max_abs_err": enc_max, "mean_abs_err": enc_mean,
            "tol": [ENC_MAX_TOL, ENC_MEAN_TOL], "k1_launches": launched}


def _speech_loader_rate(manifest, tokenizer_spec, config) -> dict:
    """The fine-tune CLI's train loader for --modal=speech alone (the same
    dataset, collator and threaded loader, no step): samples/s over one
    epoch (host clock)."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import SpeechDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader

    tok = common.resolve_tokenizer(tokenizer_spec, config)
    loader = DataLoader(
        SpeechDataset(manifest, tok, language="English", mode="train"),
        Collator(pad_id=tok.pad_id, decoder_start_id=config.sot_id,
                 max_label_len=FT_LABEL_LEN, feature_dtype="bfloat16",
                 eot_id=config.eot_id),
        FT_BATCH, shuffle=True, seed=0, num_threads=4, prefetch=2)
    t0 = time.perf_counter()
    n = sum(len(b["labels"]) for b in loader)
    return {"samples": n, "threads": 4,
            "samples_per_s": n / (time.perf_counter() - t0)}


def phase_speech(device: str = "cuda") -> dict:
    """The speech modality at whisper-base width: the log-mel on the card
    against the numpy one, the speech eval CLI
    (``cli.evaluation_speech.main``) at its defaults on EVAL_CLIPS clips
    with their wavs (K1/K6/K7 launches against the model calls, the
    predictions against ``generate`` on the same batches, the encoder on
    speech features against the plain path), the manifest split of
    ``cli.manifest_tools``, and ``cli.finetune.main --modal=speech`` at its
    defaults (K1/K2/K3 launches per step against the finetune phase's EEG
    step, finite losses, the adapter written, the step's rate beside the
    CLI's)."""
    from neuspeech1_tpu_torch.cli import manifest_tools
    from neuspeech1_tpu_torch.data.manifest import read_jsonlines

    with tempfile.TemporaryDirectory() as tmp:
        config, model_dir = speech_model(tmp)
        corpus, tokenizer = _eval_corpus(tmp, config.eot_id, with_audio=True)
        manifest = os.path.join(corpus, "all.jsonl")

        # 1. the manifest split (train/val/test 8:1:1)
        split_dir = os.path.join(tmp, "speech_split")
        manifest_tools.main(["split", manifest, "-o", split_dir])
        parts = {n: read_jsonlines(os.path.join(split_dir, f"{n}.jsonl"))
                 for n in ("train", "val", "test")}
        paths = sorted(r["speech"]["path"] for rows in parts.values()
                       for r in rows)
        check(paths == sorted(r["speech"]["path"]
                              for r in read_jsonlines(manifest)),
              "speech: the split does not partition the manifest")

        # 2. the log-mel on the card
        mel = _check_log_mel(manifest, device)

        # 3. the speech eval CLI at its defaults
        out_dir = os.path.join(tmp, "speech_eval")
        _reset_counts()
        with count_model_calls() as calls:
            run = _run_speech_eval([
                f"--test_data={manifest}", f"--model_path={model_dir}",
                f"--tokenizer={tokenizer}", f"--device={device}",
                f"--max_new_tokens={EVAL_NEW_TOKENS}",
                f"--output_dir={out_dir}"])
        launches = _kernel_counts()
        _check_serving_launches("speech eval", config, calls, launches)
        files = _result_files(out_dir)
        check(set(files) == {"all_speech.txt", "all_speech.jsonl",
                             "all_speech.json"},
              f"speech eval: result files {sorted(files)}")
        rows = [json.loads(ln) for ln in
                files["all_speech.jsonl"].decode().splitlines()]
        check(len(rows) == EVAL_CLIPS, f"speech eval: {len(rows)} rows for "
              f"{EVAL_CLIPS} clips")
        metrics = run["metrics"]
        check(all(math.isfinite(float(v)) for v in metrics.values()),
              f"speech eval: non-finite metric {metrics}")
        direct, feats, model = _direct_speech_preds(model_dir, tokenizer,
                                                    manifest, device)
        check([r["pred"] for r in rows] == direct,
              "speech eval: the CLI's predictions differ from generate's on "
              "the same batches")
        encoder = _speech_encoder_check(model, feats, config)
        del model, feats
        torch.cuda.empty_cache()

        # 4. --modal=speech fine-tuning at the CLI's defaults
        ft_corpus, _ = _finetune_corpus(tmp, config.eot_id, with_audio=True)
        run_dir = os.path.join(tmp, "speech_ft")
        expect = _step_launches(config)
        _reset_counts()
        with count_model_calls() as ft_calls:
            ft = _run_finetune([
                f"--train_data={ft_corpus}/train.jsonl",
                f"--val_data={ft_corpus}/val.jsonl",
                f"--base_model={os.path.join(model_dir, 'params.npz')}",
                f"--tokenizer={tokenizer}", "--modal=speech",
                f"--per_device_train_batch_size={FT_BATCH}",
                f"--label_max_length={FT_LABEL_LEN}",
                f"--max_steps={SPEECH_FT_STEPS}", f"--output_dir={run_dir}",
                f"--device={device}", *SPEECH_FT_SCHEDULE])
        ft_launches = _kernel_counts()
        check(len(ft["steps"]) == SPEECH_FT_STEPS,
              f"speech finetune: {len(ft['steps'])} steps")
        for s in ft["steps"]:
            check(s["launches"] == expect, f"speech finetune step "
                  f"{s['step']}: launches {s['launches']}, expected {expect}")
        # the eval-WER decode: K6 and K7 against its cached decoder calls
        # (it stops when every row has emitted eot, so K7 may not run)
        decode_want = _expected_launches(config, ft_calls)
        check(all(ft_launches[k] == decode_want[k] for k in ("K6", "K7")),
              f"speech finetune: eval-WER decode launches {ft_launches}, "
              f"expected {decode_want} from the model calls {ft_calls}")
        check(all(ft_launches[k] > 0 for k in ("K1", "K2", "K3", "K6")),
              f"speech finetune: a kernel of the path never launched: "
              f"{ft_launches}")
        losses = [r["loss"] for r in ft["records"] if "loss" in r]
        check(len(losses) == SPEECH_FT_STEPS
              and all(math.isfinite(x) for x in losses),
              f"speech finetune: losses {losses}")
        evals = [r for r in ft["records"] if "eval_loss" in r]
        check(len(evals) == 1 and math.isfinite(evals[0]["eval_loss"])
              and 0 <= evals[0]["eval_wer"],
              f"speech finetune: evals {evals}")
        adapter = os.path.join(run_dir, "adapter_final.npz")
        check(os.path.exists(adapter), "speech finetune: no adapter written")
        with np.load(adapter) as z:
            adapter_keys = len(z.files)
            check("model/encoder/stem/conv1/w" in z.files,
                  "speech finetune: the speech stem is not in the adapter")
        check(any("remat=" in ln for ln in ft["lines"]) and not any(
            "staging" in ln or "rotating" in ln for ln in ft["lines"]),
            f"speech finetune: {ft['lines']}")
        loader_alone = _speech_loader_rate(
            os.path.join(ft_corpus, "train.jsonl"), tokenizer, config)
        check(_jax_free(), "jax or the JAX package was imported")

    timed = [s["ms"] for s in ft["steps"][2:]]
    step_ms = statistics.median(timed)
    cli_rate = {r["step"]: r["samples_per_sec"] for r in ft["records"]
                if "samples_per_sec" in r}
    loop_rate = statistics.median(v for k, v in cli_rate.items()
                                  if 2 < k < SPEECH_FT_STEPS)
    step_rate = FT_BATCH / (step_ms / 1e3)
    out = {
        "phase": "speech", "model": "whisper-base", "stem": "speech/80",
        "dtype": config.dtype, "split": {n: len(r) for n, r in parts.items()},
        "log_mel": mel,
        "eval": {"clips": EVAL_CLIPS, "batch_size": SPEECH_EVAL_BATCH,
                 "num_beams": 5, "max_new_tokens": EVAL_NEW_TOKENS,
                 "decode_s": run["decode_s"], "wall_s": run["wall_s"],
                 "utterances_per_s_decode": EVAL_CLIPS / run["decode_s"],
                 "utterances_per_s_end_to_end": EVAL_CLIPS / run["wall_s"],
                 "metrics": metrics, "launches": launches,
                 "model_calls": calls, "preds_equal_generate": True,
                 "encoder": encoder, "sample_pred": rows[0]["pred"][:80]},
        "finetune": {
            "batch_size": FT_BATCH, "label_len": FT_LABEL_LEN,
            "train_clips": FT_TRAIN, "val_clips": FT_VAL,
            "steps": SPEECH_FT_STEPS, "schedule": SPEECH_FT_SCHEDULE,
            "cli_lines": ft["lines"], "step_ms": step_ms,
            "step_ms_all": [s["ms"] for s in ft["steps"]],
            "step_samples_per_s": step_rate,
            "cli_samples_per_s": loop_rate,
            "cli_samples_per_s_by_step": cli_rate,
            # the share of the loop's time the step's device span does not
            # cover: the host's log-mel loader and the loop around the step
            "loader_share": 1.0 - loop_rate / step_rate,
            "loader_alone": loader_alone,
            "launches_per_step": ft["steps"][-1]["launches"],
            "launches_per_step_expected": expect, "launches": ft_launches,
            "eval_decode_model_calls": {k: ft_calls[k] for k in (
                "cached_decoder", "width1", "cross_chunks")},
            "losses": losses, "evals": evals, "adapter_keys": adapter_keys,
            "peak_mem_gb": ft["peak_mem_gb"], "wall_s": ft["wall_s"]},
        "jax_imported": not _jax_free(), "card": card(),
    }
    emit(out)
    return out


# --------------------------------------------------------------------------
# options: remat policies, int8 matmuls, augmentation, dropout, and the
# fine-tune CLI with them
# --------------------------------------------------------------------------

def _timed_steps(step, state, frozen, batch, expect=None) -> dict:
    """OPT_WARM steps, then OPT_TIMED timed ones (a device -> host copy of
    the loss ends each): median ms, the losses, the peak memory from the
    first step on, and the kernel launches of each step (checked against
    ``expect`` where given)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, launches = [], [], None
    for i in range(OPT_WARM + OPT_TIMED):
        _reset_counts()
        t0 = time.perf_counter()
        m = step(state, frozen, batch)
        loss = float(m["loss"])
        seconds = time.perf_counter() - t0
        launches = _kernel_counts()
        check(math.isfinite(loss) and math.isfinite(float(m["grad_norm"])),
              f"options step: loss {loss}")
        if expect is not None:
            check(launches == expect, f"options step: launches {launches}, "
                  f"expected {expect}")
        losses.append(loss)
        if i >= OPT_WARM:
            ms.append(1e3 * seconds)
    return {"step_ms": statistics.median(ms), "step_ms_all": ms,
            "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": {k: launches[k] for k in ("K1", "K2",
                                                            "K3")}}


def _options_remat(config, stem, tx, state, frozen, batch, expect,
                   grads) -> dict:
    """Every remat policy and no remat at batch 64: ms per step, peak
    memory and launches per step of the training step under each, beside
    ``grads``, `_remat_grad_check`'s record of the same policies."""
    import dataclasses

    from neuspeech1_tpu_torch.train.trainstep import make_train_step

    out = {}
    for name, changes in _remat_settings():
        c = dataclasses.replace(config, **changes)
        want = dict(expect, K1=expect["K1"] + _remat_extra_k1(name, config))
        with _replaced_config(frozen.model, **changes):
            rec = _timed_steps(make_train_step(c, stem, tx, fold_lora=True),
                               state, frozen, batch, want)
        out[name] = {**rec, **({"grad_check": grads[name]}
                               if name in grads else {})}
        emit({"phase": "options", "item": "remat", "policy": name,
              **{k: v for k, v in out[name].items() if k != "losses"}})
    return out


def _int_mm_exact(gen, device: str = "cuda") -> dict:
    """One quantized product at the encoder's fc1 shape, [96000, 512] @
    [512, 2048] (bf16 activations and weights quantized as the step
    quantizes them): ``torch._int_mm``'s int32 sums equal a float64 product
    of the same int8 operands exactly (every sum is below 2^53); its ms
    beside the bf16 product's."""
    from neuspeech1_tpu_torch.ops import int8_matmul as i8

    n = TRAIN_BATCH * 1500
    x = torch.randn(n, 512, generator=gen, device=device).bfloat16()
    w = torch.randn(2048, 512, generator=gen, device=device).bfloat16()
    xq, _ = i8._quant(x, 1)
    wq, _ = i8._quant(w, 1)
    y = i8._int_mm(xq, wq)
    exact = torch.equal(y.double(), xq.double() @ wq.double().t())
    check(exact, "int8: torch._int_mm differs from the float64 product")
    return {"shape": [n, 512, 2048], "exact": exact,
            "int_mm_ms": cuda_ms(lambda: i8._int_mm(xq, wq)),
            "qdot_ms": cuda_ms(lambda: i8.qdot(x, w, torch.bfloat16)),
            "bf16_mm_ms": cuda_ms(lambda: x @ w.t())}


def _int8_grad_check(config, stem, state, frozen, batch, expect) -> dict:
    """One step's loss and gradients under int8 'fwd' and 'full' against
    the bf16 step's at the same state (INT8_GRAD_REL_TOL,
    INT8_LOSS_REL_TOL; beside them the cosine of the whole gradient), with
    K1, K2 and K3 launched as in the bf16 step."""
    from neuspeech1_tpu_torch.train.trainstep import make_loss_fn

    loss_ref, g_ref = _grads(make_loss_fn(config, stem, fold_lora=True),
                             state, frozen, batch)
    out = {}
    for mode in ("fwd", "full"):
        _reset_counts()
        loss, g = _grads(make_loss_fn(config, stem, fold_lora=True,
                                      int8_matmul=mode), state, frozen, batch)
        check(_kernel_counts() == expect, f"int8 {mode}: launches "
              f"{_kernel_counts()}, expected {expect}")
        errs = _leaf_errs(g, g_ref)
        dot = sum((g[k].float() * g_ref[k].float()).sum().item()
                  for k in g_ref)
        norms = [sum(t[k].float().pow(2).sum().item() for k in g_ref) ** 0.5
                 for t in (g, g_ref)]
        out[mode] = {"loss": loss, "loss_bf16": loss_ref,
                     "grad_rel_err": {k: errs[k] for k in (
                         "max", "leaf", "median", "top5")},
                     "grad_cos": dot / (norms[0] * norms[1]),
                     "grad_rel_tol": INT8_GRAD_REL_TOL}
        check(errs["max"] <= INT8_GRAD_REL_TOL,
              f"int8 {mode}: grads off the bf16 step: {errs['leaf']} "
              f"{errs['max']}")
        check(abs(loss - loss_ref) <= INT8_LOSS_REL_TOL * abs(loss_ref),
              f"int8 {mode}: loss {loss}, bf16 {loss_ref}")
    return out


def _options_int8(config, stem, tx, state, frozen, batch, expect, grads,
                  device: str = "cuda") -> dict:
    """The step under int8 'fwd' and 'full' at batch 64: ms per step,
    losses and launches (K1, K2, K3 as in the bf16 step) beside ``grads``,
    `_int8_grad_check`'s record; and `_int_mm_exact`."""
    from neuspeech1_tpu_torch.train.trainstep import make_train_step

    out = {"int_mm": _int_mm_exact(
        torch.Generator(device=device).manual_seed(13), device)}
    emit({"phase": "options", "item": "int8_int_mm", **out["int_mm"]})
    for mode in ("fwd", "full"):
        rec = {**grads[mode],
               **_timed_steps(make_train_step(config, stem, tx,
                                              fold_lora=True,
                                              int8_matmul=mode),
                              state, frozen, batch, expect)}
        out[mode] = rec
        emit({"phase": "options", "item": "int8", "mode": mode, **rec})
    return out


def _binomial(hits: int, n: int, p: float) -> dict:
    sd = (n * p * (1 - p)) ** 0.5
    ok = abs(hits - n * p) <= Z_BINOMIAL * sd
    return {"rate": hits / n, "p": p, "n": n, "ok": ok}


def _options_augment(feats, device: str = "cuda") -> dict:
    """The augmentation's draws on the card (OPT_DRAWS batches of them):
    apply rates per section, taylor's n0 and n1, and what the apply does
    with them on the bf16 batch at prob 1: each noisy (row, channel)'s
    measured SNR against its drawn SNR (SNR_TOL_DB) and inside [min_snr,
    max_snr] with that margin, and the share the block mask zeroes against
    mask_prob."""
    from neuspeech1_tpu_torch.ops.augment import apply_augment, draw_augment

    gen = torch.Generator(device=device).manual_seed(11)
    shape = feats.shape
    b = shape[0]
    hits = {n: 0 for n in ("noise", "mask", "taylor")}
    n_lo = n_hi = None
    for _ in range(OPT_DRAWS):
        d = draw_augment(gen, shape, OPT_AUGMENT)
        for n in hits:
            hits[n] += int(d[n]["apply"].sum())
        lo = min(d["taylor"][k].min().item() for k in ("n0", "n1"))
        hi = max(d["taylor"][k].max().item() for k in ("n0", "n1"))
        n_lo = lo if n_lo is None else min(n_lo, lo)
        n_hi = hi if n_hi is None else max(n_hi, hi)
    rates = {n: _binomial(h, OPT_DRAWS * b, OPT_AUGMENT[n]["prob"])
             for n, h in hits.items()}
    # the noise and the mask at prob 1 on the batch
    noise = {"noise": {**OPT_AUGMENT["noise"], "prob": 1.0}}
    d = draw_augment(gen, shape, noise)
    y = apply_augment(feats, d, noise)
    x = feats.float()
    snr = 10 * torch.log10(x.pow(2).mean(-1) / (y - x).pow(2).mean(-1))
    drawn = d["noise"]["snr"][..., 0]
    cfg = OPT_AUGMENT["noise"]
    snr_rec = {"min": snr.min().item(), "max": snr.max().item(),
               "max_abs_err_db": (snr - drawn).abs().max().item(),
               "range": [cfg["min_snr_dB"], cfg["max_snr_dB"]],
               "tol_db": SNR_TOL_DB}
    mask = {"mask": {**OPT_AUGMENT["mask"], "prob": 1.0}}
    d = draw_augment(gen, shape, mask)
    zeroed = ((apply_augment(feats, d, mask) == 0) & (feats != 0)).sum()
    n_cells = d["mask"]["keep"].numel()
    cell_share = 1 - d["mask"]["keep"].float().mean().item()
    share = zeroed.item() / (feats != 0).sum().item()
    p = OPT_AUGMENT["mask"]["kwargs"]["mask_prob"]
    out = {"apply_rates": rates, "taylor_n_range": [n_lo, n_hi],
           "snr_db": snr_rec,
           "masked": {"sample_share": share, "cell_share": cell_share,
                      "mask_prob": p, "cells": n_cells,
                      **{k: v for k, v in _binomial(
                          round(cell_share * n_cells), n_cells, p).items()
                         if k == "ok"}}}
    emit({"phase": "options", "item": "augment_draws", **out})
    for n, r in rates.items():
        check(r["ok"], f"augment: {n} applied at {r['rate']}, prob {r['p']}")
    check(n_lo == 1 and n_hi == 9, f"augment: taylor n in {n_lo}..{n_hi}")
    check(snr_rec["max_abs_err_db"] <= SNR_TOL_DB
          and cfg["min_snr_dB"] - SNR_TOL_DB <= snr_rec["min"]
          and snr_rec["max"] <= cfg["max_snr_dB"] + SNR_TOL_DB,
          f"augment: measured SNR {snr_rec}")
    check(out["masked"]["ok"] and abs(share - cell_share) < 1e-3,
          f"augment: masked share {share}, cells {cell_share}, prob {p}")
    return out


def _options_dropout(config, stem, tx, state, frozen, batch, expect,
                     device: str = "cuda") -> dict:
    """``use_dropout=True`` at stem.dropout OPT_DROPOUT: the frame mask's
    keep rate over OPT_DRAWS draws on the card (binomial bound), then ms
    per step and launches."""
    import dataclasses

    from neuspeech1_tpu_torch.models.whisper import draw_dropout
    from neuspeech1_tpu_torch.train.trainstep import make_train_step

    dstem = dataclasses.replace(stem, dropout=OPT_DROPOUT)
    gen = torch.Generator(device=device).manual_seed(12)
    kept = n = 0
    for _ in range(OPT_DRAWS):
        frames = draw_dropout(gen, config, dstem, TRAIN_BATCH)["frames"]
        kept += int(frames.sum())
        n += frames.numel()
    keep = _binomial(kept, n, 1 - OPT_DROPOUT)
    rec = {"rate": OPT_DROPOUT, "frame_keep": keep,
           **_timed_steps(make_train_step(config, dstem, tx, fold_lora=True,
                                          use_dropout=True),
                          state, frozen, batch, expect)}
    emit({"phase": "options", "item": "dropout", **rec})
    check(keep["ok"], f"dropout: frames kept at {keep['rate']}")
    return rec


class _RecordingLoader:
    """Records the ``native_signals`` flag of every DataLoader the CLI
    builds (a stand-in for ``data.loader.DataLoader`` while open)."""

    def __init__(self):
        from neuspeech1_tpu_torch.data import loader

        self.module, self.orig, self.native = loader, loader.DataLoader, []

    def __enter__(self):
        rec, orig = self.native, self.orig

        class Loader(orig):
            def __init__(self, *a, **k):
                rec.append(bool(k.get("native_signals", False)))
                super().__init__(*a, **k)

        self.module.DataLoader = Loader
        return self

    def __exit__(self, *exc):
        self.module.DataLoader = self.orig


def _options_cli(tmp: str, expect_cli, device: str = "cuda") -> dict:
    """``cli.finetune.main`` on the finetune phase's corpus (160 clips at
    batch 64, FT_LABEL_LEN labels, seeded random whisper-base weights)
    with --augment_config_path (shift, noise, mask and taylor at 0.5) and
    --int8_matmul=fwd, then full, OPT_CLI_STEPS steps each: the loss at
    every step, finite; K1/K2/K3 launches per step; and that shift turned
    the device cache and the native clip loader off."""
    corpus, tokenizer = _finetune_corpus(tmp, 50257)
    aug = os.path.join(tmp, "augment.json")
    with open(aug, "w") as f:
        json.dump({"shift": {"prob": 0.5},
                   **{k: OPT_AUGMENT[k] for k in ("noise", "mask",
                                                  "taylor")}}, f)
    out = {}
    for mode in ("fwd", "full"):
        argv = [f"--train_data={corpus}/train.jsonl", "--base_model=random",
                f"--tokenizer={tokenizer}", "--eeg_ch=208",
                f"--per_device_train_batch_size={FT_BATCH}",
                f"--label_max_length={FT_LABEL_LEN}",
                f"--max_steps={OPT_CLI_STEPS}", "--warmup_steps=1",
                "--logging_steps=1", "--save_steps=1000", "--eval_steps=1000",
                "--eval_wer=False", "--remat=False",
                f"--augment_config_path={aug}", f"--int8_matmul={mode}",
                f"--output_dir={os.path.join(tmp, 'cli_' + mode)}",
                f"--device={device}"]
        with _RecordingLoader() as rl:
            run = _run_finetune(argv)
        losses = [r["loss"] for r in run["records"] if "loss" in r]
        rec = {"mode": mode, "augment": aug, "losses": losses,
               "step_ms": [s["ms"] for s in run["steps"]],
               "launches": [s["launches"] for s in run["steps"]],
               "lines": run["lines"], "native_loader": rl.native,
               "device_cache": any("staging" in ln or "rotating" in ln
                                   for ln in run["lines"]),
               "peak_mem_gb": run["peak_mem_gb"], "wall_s": run["wall_s"]}
        out[mode] = rec
        emit({"phase": "options", "item": "cli", **rec})
        check(len(losses) == OPT_CLI_STEPS
              and all(math.isfinite(x) for x in losses),
              f"cli {mode}: losses {losses}")
        check(all(s["launches"] == expect_cli for s in run["steps"]),
              f"cli {mode}: launches {rec['launches']}, expected "
              f"{expect_cli}")
        check(rl.native == [False] and not rec["device_cache"],
              f"cli {mode}: with shift on, native loader {rl.native}, "
              f"device cache {rec['device_cache']}")
    return out


def phase_options(tr, device: str = "cuda") -> dict:
    """The training step's options at the train phase's setup (whisper-base
    with the 'base' stem over 208 channels, batch 64, 64 labels, LoRA r=32,
    the fold), no cut in width or depth: every remat policy and no remat,
    int8 'fwd' and 'full' beside the bf16 step, augmentation (noise, mask,
    taylor at 0.5 and SpecAugment) beside the step without, dropout at
    OPT_DROPOUT, each with its checks; then the fine-tune CLI with
    augmentation and int8. One JSON line per item."""
    import dataclasses

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.train.trainstep import make_train_step

    t0 = time.perf_counter()
    config, tx, state, frozen, step, batch = _train_setup(TRAIN_BATCH,
                                                          device)
    stem = frozen.model.stem_config
    n = config.encoder_layers
    expect = {"K1": 2 * n, "K2": 2 * n, "K3": 2 * n, "K4": 0, "K4_bwd": 0,
              "K6": 0, "K7": 0, "K8": 0}
    # the adapters at a trained magnitude, so that every gradient moves
    from neuspeech1_tpu_torch.models.lora import entries

    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for _, e in entries(frozen.lora):
            e["B"].copy_(TRAINED_B_STD * torch.randn(e["B"].shape,
                                                     generator=gen))
    # the gradient checks first, at the state just set: the timed steps
    # below train the adapters and the stem on the one batch, and int8's
    # distance from bf16 grows as they do (measured on one H100)
    remat_grads = _remat_grad_check(config, stem, state, frozen, batch,
                                    orth_reg_weight=0.0)
    int8_grads = _int8_grad_check(config, stem, state, frozen, batch, expect)
    remat = _options_remat(config, stem, tx, state, frozen, batch, expect,
                           remat_grads)
    int8 = _options_int8(config, stem, tx, state, frozen, batch, expect,
                         int8_grads, device)
    draws = _options_augment(batch["input_features"], device)
    aug = _timed_steps(make_train_step(config, stem, tx, fold_lora=True,
                                       augment_config=OPT_AUGMENT),
                       state, frozen, batch, expect)
    check(state.generator.device.type == torch.device(device).type,
          f"the step's generator is on {state.generator.device}")
    emit({"phase": "options", "item": "augment_step", **aug})
    drop = _options_dropout(config, stem, tx, state, frozen, batch, expect,
                            device)
    del state, frozen, step, batch
    torch.cuda.empty_cache()
    cli_config, _ = common.preset_model("base", "base", in_channels=208)
    with tempfile.TemporaryDirectory() as tmp:
        cli = _options_cli(tmp, _step_launches(cli_config), device)
    check(_jax_free(), "jax or the JAX package was imported")
    base_ms = remat["none"]["step_ms"]
    out = {
        "phase": "options", "item": "summary", "model": "whisper-base",
        "stem": "base/208", "batch_size": TRAIN_BATCH,
        "label_len": TRAIN_LABEL_LEN, "lora_rank": 32,
        "step_ms": {"bf16": base_ms,
                    **{f"remat_{k}": v["step_ms"] for k, v in remat.items()
                       if k != "none"},
                    "int8_fwd": int8["fwd"]["step_ms"],
                    "int8_full": int8["full"]["step_ms"],
                    "augment": aug["step_ms"], "dropout": drop["step_ms"]},
        "samples_per_s": {k: TRAIN_BATCH / (v / 1e3) for k, v in {
            "bf16": base_ms, "int8_fwd": int8["fwd"]["step_ms"],
            "int8_full": int8["full"]["step_ms"],
            "augment": aug["step_ms"]}.items()},
        "peak_mem_gb": {k: v["peak_mem_gb"] for k, v in remat.items()},
        "train_phase_step_ms": tr["step_ms"],
        "int8_grad_rel_err_max": {m: int8[m]["grad_rel_err"]["max"]
                                  for m in ("fwd", "full")},
        "int8_grad_cos": {m: int8[m]["grad_cos"] for m in ("fwd", "full")},
        "cli_losses": {m: cli[m]["losses"] for m in cli},
        "seconds": time.perf_counter() - t0,
        "jax_imported": not _jax_free(), "card": card()}
    emit(out)
    return out


# --------------------------------------------------------------------------
# parallel: data parallelism, GPipe, remat under SP, the CLI under a
# torchrun environment, the profiler
# --------------------------------------------------------------------------

def _dp_step(device: str = "cuda") -> dict:
    """The train phase's step (whisper-base, batch 64, LoRA 'fc') with the
    data axis on DP_N LocalRing threads of one card, 64 / DP_N rows a
    rank, DP_STEPS steps against the one-rank step on the same 64 rows:
    the ce losses within DP_LOSS_RTOL and the gradient norms within
    DP_GRAD_NORM_RTOL, the ranks' parameters bit for bit equal, the updated leaves' relative errors against the one-rank step,
    K1/K2/K3 launches per rank and step, and each step's ms with both
    ranks sharing the card (not a speed figure)."""
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing

    config, _, state, frozen, step, batch = _train_setup(TRAIN_BATCH, device)
    n_layers = config.encoder_layers
    expect = {"K1": 2 * n_layers, "K2": 2 * n_layers, "K3": 2 * n_layers,
              "K4": 0, "K4_bwd": 0, "K6": 0, "K7": 0, "K8": 0}
    one, one_norm = [], []
    for _ in range(DP_STEPS):
        _reset_counts()
        m = step(state, frozen, batch)
        one.append(float(m["ce_loss"]))
        one_norm.append(float(m["grad_norm"]))
        check(_kernel_counts() == expect, f"one-rank step launches "
              f"{_kernel_counts()}, expected {expect}")
    ref = {k: t.detach().clone() for k, t in state.trainable.items()}
    del state, frozen, step
    _empty_cache(device)

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            _, _, st, fz, stp, full = _train_setup(TRAIN_BATCH, device)
            shard = pmesh.batch_sharding()
            rows = {k: shard.shard(v) for k, v in full.items()}
            ring = mesh["data"]
            losses, norms, ms = [], [], []
            for _ in range(DP_STEPS):
                ring.barrier()
                t0 = time.perf_counter()
                m = stp(st, fz, rows)
                losses.append(float(m["ce_loss"]))
                norms.append(float(m["grad_norm"]))
                ring.barrier()
                ms.append(1e3 * (time.perf_counter() - t0))
            return {"losses": losses, "norms": norms, "ms": ms,
                    "rows": rows["labels"].shape[0],
                    "trainable": {k: t.detach().clone()
                                  for k, t in st.trainable.items()}}

    _sync(device)
    _reset_peak(device)
    _reset_counts()
    runs = LocalRing.run_mesh(rank, data=DP_N)
    counts = _kernel_counts()
    peak = _peak_gb(device)
    per_rank = {k: counts[k] // (DP_N * DP_STEPS) for k in ("K1", "K2", "K3")}
    errs = _leaf_errs(runs[0]["trainable"], ref)
    out = {"ranks": DP_N, "rows_per_rank": runs[0]["rows"],
           "batch_size": TRAIN_BATCH, "steps": DP_STEPS,
           "losses": {"one_rank": one, "dp": runs[0]["losses"]},
           "loss_rtol": DP_LOSS_RTOL,
           "grad_norms": {"one_rank": one_norm, "dp": runs[0]["norms"]},
           "grad_norm_rtol": DP_GRAD_NORM_RTOL,
           "updated_leaves_vs_one_rank": errs,
           "launches_per_rank_per_step": per_rank,
           "step_ms_both_ranks_one_card": runs[0]["ms"],
           "peak_mem_gb": peak}
    emit({"phase": "parallel", "part": "dp_step", **out})
    for a, b in zip(out["losses"]["dp"], one):
        check(abs(a - b) <= DP_LOSS_RTOL * abs(b),
              f"DP loss {a}, one-rank {b}")
    # the pre-clip norm of the reduced gradients does not depend on the
    # learning rate (0 at the first step): a reduction off by a factor
    # shows here even where Adam's update would hide it
    for a, b in zip(out["grad_norms"]["dp"], one_norm):
        check(abs(a - b) <= DP_GRAD_NORM_RTOL * abs(b),
              f"DP grad_norm {a}, one-rank {b}")
    for r in runs[1:]:
        check(r["losses"] == runs[0]["losses"]
              and r["norms"] == runs[0]["norms"],
              "DP ranks' losses or gradient norms differ")
        for k, t in runs[0]["trainable"].items():
            check(torch.equal(r["trainable"][k], t),
                  f"DP ranks' parameters differ at {k}")
    check(counts == {k: DP_N * DP_STEPS * v for k, v in expect.items()},
          f"DP launches {counts}, expected {DP_N * DP_STEPS} x {expect}")
    return out


def _gpipe_stack(part: str, model, gen, device: str, batch: int,
                 search: dict | None = None) -> dict:
    """One stack of the model through ``pipeline_fwd``/``pipeline_bwd`` on
    PIPE_N LocalRing threads (the bodies, called directly: the ranks share
    one CUDA device's autograd worker) at ``batch`` rows in PIPE_M
    microbatches (``search``: what the batch search saw, printed along), against the plain loop on the same inputs: the output,
    the input's gradient (and the encoder states' for the decoder) and
    every stage weight's gradient; K1/K2 launches, ms of each and the peak
    memory of the pipelined pass."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.parallel.pipeline import (
        pipeline_bwd, pipeline_fwd, stage_layers)
    from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing

    config = model.config
    d, dt = config.d_model, model.dtype
    t_src = config.max_source_positions
    if part == "encoder":
        body, xs = tw.encoder_stack(model)
        t, consts = t_src, ()
        sample = ()
    else:
        t = TRAIN_LABEL_LEN
        body, xs = tw.decoder_stack(model, t)
        consts = (torch.ones((t, t), dtype=torch.bool,
                             device=device).tril()[None, None],)
        # the encoder's states take gradients, as in the model
        sample = (torch.randn((batch, t_src, d), generator=gen,
                              device=device).to(dt).requires_grad_(),)
    h = torch.randn((batch, t, d), generator=gen, device=device).to(dt)
    g = torch.randn((batch, t, d), generator=gen, device=device).to(dt)
    params = [p for x in xs for p in x["w"].values()]

    def plain():
        """The plain loop's forward and backward: ms, output, gradients of
        the input, the encoder states and the weights."""
        for p in params:
            p.grad = None
        _sync(device)
        t0 = time.perf_counter()
        h0 = h.detach().clone().requires_grad_()
        s0 = [c.detach().clone().requires_grad_() for c in sample]
        y = h0
        for x in xs:
            y = body(y, x, *s0, *consts)
        y.backward(g)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        out = (ms, y.detach(), h0.grad, [c.grad for c in s0],
               {id(p): p.grad for p in params})
        for p in params:
            p.grad = None
        return out

    # as the pipelined pass below: a first pass warms up, the second counts
    plain()
    plain_ms, ref_out, ref_dh, ref_ds, ref_w = plain()

    def rank(ring):
        mine = stage_layers(xs, ring)
        out, saved = pipeline_fwd(body, mine, h, ring, PIPE_M, consts,
                                  sample)
        dh, ds, dleaves = pipeline_bwd(saved, g)
        flat, spec = tree_flatten(mine)
        grads = {id(p): dg for p, dg in zip(flat, dleaves)
                 if isinstance(p, torch.Tensor) and p.requires_grad}
        return out, dh, ds, grads

    _empty_cache(device)
    # a first pass warms the threads' libraries; the second is timed and
    # counted
    LocalRing.run(rank, PIPE_N)
    _sync(device)
    _reset_peak(device)
    _reset_counts()
    t0 = time.perf_counter()
    runs = LocalRing.run(rank, PIPE_N)
    _sync(device)
    pipe_ms = 1e3 * (time.perf_counter() - t0)
    counts = _kernel_counts()
    grads = {}
    for r in runs:
        grads.update(r[3])
    check(set(grads) == set(ref_w), f"GPipe {part}: stage gradients "
          f"cover {len(grads)} of {len(ref_w)} weights")
    w_err = max(_rel_err(grads[k], ref_w[k]) for k in ref_w)
    out = {"stack": part, "stages": PIPE_N, "microbatches": PIPE_M,
           "batch_size": batch, **(search or {}), "layers": len(xs),
           "out_rel_err": max(_rel_err(r[0], ref_out) for r in runs),
           "dh_rel_err": max(_rel_err(r[1], ref_dh) for r in runs),
           "weight_grad_rel_err_max": w_err,
           "launches": {k: counts[k] for k in ("K1", "K2", "K3")},
           "plain_ms": plain_ms, "pipeline_ms_both_stages_one_card": pipe_ms,
           "peak_mem_gb": _peak_gb(device)}
    if sample:
        out["d_enc_out_rel_err"] = max(_rel_err(r[2][0], ref_ds[0])
                                       for r in runs)
    emit({"phase": "parallel", "part": "gpipe", **out})
    flags = tw.decoder_flags(model, t)
    blocks = 1 if part == "encoder" else (int(flags["flash_self"])
                                          + int(flags["flash_cross"]))
    want = len(xs) * PIPE_M * blocks
    check(counts["K1"] == counts["K2"] == want and counts["K3"] == 0,
          f"GPipe {part}: launches {counts}, expected K1 = K2 = {want}")
    for key in ("out_rel_err", "dh_rel_err", "d_enc_out_rel_err"):
        if key in out:
            check(out[key] <= PIPE_O_TOL, f"GPipe {part}: {key} "
                  f"{out[key]} > {PIPE_O_TOL}")
    check(w_err <= GRAD_REL_TOL, f"GPipe {part}: stage weight gradients "
          f"{w_err} off the plain loop's")
    return out


def _gpipe(device: str = "cuda") -> list:
    """GPipe on the encoder stack (whisper-base's 6 layers, 3 a stage) and
    the decoder's teacher-forcing stack, with each layer's weights taking
    gradients."""
    config, _, state, frozen, _, _ = _train_setup(1, device)
    model = frozen.model
    model.requires_grad_(False)
    for layers in (model.encoder.layers, model.decoder.layers):
        layers.requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(11)
    out = [_gpipe_largest(part, model, gen, device)
           for part in ("encoder", "decoder")]
    del state, frozen, model
    _empty_cache(device)
    return out


def _gpipe_largest(part: str, model, gen, device: str) -> dict:
    """``_gpipe_stack`` at the largest of PIPE_BATCHES[part] that fits on
    the card: each batch from the largest down until one runs; only running
    out of memory moves on to the next, and those batches are recorded,
    with the card's free memory and the allocator's share of it before the
    first try."""
    gc.collect()
    _empty_cache(device)
    search = {"out_of_memory_at": []}
    if device == "cuda":
        search["free_gb_before"] = torch.cuda.mem_get_info()[0] / 2**30
        search["allocated_gb_before"] = torch.cuda.memory_allocated() / 2**30
    for batch in PIPE_BATCHES[part]:
        try:
            return _gpipe_stack(part, model, gen, device, batch, search)
        except torch.cuda.OutOfMemoryError:
            search["out_of_memory_at"].append(batch)
        for p in model.parameters():
            p.grad = None
        gc.collect()
        _empty_cache(device)
    raise RuntimeError(f"GPipe {part}: no batch of {PIPE_BATCHES[part]} "
                       f"fits on the card")


def _remat_sp(device: str = "cuda") -> dict:
    """The SP step (``seq_parallel_axis`` over a one-rank NCCL group) with
    each encoder layer under remat, policies REMAT_SP_POLICIES, beside the
    step without: one step's loss and gradients against no remat's at one
    state (every LoRA B refilled at a trained magnitude, as the ring
    phase's check: with B at 0 the A gradients are 0), K4's launches in it
    (the ring's forward runs again in the backward under both policies:
    nothing of it is kept), then ms per step and peak memory of each."""
    from neuspeech1_tpu_torch.models.lora import entries
    from neuspeech1_tpu_torch.train.trainstep import (make_loss_fn,
                                                      make_train_step)

    out = {}
    with _one_rank_mesh():
        config, tx, state, frozen, step, batch = _train_setup(
            TRAIN_BATCH, device, seq_parallel_axis="seq")
        stem = frozen.model.stem_config
        n_layers = config.encoder_layers
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for _, e in entries(frozen.lora):
                e["B"].copy_(TRAINED_B_STD * torch.randn(e["B"].shape,
                                                         generator=gen))
        settings = [("none", {})] + [
            (p or "full", {"remat": True, "remat_policy": p})
            for p in REMAT_SP_POLICIES]
        ref = None
        for name, changes in settings:
            with _replaced_config(frozen.model, **changes) as c:
                _reset_counts()
                loss, grads = _grads(make_loss_fn(c, stem, fold_lora=True),
                                     state, frozen, batch)
                counts = _kernel_counts()
            rec = {"loss": loss, "K4": counts["K4"],
                   "K4_bwd": counts["K4_bwd"]}
            want_k4 = n_layers * (1 if name == "none" else 2)
            check(counts["K4"] == want_k4 and counts["K4_bwd"] == n_layers,
                  f"remat under SP {name}: K4 {counts['K4']} / "
                  f"{counts['K4_bwd']}, expected {want_k4} / {n_layers}")
            if ref is None:
                ref = (loss, grads)
            else:
                errs = _leaf_errs(grads, ref[1])
                rec.update(grad_rel_err=errs["max"], leaf=errs["leaf"],
                           bit_equal=all(torch.equal(grads[k], ref[1][k])
                                         for k in ref[1]))
                check(errs["max"] <= GRAD_REL_TOL,
                      f"remat under SP {name}: grads off no remat's: "
                      f"{errs['leaf']} {errs['max']}")
                check(abs(loss - ref[0]) <= LOSS_TOL * abs(ref[0]),
                      f"remat under SP {name}: loss {loss}, no remat "
                      f"{ref[0]}")
            out[name] = rec
        for name, changes in settings:
            with _replaced_config(frozen.model, **changes) as c:
                timed = _timed_steps(make_train_step(c, stem, tx,
                                                     fold_lora=True),
                                     state, frozen, batch)
            out[name].update({k: timed[k] for k in (
                "step_ms", "step_ms_all", "peak_mem_gb")})
            emit({"phase": "parallel", "part": "remat_sp", "policy": name,
                  **out[name]})
        del state, frozen, step
    _empty_cache(device)
    return out


def _torchrun_cli(tmp: str, device: str = "cuda") -> dict:
    """The fine-tune CLI with --mesh_data=-1 started as torchrun starts a
    one-process world (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT in the environment): PAR_CLI_STEPS steps with a save every
    two, then a resume to two more; the process group it starts (NCCL on
    the card, world size 1) and that it ends it."""
    import socket

    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh

    corpus, tokenizer = _finetune_corpus(tmp, 50257)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved_env = {k: os.environ.get(k) for k in env}
    groups = []
    init = pmesh.initialize_distributed

    def recorded(backend="nccl", *a, **k):
        up = init(backend, *a, **k)
        groups.append({"backend": backend, "up": up,
                       "world_size": dist.get_world_size() if up else None})
        return up

    out_dir = os.path.join(tmp, "cli_torchrun")
    argv = [f"--train_data={corpus}/train.jsonl", "--base_model=random",
            f"--tokenizer={tokenizer}", "--eeg_ch=208",
            f"--per_device_train_batch_size={FT_BATCH}",
            f"--label_max_length={FT_LABEL_LEN}", "--warmup_steps=1",
            "--logging_steps=1", "--save_steps=2", "--eval_steps=1000",
            "--eval_wer=False", "--remat=False", "--mesh_data=-1",
            f"--output_dir={out_dir}", f"--device={device}"]
    os.environ.update(env)
    pmesh.initialize_distributed = recorded
    try:
        first = _run_finetune(argv + [f"--max_steps={PAR_CLI_STEPS}"])
        resumed = _run_finetune(argv + [f"--max_steps={PAR_CLI_STEPS + 2}",
                                        "--resume_from_checkpoint=latest"])
    finally:
        pmesh.initialize_distributed = init
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = [r["loss"] for r in first["records"] if "loss" in r]
    after = [r for r in resumed["records"] if "loss" in r]
    out = {"env": sorted(env), "groups": groups,
           "group_ended": not dist.is_initialized(),
           "losses": losses, "resumed_steps": [r["step"] for r in after],
           "resumed_lines": resumed["lines"],
           "restored_step": (resumed["restored"] or {}).get("step"),
           "checkpoints": sorted(os.listdir(os.path.join(out_dir,
                                                         "checkpoints"))),
           "step_ms": [s["ms"] for s in first["steps"]],
           "launches": first["steps"][-1]["launches"],
           "wall_s": [first["wall_s"], resumed["wall_s"]],
           "peak_mem_gb": first["peak_mem_gb"]}
    emit({"phase": "parallel", "part": "torchrun_cli", **out})
    backend = "nccl" if device == "cuda" else "gloo"
    check(len(groups) == 2 and all(
        g["up"] and g["backend"] == backend and g["world_size"] == 1
        for g in groups), f"CLI process groups {groups}")
    check(out["group_ended"], "the CLI left its process group up")
    check(len(losses) == PAR_CLI_STEPS
          and all(math.isfinite(x) for x in losses), f"CLI losses {losses}")
    check(out["restored_step"] == PAR_CLI_STEPS
          and out["resumed_steps"][-2:] == [PAR_CLI_STEPS + 1,
                                            PAR_CLI_STEPS + 2]
          and os.path.exists(os.path.join(out_dir, "adapter_final.npz")),
          f"CLI resume: restored {out['restored_step']}, steps "
          f"{out['resumed_steps']}")
    return out


def _profiled_steps(tmp: str, device: str = "cuda") -> dict:
    """``train/profiling.py``'s Profiler around two of three train steps
    (annotated 'train_step', timed by StepTimer): the chrome trace it
    writes holds both annotations and the names of K1's, K2's and K3's
    kernels."""
    from neuspeech1_tpu_torch.train.profiling import (Profiler, StepTimer,
                                                      annotate)

    _, _, state, frozen, step, batch = _train_setup(TRAIN_BATCH, device)
    prof = Profiler(os.path.join(tmp, "profile"), start_step=0, num_steps=1)
    timer = StepTimer()
    for i in range(3):
        prof.maybe_start(i)
        with timer.measure():
            with annotate("train_step"):
                m = step(state, frozen, batch)
            timer.block(m)
        prof.maybe_stop(i)
    prof.close()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    # the host's annotation events (the card's copies have their own
    # category), and the kernels by name
    found = {"train_step": sum(e.get("cat") == "user_annotation"
                               and e.get("name") == "train_step"
                               for e in events)}
    found.update({k: sum(e.get("cat") == "kernel" and k in e.get("name", "")
                         for e in events) for k in PROFILE_NAMES[1:]})
    out = {"trace_bytes": os.path.getsize(prof.trace_path),
           "events": len(events), "found": found,
           "step_ms": [1e3 * t for t in timer.times],
           "mean_ms": timer.mean_ms}
    emit({"phase": "parallel", "part": "profiler", **out})
    check(found["train_step"] == 2, f"profiler: {found['train_step']} "
          "train_step annotations in the trace, expected 2")
    check(all(found[k] > 0 for k in PROFILE_NAMES),
          f"profiler: the trace misses a kernel: {found}")
    del state, frozen, step
    _empty_cache(device)
    return out


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _reset_peak(device):
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(device):
    return (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else None)


def _empty_cache(device):
    if device == "cuda":
        torch.cuda.empty_cache()


def phase_parallel(device: str = "cuda") -> dict:
    """Multi-device training at whisper-base width on one card: the data
    parallel step on LocalRing threads against the one-rank step, GPipe on
    both stacks against the plain loops, remat under sequence parallelism
    against no remat, the fine-tune CLI under a torchrun environment
    (train, save, resume) and the profiler's trace."""
    dp = _dp_step(device)
    gp = _gpipe(device)
    rs = _remat_sp(device)
    with tempfile.TemporaryDirectory() as tmp:
        cli = _torchrun_cli(tmp, device)
        pf = _profiled_steps(tmp, device)
    check(_jax_free(), "jax or the JAX package was imported")
    out = {"phase": "parallel", "dp_step": dp, "gpipe": gp, "remat_sp": rs,
           "cli": cli, "profiler": pf, "jax_imported": not _jax_free(),
           "card": card() if device == "cuda" else None}
    emit({"phase": "parallel", "card": out["card"],
          "jax_imported": out["jax_imported"]})
    return out


# --------------------------------------------------------------------------
# the sharded phase: FSDP and tensor parallelism in processes on one card
# --------------------------------------------------------------------------

def _measured(step, device: str, ring, out: dict):
    """``step`` recording into ``out`` per call: the ce loss, the pre-clip
    gradient norm, the kernels' launches, the ms (host clock, the device
    synchronized and, with ``ring``, the ranks at a barrier on each side:
    the step of every rank sharing the card) and the ms and bytes of the
    hops staged through host memory (the ``ring.staged_*`` counters of
    ``train/profiling.py``)."""
    from neuspeech1_tpu_torch.train import profiling

    for key in ("ce_loss", "grad_norm", "ms", "launches", "staged_ms",
                "staged_bytes"):
        out.setdefault(key, [])

    def timed(state, frozen, batch):
        if ring is not None:
            ring.barrier()
        _reset_counts()
        before = profiling.counters()
        t0 = time.perf_counter()
        m = step(state, frozen, batch)
        out["ce_loss"].append(float(m["ce_loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        _sync(device)
        if ring is not None:
            ring.barrier()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["launches"].append({k: v for k, v in _kernel_counts().items()
                                if v})
        staged = profiling.counter_changes(before)
        out["staged_ms"].append(staged.get("ring.staged_ms", 0.0))
        out["staged_bytes"].append(staged.get("ring.staged_bytes", 0))
        return m

    return timed


def _shard_steps(step, state, frozen, batch, device: str, ring=None) -> dict:
    """SHARD_STEPS train steps `_measured`, then the peak memory."""
    out = {}
    _sync(device)
    _reset_peak(device)
    timed = _measured(step, device, ring, out)
    for _ in range(SHARD_STEPS):
        timed(state, frozen, batch)
    out["peak_mem_gb"] = _peak_gb(device)
    return out


def _state_bytes(state) -> dict:
    """Bytes of the trainable leaves and of their AdamW moments."""
    opt = state.opt_state
    return {"params": sum(t.nbytes for t in state.trainable.values()),
            "adam": sum(opt.mu[k].nbytes + opt.nu[k].nbytes
                        for k in state.trainable)}


def _bits_equal_over(ring, tensors) -> bool:
    """Whether ``tensors`` are the same bits on every rank of ``ring``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    parts = ring.all_gather(flat.view(torch.int32)[None], 0)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _shard_references(device: str) -> dict:
    """The one-rank runs the sharded phase holds its ranks to, in this
    (warm) process before the ranks start: the LoRA 'fc' step at
    TRAIN_BATCH, the --ft_full step at SHARD_FSDP_BATCH (with its bytes of
    parameters and Adam state), and the greedy request of `_shard_request`."""
    out = {}
    _, _, st, fz, stp, batch = _train_setup(TRAIN_BATCH, device)
    out["tp_step"] = _shard_steps(stp, st, fz, batch, device)
    del st, fz, stp, batch
    _empty_cache(device)
    _, _, st, fz, stp, batch = _train_setup(SHARD_FSDP_BATCH, device,
                                            ft_full=True)
    out["fsdp_tp_step"] = {**_shard_steps(stp, st, fz, batch, device),
                           "bytes": _state_bytes(st)}
    del st, fz, stp, batch
    _empty_cache(device)
    model, feats, prompt, gen = _shard_request_inputs(device)
    out["serving"] = _shard_request(model, feats, prompt, gen, device)
    del model
    _empty_cache(device)
    return out


def _shard_tp_step(rank: int, pair, device: str) -> dict:
    """The train phase's LoRA 'fc' step (batch TRAIN_BATCH) on ranks 0 and
    1 split over {tensor: 2} (each rank the whole batch, 4 of 8 heads, fc1
    and fc2 in halves), ranks 2 and 3 waiting; the trainable (replicated)
    leaves compared bit for bit across the two ranks."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh

    out = {}
    if rank < 2:
        with pmesh.set_mesh({"tensor": pair}):
            _, _, st, fz, stp, batch = _train_setup(TRAIN_BATCH, device,
                                                    shard=True)
            out["sharded"] = _shard_steps(stp, st, fz, batch, device, pair)
            out["replicated_bits_equal"] = _bits_equal_over(
                pair, st.trainable.values())
        del st, fz, stp, batch
        _empty_cache(device)
    dist.barrier()
    return out


def _shard_fsdp_step(rank: int, device: str) -> dict:
    """Every leaf trainable (--ft_full), batch SHARD_FSDP_BATCH, on the four
    ranks as {fsdp: 2, tensor: 2} (a ``DeviceMesh`` over the gloo group;
    16 rows a rank): each rank's bytes of parameters and AdamW state, and
    the leaves no axis splits compared bit for bit across the four
    ranks."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel import sharding
    from neuspeech1_tpu_torch.parallel.ring_attention import DistRing

    out = {}
    mesh = pmesh.make_mesh(device, fsdp=2, tensor=2)
    with pmesh.set_mesh(mesh):
        _, _, st, fz, stp, batch = _train_setup(SHARD_FSDP_BATCH, device,
                                                shard=True, ft_full=True)
        shard = pmesh.batch_sharding()
        rows = {k: shard.shard(v) for k, v in batch.items()}
        world = DistRing(dist.group.WORLD)
        out["sharded"] = {**_shard_steps(stp, st, fz, rows, device, world),
                          "rows_per_rank": rows["labels"].shape[0],
                          "bytes": _state_bytes(st)}
        specs = sharding.leaf_specs(fz.model)
        out["replicated_bits_equal"] = _bits_equal_over(
            world, [t for k, t in st.trainable.items() if k not in specs])
    del st, fz, stp, batch
    _empty_cache(device)
    dist.barrier()
    return out


def _shard_request_inputs(device: str):
    """A bf16 whisper-base model from a seed, SHARD_CLIPS clips of seeded
    signals, their prompts and greedy settings for SHARD_NEW_TOKENS new
    tokens."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.decode.generate import GenerationConfig
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params

    config, stem = common.preset_model("base", "base", in_channels=208)
    model = module_from_params(init_params(config, stem, seed=0), config,
                               stem, device=device)
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.standard_normal(
        (SHARD_CLIPS, stem.in_channels, 4 * config.max_source_positions))
        .astype(np.float32)).to(device, model.dtype)
    prompt = torch.tensor([[config.sot_id, config.first_language_id,
                            config.transcribe_id, config.notimestamps_id]]
                          * SHARD_CLIPS, device=device)
    gen = GenerationConfig.for_model(
        config, max_length=prompt.shape[1] + SHARD_NEW_TOKENS)
    return model, feats, prompt, gen


def _shard_request(model, feats, prompt, gen, device: str) -> dict:
    """One greedy request through ``generate_over_mesh`` under the ambient
    mesh: its ms, the kernels' launches and every clip's tokens."""
    from neuspeech1_tpu_torch.decode.generate import generate_over_mesh

    _reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    tokens = generate_over_mesh(model, feats, prompt, gen)
    _sync(device)
    return {"ms": 1e3 * (time.perf_counter() - t0),
            "launches": {k: v for k, v in _kernel_counts().items() if v},
            "tokens": tokens.cpu().tolist()}


def _shard_serving(rank: int, pair, device: str) -> dict:
    """`_shard_request` on ranks 0 and 1 as {tensor: 2} (the weights split,
    4 heads a rank in K1, K6 and K7) and as {data: 2} (half the clips a
    rank), each rank returning every clip's tokens, ranks 2 and 3
    waiting."""
    import copy

    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel import sharding

    model, feats, prompt, gen = _shard_request_inputs(device)
    out = {}
    for name in ("tensor", "data"):
        if rank < 2:
            mesh = {name: pair}
            with pmesh.set_mesh(mesh):
                m = (sharding.shard_params(copy.deepcopy(model), mesh)
                     if name == "tensor" else model)
                out[name] = _shard_request(m, feats, prompt, gen, device)
                out[name]["ranks_agree"] = _bits_equal_over(
                    pair, [torch.tensor(out[name]["tokens"])])
            del m
        dist.barrier()
    del model
    _empty_cache(device)
    return out


def _shard_cli(rank: int, out_dir: str, corpus: str, tokenizer: str,
               device: str) -> dict:
    """The fine-tune CLI in every process at --mesh_fsdp=2 --mesh_tensor=2
    (the gloo group is up before ``main``, which adopts it), --ft_full,
    batch SHARD_CLI_BATCH (16 rows a rank): SHARD_CLI_STEPS steps with a
    save every two and eval loss and eval-WER at the last, then a resume
    to two more; rank 0 reads the checkpoints' tensors."""
    import torch.distributed as dist

    run = os.path.join(out_dir, "cli")
    argv = [f"--train_data={corpus}/train.jsonl",
            f"--val_data={corpus}/eval.jsonl", "--base_model=random",
            f"--tokenizer={tokenizer}", "--eeg_ch=208", "--ft_full=True",
            f"--per_device_train_batch_size={SHARD_CLI_BATCH}",
            f"--per_device_eval_batch_size={SHARD_EVAL_BATCH}",
            f"--label_max_length={FT_LABEL_LEN}", "--warmup_steps=1",
            "--logging_steps=1", "--save_steps=2",
            f"--eval_steps={SHARD_CLI_STEPS}", "--eval_wer=True",
            "--remat=False", "--mesh_fsdp=2", "--mesh_tensor=2",
            f"--output_dir={run}", f"--device={device}"]
    before = _kernel_counts()
    first = _run_finetune(argv + [f"--max_steps={SHARD_CLI_STEPS}"])
    counts = {k: v - before[k] for k, v in _kernel_counts().items()
              if v - before[k]}
    resumed = _run_finetune(argv + [f"--max_steps={SHARD_CLI_STEPS + 2}",
                                    "--resume_from_checkpoint=latest"])
    out = {"step_ms": [s["ms"] for s in first["steps"]],
           "launches": counts, "wall_s": [first["wall_s"],
                                          resumed["wall_s"]],
           "peak_mem_gb": first["peak_mem_gb"],
           "restored_step": (resumed["restored"] or {}).get("step"),
           "resumed_steps": [r["step"] for r in resumed["records"]
                             if "loss" in r][-2:],
           # metrics.jsonl after the resume: both runs' records
           "records": resumed["records"]}
    dist.barrier()
    if rank == 0:
        out["checkpoints"] = _whole_shapes(run)
    return out


def _whole_shapes(run: str) -> dict:
    """Of each checkpoint of a CLI run: whether every trainable tensor and
    its moments have the shapes of a one-rank whisper-base model's leaves
    (its vocabulary from the file's embedding)."""
    import dataclasses

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.whisper import Whisper
    from neuspeech1_tpu_torch.train.optimizer import named_leaves

    out = {}
    ck = os.path.join(run, "checkpoints")
    for step in sorted(d for d in os.listdir(ck) if d.isdigit()):
        saved = torch.load(os.path.join(ck, step, "state.pt"),
                           map_location="cpu", weights_only=True)
        config, stem = common.preset_model("base", "base", in_channels=208)
        vocab = saved["trainable"]["model/decoder/token_embed"].shape[0]
        with torch.device("meta"):
            whole = named_leaves(Whisper(dataclasses.replace(
                config, vocab_size=vocab), stem))
        moments = saved["opt_state"]
        out[step] = {
            "leaves": len(saved["trainable"]),
            "whole": set(saved["trainable"]) == set(whole) and all(
                t.shape == whole[k].shape == moments["mu"][k].shape
                == moments["nu"][k].shape
                for k, t in saved["trainable"].items()),
            "embed_shape": list(saved["trainable"][
                "model/decoder/token_embed"].shape)}
    return out


@contextlib.contextmanager
def _gloo_process(rank: int, world: int, store: str, out_dir: str,
                  device: str):
    """One of ``world`` processes on the one card: its output to
    ``rank{rank}.log``, a gloo group from a FileStore (collectives on CUDA
    tensors; a collective that waits past SHARD_GROUP_TIMEOUT_S raises),
    destroyed on leaving."""
    import datetime

    import torch.distributed as dist

    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sharded_worker(rank: int, world: int, store: str, out_dir: str,
                    corpus: str, tokenizer: str, device: str) -> None:
    """One of the sharded phase's processes (`_gloo_process`): pairs of
    ranks (0, 1) and (2, 3) as subgroups, then the phase's parts in order;
    its results go to ``rank{rank}.json``."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel.ring_attention import DistRing

    with _gloo_process(rank, world, store, out_dir, device):
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = DistRing(pairs[rank // 2])
        out = {"rank": rank}
        out["tp_step"] = _shard_tp_step(rank, pair, device)
        out["fsdp_tp_step"] = _shard_fsdp_step(rank, device)
        out["serving"] = _shard_serving(rank, pair, device)
        out["cli"] = _shard_cli(rank, out_dir, corpus, tokenizer, device)
        out["jax_imported"] = not _jax_free()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


def _run_ranks(fn, args: tuple, n: int, out_dir: str,
               phase: str = "sharded") -> float:
    """``fn(rank, *args)`` in ``n`` spawned processes; the wall seconds. A
    rank that raises fails the run with its traceback, after the others
    are stopped; ranks still running after SHARD_TIMEOUT_S are killed and
    fail it too. Each rank's log tail goes to stderr on failure."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=n, join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                raise RuntimeError(f"{phase} phase: ranks still running "
                                   f"after {SHARD_TIMEOUT_S} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for r in range(n):
            path = os.path.join(out_dir, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    tail = f.read()[-3000:]
                print(f"--- {phase} rank {r} log tail ---\n{tail}",
                      file=sys.stderr, flush=True)
        raise
    return time.perf_counter() - t0


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_sharded(device: str = "cuda") -> dict:
    """FSDP and tensor parallelism at whisper-base width in SHARD_PROCS
    processes sharing the one card over a gloo group: the LoRA 'fc' step
    at batch 64 over {tensor: 2} and the --ft_full step at batch 32 over
    {fsdp: 2, tensor: 2}, each against the one-rank step run in this
    process first (`_shard_references`; ce loss within
    SHARD_LOSS_RTOL, pre-clip gradient norm within SHARD_GRAD_NORM_RTOL,
    the replicated leaves the same bits on every rank), K1/K2/K3 launches
    per rank and step, ms per step with the ranks sharing the card (not a
    multi-card figure), peak memory and each rank's parameter and Adam
    bytes; greedy serving under {tensor: 2} and {data: 2} against one rank
    (the share of equal tokens); the fine-tune CLI in four processes at
    --mesh_fsdp=2 --mesh_tensor=2 (train, save whole tensors, eval loss and
    eval-WER, resume)."""
    _sync(device)
    gc.collect()
    _empty_cache(device)
    refs = _shard_references(device)
    gc.collect()
    _empty_cache(device)
    with tempfile.TemporaryDirectory() as tmp:
        corpus, tokenizer = _finetune_corpus(tmp, 50257)
        out_dir = os.path.join(tmp, "ranks")
        os.makedirs(out_dir)
        wall = _run_ranks(_sharded_worker, (
            SHARD_PROCS, os.path.join(tmp, "store"), out_dir, corpus,
            tokenizer, device), SHARD_PROCS, out_dir)
        runs = []
        for r in range(SHARD_PROCS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                runs.append(json.load(f))
    tp, fs = runs[0]["tp_step"], runs[0]["fsdp_tp_step"]
    sv, cli = runs[0]["serving"], runs[0]["cli"]
    from neuspeech1_tpu_torch.cli import common

    n_layers = common.preset_model("base", "base")[0].encoder_layers
    out = {"procs": SHARD_PROCS, "wall_s": wall, "card": card()
           if device == "cuda" else None}
    for name, part, mesh in (("tp_step", tp, {"tensor": 2}),
                             ("fsdp_tp_step", fs, {"fsdp": 2, "tensor": 2})):
        one, sh = refs[name], part["sharded"]
        rec = {"mesh": mesh, "ce_loss": {"one_rank": one["ce_loss"],
                                         "sharded": sh["ce_loss"]},
               "grad_norm": {"one_rank": one["grad_norm"],
                             "sharded": sh["grad_norm"]},
               "loss_rtol": SHARD_LOSS_RTOL,
               "grad_norm_rtol": SHARD_GRAD_NORM_RTOL,
               "launches_per_rank_per_step": sh["launches"][-1],
               "one_rank_launches_per_step": one["launches"][-1],
               "step_ms_ranks_sharing_one_card": sh["ms"],
               "one_rank_step_ms": one["ms"],
               "peak_mem_gb_per_rank": [r[name]["sharded"]["peak_mem_gb"]
                                        for r in runs
                                        if "sharded" in r[name]],
               "one_rank_peak_mem_gb": one["peak_mem_gb"],
               "replicated_bits_equal": part["replicated_bits_equal"]}
        if "bytes" in sh:
            rec["bytes_per_rank"] = [r[name]["sharded"]["bytes"]
                                     for r in runs]
            rec["one_rank_bytes"] = one["bytes"]
        out[name] = rec
        emit({"phase": "sharded", "part": name, **rec})
        for a, b in zip(sh["ce_loss"], one["ce_loss"]):
            check(_rel(a, b) <= SHARD_LOSS_RTOL,
                  f"sharded {name}: ce_loss {a}, one-rank {b}")
        for a, b in zip(sh["grad_norm"], one["grad_norm"]):
            check(_rel(a, b) <= SHARD_GRAD_NORM_RTOL,
                  f"sharded {name}: grad_norm {a}, one-rank {b}")
        check(part["replicated_bits_equal"],
              f"sharded {name}: replicated leaves differ across ranks")
        check(all(r[name]["sharded"]["ce_loss"] == sh["ce_loss"]
                  for r in runs if "sharded" in r[name]),
              f"sharded {name}: the ranks' losses differ")
        want = {"K1": 2 * n_layers, "K2": 2 * n_layers}
        if name == "tp_step":
            want["K3"] = 2 * n_layers
        got = sh["launches"][-1]
        check(all(got.get(k) == v for k, v in want.items()),
              f"sharded {name}: launches per rank {got}, expected {want}")
    b1 = out["fsdp_tp_step"]["one_rank_bytes"]
    for b in out["fsdp_tp_step"]["bytes_per_rank"]:
        check(b["params"] < b1["params"] and b["adam"] < b1["adam"],
              f"sharded fsdp_tp_step: a rank holds {b}, one rank {b1}")
    ref = refs["serving"]["tokens"]
    serving = {}
    for name in ("tensor", "data"):
        r = sv[name]
        flat = [(a == b) for ra, rb in zip(r["tokens"], ref)
                for a, b in zip(ra[4:], rb[4:])]
        serving[name] = {"ms_ranks_sharing_one_card": r["ms"],
                         "one_rank_ms": refs["serving"]["ms"],
                         "launches_per_rank": r["launches"],
                         "one_rank_launches": refs["serving"]["launches"],
                         "equal_token_share": sum(flat) / len(flat),
                         "ranks_agree": r["ranks_agree"]}
        check(r["ranks_agree"], f"sharded serving {name}: the ranks' "
              "tokens differ")
        check(len(r["tokens"]) == SHARD_CLIPS, f"sharded serving {name}: "
              f"{len(r['tokens'])} rows, expected {SHARD_CLIPS}")
        for k in ("K1", "K6", "K7"):
            check(r["launches"].get(k, 0) > 0,
                  f"sharded serving {name}: no {k} launch")
    out["serving"] = serving
    emit({"phase": "sharded", "part": "serving", **serving})
    records = cli["records"]
    evals = [r for r in records if "eval_wer" in r]
    cli_out = {k: cli[k] for k in ("step_ms", "launches", "wall_s",
                                   "peak_mem_gb", "restored_step",
                                   "resumed_steps", "checkpoints")}
    cli_out["losses"] = [r["loss"] for r in records if "loss" in r]
    cli_out["evals"] = evals
    out["cli"] = cli_out
    emit({"phase": "sharded", "part": "cli", **cli_out})
    check(cli["restored_step"] == SHARD_CLI_STEPS
          and cli["resumed_steps"] == [SHARD_CLI_STEPS + 1,
                                       SHARD_CLI_STEPS + 2],
          f"sharded CLI resume: restored {cli['restored_step']}, steps "
          f"{cli['resumed_steps']}")
    check(all(math.isfinite(x) for x in cli_out["losses"])
          and len(cli_out["losses"]) == SHARD_CLI_STEPS + 2,
          f"sharded CLI losses {cli_out['losses']}")
    check(len(evals) >= 1 and all(math.isfinite(r["eval_loss"])
                                  for r in evals),
          f"sharded CLI evals {evals}")
    check(sorted(cli["checkpoints"]) == ["2", "4", "6"] or len(
        cli["checkpoints"]) >= 2, f"CLI checkpoints {cli['checkpoints']}")
    check(all(c["whole"] for c in cli["checkpoints"].values()),
          f"sharded CLI: a checkpoint holds split tensors "
          f"{cli['checkpoints']}")
    for k in ("K1", "K2", "K6", "K7"):
        check(cli["launches"].get(k, 0) > 0, f"sharded CLI: no {k} launch")
    check(not any(r["jax_imported"] for r in runs),
          "a sharded rank imported jax or the JAX package")
    emit({"phase": "sharded", "wall_s": wall, "card": out["card"]})
    return out


def _composed_want(axes: dict, ft_full: bool, n_layers: int) -> dict:
    """The launches per rank and step the composed grid ``axes`` predicts:
    each rank runs L/P layers of each stack on each of its M microbatches
    (M = 1 without a pipe axis); K1 and K2 in the decoder's
    cross-attention, and in the encoder's self-attention unless the ring
    takes it, where K4 runs n rounds a layer each way; K3 in the encoder's
    two fc adapters (none under --ft_full)."""
    p = axes.get("pipe", 1)
    per = n_layers // p * (COMPOSED_M if p > 1 else 1)
    seq = axes.get("seq", 1)
    want = {"K1": per * (1 if seq > 1 else 2)}
    want["K2"] = want["K1"]
    if not ft_full:
        want["K3"] = 2 * per
    if seq > 1:
        want["K4"] = want["K4_bwd"] = per * seq
    return want


def _composed_trainer(run: str, kw: dict, device: str, world,
                      rec: dict) -> dict:
    """The --ft_full step through ``train/trainer.py`` under the ambient
    mesh, each rank on its rows: one step and a save of whole tensors,
    then a trainer on fresh weights resuming from it for the second step
    (and its save), every step `_measured` into ``rec``. Returns the
    resumed state and model, the restored step and the rows a rank."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.train.trainer import Trainer

    stem = common.preset_model("base", "base", in_channels=208)[1]
    out = {}
    for max_steps in (1, COMPOSED_STEPS):
        before = len(rec.get("ce_loss", ()))
        config, tx, st, fz, _, batch = _train_setup(COMPOSED_BATCH, device,
                                                    **kw)
        shard = pmesh.batch_sharding()
        rows = {k: shard.shard(v) for k, v in batch.items()}
        tr = Trainer(config, stem, tx, st, fz, [rows], output_dir=run,
                     max_steps=max_steps, save_steps=COMPOSED_STEPS + 1,
                     logging_steps=COMPOSED_STEPS + 1)
        tr.train_step = _measured(tr.train_step, device, world, rec)
        resume = max_steps > 1
        state = tr.train(resume_from_checkpoint=resume)
        tr.ckpt.close()
        if resume:
            ran = len(rec["ce_loss"]) - before
            out.update(state=state, frozen=fz, rows=rows["labels"].shape[0],
                       restored_step=state.step - ran)
        del tr, st, fz, batch, rows
        gc.collect()
        _empty_cache(device)
    return out


def _composed_grid(name: str, axes: dict, ft_full: bool, out_dir: str,
                   device: str) -> dict:
    """One grid of the composed phase on this rank: COMPOSED_STEPS steps
    at COMPOSED_BATCH rows (split over fsdp where the grid has it; the
    pipe, seq and tensor ranks share them), the peak memory, and the
    leaves no axis splits compared bit for bit across the four ranks."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel import sharding
    from neuspeech1_tpu_torch.parallel.ring_attention import DistRing

    world = DistRing(dist.group.WORLD)
    kw = {"seq_parallel_axis": "seq" if "seq" in axes else None,
          "pipeline_axis": "pipe" if "pipe" in axes else None,
          "shard": bool({"fsdp", "tensor"} & set(axes)), "ft_full": ft_full}
    rec, out = {}, {"mesh": axes}
    with pmesh.set_mesh(pmesh.make_mesh(device, **axes)):
        _sync(device)
        _reset_peak(device)
        if ft_full:
            run = _composed_trainer(os.path.join(out_dir, name), kw, device,
                                    world, rec)
            st, fz = run.pop("state"), run.pop("frozen")
            out.update(run)
        else:
            _, _, st, fz, stp, batch = _train_setup(COMPOSED_BATCH, device,
                                                    **kw)
            shard = pmesh.batch_sharding()
            rows = {k: shard.shard(v) for k, v in batch.items()}
            timed = _measured(stp, device, world, rec)
            for _ in range(COMPOSED_STEPS):
                timed(st, fz, rows)
            out["rows"] = rows["labels"].shape[0]
            del stp, batch, rows
        rec["peak_mem_gb"] = _peak_gb(device)
        specs = sharding.leaf_specs(fz.model)
        out["replicated_bits_equal"] = _bits_equal_over(
            world, [t for k, t in st.trainable.items() if k not in specs])
    out["steps"] = rec
    del st, fz
    gc.collect()
    _empty_cache(device)
    dist.barrier()
    if ft_full and dist.get_rank() == 0:
        out["checkpoints"] = _whole_shapes(os.path.join(out_dir, name))
    return out


@contextlib.contextmanager
def _recorded_tokens():
    """The token ids of every ``generate_over_mesh`` call the Transcriber
    makes while the context is open, in a list."""
    from neuspeech1_tpu_torch import serve

    seen, decode = [], serve.generate_over_mesh

    def recording(*args, **kwargs):
        tokens = decode(*args, **kwargs)
        seen.append(tokens.cpu().tolist())
        return tokens

    serve.generate_over_mesh = recording
    try:
        yield seen
    finally:
        serve.generate_over_mesh = decode


def _composed_request(model_dir: str, tokenizer: str, device: str,
                      mesh=None) -> dict:
    """One greedy request of SHARD_CLIPS clips, SHARD_NEW_TOKENS new tokens
    through ``Transcriber(mesh=)``: its ms, the kernels' launches and every
    clip's tokens."""
    from neuspeech1_tpu_torch.serve import Transcriber

    tr = Transcriber(model_dir, tokenizer=tokenizer, batch_size=SHARD_CLIPS,
                     max_new_tokens=SHARD_NEW_TOKENS, device=device,
                     mesh=mesh)
    signals = _signals(tr.stem.in_channels, tr.expected_samples)
    _reset_counts()
    _sync(device)
    with _recorded_tokens() as seen:
        t0 = time.perf_counter()
        tr.transcribe(signals[:SHARD_CLIPS])
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
    return {"ms": ms, "launches": {k: v for k, v in _kernel_counts().items()
                                   if v}, "tokens": seen[0]}


def _composed_serving(model_dir: str, tokenizer: str, device: str) -> dict:
    """`_composed_request` on the four ranks as {pipe: 2, seq: 2}: the
    encoder pass as ring attention inside GPipe stages, the cached decoder
    on every rank; whether the ranks' tokens agree."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel.ring_attention import DistRing

    out = _composed_request(model_dir, tokenizer, device,
                            pmesh.make_mesh(device, pipe=2, seq=2))
    out["ranks_agree"] = _bits_equal_over(DistRing(dist.group.WORLD),
                                          [torch.tensor(out["tokens"])])
    _empty_cache(device)
    return out


def _composed_worker(rank: int, world: int, store: str, out_dir: str,
                     model_dir: str, tokenizer: str, device: str) -> None:
    """One of the composed phase's processes (`_gloo_process`): the grids,
    then the greedy request; its results go to ``rank{rank}.json``."""
    with _gloo_process(rank, world, store, out_dir, device):
        out = {"rank": rank}
        for name, axes, ft_full in COMPOSED_GRIDS:
            out[name] = _composed_grid(name, axes, ft_full, out_dir, device)
        out["serving"] = _composed_serving(model_dir, tokenizer, device)
        out["jax_imported"] = not _jax_free()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


def _composed_references(device: str, model_dir: str,
                         tokenizer: str) -> dict:
    """The one-rank runs the composed phase holds its grids to, in this
    process before the ranks start: the LoRA 'fc' step and the --ft_full
    step at COMPOSED_BATCH, COMPOSED_STEPS steps each, and the greedy
    request without a mesh."""
    out = {}
    for name, ft_full in (("lora", False), ("ft_full", True)):
        _, _, st, fz, stp, batch = _train_setup(COMPOSED_BATCH, device,
                                                ft_full=ft_full)
        rec = {}
        _sync(device)
        _reset_peak(device)
        timed = _measured(stp, device, None, rec)
        for _ in range(COMPOSED_STEPS):
            timed(st, fz, batch)
        rec["peak_mem_gb"] = _peak_gb(device)
        out[name] = rec
        del st, fz, stp, batch
        gc.collect()
        _empty_cache(device)
    out["serving"] = _composed_request(model_dir, tokenizer, device)
    _empty_cache(device)
    return out


def _composed_model(tmp: str):
    """`serving_model`'s directory and tokenizer, and a second directory
    with the same weights whose config names the {pipe: 2, seq: 2} mesh's
    axes (``seq_parallel_axis``, ``pipeline_axis``)."""
    _, model_dir, tokenizer = serving_model(tmp)
    composed = os.path.join(tmp, "composed_model")
    os.makedirs(composed)
    os.symlink(os.path.join(model_dir, "params.npz"),
               os.path.join(composed, "params.npz"))
    with open(os.path.join(model_dir, "config.json")) as f:
        meta = json.load(f)
    meta["config"].update(seq_parallel_axis="seq", pipeline_axis="pipe")
    with open(os.path.join(composed, "config.json"), "w") as f:
        json.dump(meta, f)
    return model_dir, composed, tokenizer


def _perf_script(main, argv) -> dict:
    """``main(argv)`` of a perf script in this process: its JSON lines and
    its wall seconds."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"{main.__module__}: exit code {rc}")
    lines = [json.loads(s) for s in buf.getvalue().splitlines()
             if s.startswith("{")]
    return {"seconds": time.perf_counter() - t0, "lines": lines}


def _composed_perf(tmp: str) -> dict:
    """serve_bench, spec_bench (greedy, one token an iteration, and gamma
    4) and trace_step --steps 2 once each in process at one timed
    repetition: their lines parse, their rates are finite, and
    trace_step's busy and idle times add up to its span."""
    from neuspeech1_tpu_torch.perf import serve_bench, spec_bench, trace_step

    out = {
        "serve_bench": _perf_script(serve_bench.main, ["--repeats", "1"]),
        "spec_bench": _perf_script(spec_bench.main, [
            "--repeats", "1", "--gammas", "4"]),
        "trace_step": _perf_script(trace_step.main, [
            "--steps", "2", "--top", "10",
            "--tracedir", os.path.join(tmp, "trace_step")])}
    serve = out["serve_bench"]["lines"]
    check([r["config"] for r in serve] == [
        "greedy", "greedy_int8kv", "beam5_rp5_ngram2",
        "beam5_rp5_ngram2_int8kv"], f"serve_bench lines {serve}")
    spec = out["spec_bench"]["lines"]
    check([r["config"] for r in spec] == [
        "greedy_int8kv", "spec_greedy_int8kv_g4", "spec_g4_analysis"],
        f"spec_bench lines {spec}")
    for r in serve + spec[:2]:
        check(math.isfinite(r["utterances_per_sec"])
              and r["utterances_per_sec"] > 0, f"perf line {r}")
    check(math.isfinite(spec[2]["iter_cost_ratio_vs_greedy_step"]),
          f"spec analysis {spec[2]}")
    trace = out["trace_step"]["lines"][-1]
    check(trace["kernels"] > 0 and trace["span_ms"] > 0
          and math.isclose(trace["busy_ms"] + trace["idle_ms"],
                           trace["span_ms"], rel_tol=1e-9)
          and 0 < trace["busy_share"] <= 1, f"trace_step {trace}")
    return out


def phase_composed(device: str = "cuda") -> dict:
    """The compositions of the mesh's parallel axes at whisper-base width
    in COMPOSED_PROCS processes sharing the one card over a gloo group (as
    the sharded phase's): the LoRA 'fc' step at batch COMPOSED_BATCH over
    {pipe: 2, seq: 2} (ring attention inside GPipe stages) and {tensor: 2,
    seq: 2}, the --ft_full step over {fsdp: 2, pipe: 2} through the
    trainer with a save and a resume, each against the one-rank step run
    in this process first (ce loss within SHARD_LOSS_RTOL, pre-clip
    gradient norm within SHARD_GRAD_NORM_RTOL, the leaves no axis splits
    the same bits on every rank, K1-K4 launches per rank and step as
    `_composed_want` predicts), ms per step with the ranks sharing the card
    (not a multi-card figure) and the share of it the host-staged ring and
    pipeline hops took, peak memory per rank; one greedy request under
    {pipe: 2, seq: 2} through ``Transcriber(mesh=)`` (the ranks agree; the
    share of tokens equal to one rank's); then the three perf scripts."""
    from neuspeech1_tpu_torch.cli import common

    _sync(device)
    gc.collect()
    _empty_cache(device)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir, composed_dir, tokenizer = _composed_model(tmp)
        refs = _composed_references(device, model_dir, tokenizer)
        gc.collect()
        _empty_cache(device)
        out_dir = os.path.join(tmp, "ranks")
        os.makedirs(out_dir)
        wall = _run_ranks(_composed_worker, (
            COMPOSED_PROCS, os.path.join(tmp, "store"), out_dir,
            composed_dir, tokenizer, device), COMPOSED_PROCS, out_dir,
            "composed")
        runs = []
        for r in range(COMPOSED_PROCS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                runs.append(json.load(f))
        perf = _composed_perf(tmp) if device == "cuda" else None
    n_layers = common.preset_model("base", "base")[0].encoder_layers
    out = {"procs": COMPOSED_PROCS, "wall_s": wall,
           "card": card() if device == "cuda" else None}
    for name, axes, ft_full in COMPOSED_GRIDS:
        one = refs["ft_full" if ft_full else "lora"]
        part = runs[0][name]
        sh = part["steps"]
        want = _composed_want(axes, ft_full, n_layers)
        rec = {"mesh": axes, "batch": COMPOSED_BATCH,
               "rows_per_rank": part["rows"],
               "ce_loss": {"one_rank": one["ce_loss"],
                           "composed": sh["ce_loss"]},
               "grad_norm": {"one_rank": one["grad_norm"],
                             "composed": sh["grad_norm"]},
               "loss_rtol": SHARD_LOSS_RTOL,
               "grad_norm_rtol": SHARD_GRAD_NORM_RTOL,
               "launches_per_rank_per_step": sh["launches"][-1],
               "predicted_launches": want,
               "one_rank_launches_per_step": one["launches"][-1],
               "step_ms_ranks_sharing_one_card": sh["ms"],
               "staged_hop_ms": sh["staged_ms"],
               "staged_hop_share": [a / b for a, b in zip(sh["staged_ms"],
                                                          sh["ms"])],
               "staged_hop_bytes": sh["staged_bytes"],
               "one_rank_step_ms": one["ms"],
               "peak_mem_gb_per_rank": [r[name]["steps"]["peak_mem_gb"]
                                        for r in runs],
               "one_rank_peak_mem_gb": one["peak_mem_gb"],
               "replicated_bits_equal": part["replicated_bits_equal"]}
        if ft_full:
            rec["restored_step"] = part["restored_step"]
            rec["checkpoints"] = part["checkpoints"]
        out[name] = rec
        emit({"phase": "composed", "part": name, **rec})
        for a, b in zip(sh["ce_loss"], one["ce_loss"]):
            check(_rel(a, b) <= SHARD_LOSS_RTOL,
                  f"composed {name}: ce_loss {a}, one-rank {b}")
        for a, b in zip(sh["grad_norm"], one["grad_norm"]):
            check(_rel(a, b) <= SHARD_GRAD_NORM_RTOL,
                  f"composed {name}: grad_norm {a}, one-rank {b}")
        check(len(sh["ce_loss"]) == COMPOSED_STEPS,
              f"composed {name}: {len(sh['ce_loss'])} steps")
        check(part["replicated_bits_equal"],
              f"composed {name}: replicated leaves differ across ranks")
        check(all(r[name]["steps"]["ce_loss"] == sh["ce_loss"]
                  for r in runs), f"composed {name}: the ranks' losses "
              "differ")
        for r in runs:
            got = r[name]["steps"]["launches"]
            check(all(g == want for g in got),
                  f"composed {name}: rank {r['rank']} launches {got}, "
                  f"expected {want} a step")
        if ft_full:
            check(part["restored_step"] == 1,
                  f"composed {name}: resumed from {part['restored_step']}")
            check(sorted(part["checkpoints"]) == ["1", "2"] and all(
                c["whole"] for c in part["checkpoints"].values()),
                f"composed {name}: checkpoints {part['checkpoints']}")
    sv, ref = runs[0]["serving"], refs["serving"]
    flat = [a == b for ra, rb in zip(sv["tokens"], ref["tokens"])
            for a, b in zip(ra[4:], rb[4:])]
    serving = {"mesh": {"pipe": 2, "seq": 2},
               "ms_ranks_sharing_one_card": sv["ms"],
               "one_rank_ms": ref["ms"],
               "launches_per_rank": sv["launches"],
               "one_rank_launches": ref["launches"],
               "equal_token_share": sum(flat) / len(flat),
               "ranks_agree": all(r["serving"]["ranks_agree"]
                                  for r in runs)}
    out["serving"] = serving
    emit({"phase": "composed", "part": "serving", **serving})
    check(serving["ranks_agree"], "composed serving: the ranks' tokens "
          "differ")
    check(len(sv["tokens"]) == SHARD_CLIPS, f"composed serving: "
          f"{len(sv['tokens'])} rows, expected {SHARD_CLIPS}")
    for k in ("K4", "K6", "K7"):
        check(sv["launches"].get(k, 0) > 0,
              f"composed serving: no {k} launch")
    check(not any(r["jax_imported"] for r in runs),
          "a composed rank imported jax or the JAX package")
    if perf is not None:
        out["perf"] = perf
        for name, r in perf.items():
            emit({"phase": "composed", "part": name, **r})
    emit({"phase": "composed", "wall_s": wall, "card": out["card"]})
    return out


def _family_kernels() -> list:
    """K1/K2, K3, K6 and K7 against their plain versions at the family's
    shapes (FAMILY_* and GATE_* cases), with the kernels phase's bounds,
    timed by CUDA events. (The kernels phase adds profiler device times;
    here the profiler is left out: late in the run, after the spawned
    phases, it has handed back eight empty windows in a row.)"""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = _check_flash(gen, FAMILY_KERNEL_CASES, profiled=False)
    out.extend(_check_lora_bwd(gen, FAMILY_LORA_CASES, profiled=False))
    out.extend(_check_decode_cross(gen, FAMILY_DECODE_CROSS_CASES,
                                   FAMILY_HEADS, profiled=False))
    out.extend(_check_decode_step(gen, FAMILY_DECODE_STEP_CASES,
                                  FAMILY_HEADS, profiled=False))
    out.extend(_check_decode_cross(gen, GATE_DECODE_CROSS_CASES, GATE_HEADS,
                                   GATE_HEAD_DIM, profiled=False))
    out.extend(_check_decode_step(gen, GATE_DECODE_STEP_CASES, GATE_HEADS,
                                  GATE_HEAD_DIM, profiled=False))
    return out


def _family_train(row: str, device: str = "cuda") -> dict:
    """A training row of perf/model_panel.py on the card: the 'fc' LoRA
    step (r=32, the stem, f32 masters computing in bf16) of whisper-small
    at batch 32 (remat as the CLI's --remat=auto picks it) or of large-v3
    at batch 8 (remat on), FAMILY_STEPS steps on one batch with K1, K2 and
    K3 counted per step against the attention blocks and fc adapters
    (finite losses that fall once the schedule's warm-up is past), then
    the panel's timing on the same state (`model_panel.train_row`)."""
    from neuspeech1_tpu_torch import bench
    from neuspeech1_tpu_torch.config import StemConfig
    from neuspeech1_tpu_torch.perf import model_panel as mp

    p = mp.PANELS["family"]
    stem = StemConfig("base", in_channels=p["channels"])
    if row == "small_train":
        bs, k, name = p["small_batch"], p["small_k"], "small_train"
        config = p["small"](remat=mp.small_remat(p["small"](), stem, bs,
                                                 device))
    else:
        bs, k, name = p["large_batches"][0], p["large_k"], "large_v3_train"
        config = p["large"](remat=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = bench.train_setup(config, stem, bs, device,
                              warmup_steps=FAMILY_WARMUP)
    setup_s = time.perf_counter() - t0
    step, state, frozen, batch = setup
    blocks = config.encoder_layers + config.decoder_layers
    expect = {"K1": blocks, "K2": blocks, "K3": 2 * config.encoder_layers,
              "K4": 0, "K4_bwd": 0, "K6": 0, "K7": 0, "K8": 0}
    losses = []
    for _ in range(FAMILY_STEPS):
        _reset_counts()
        m = step(state, frozen, batch)
        losses.append(float(m["loss"]))
        counts = _kernel_counts()
        check(counts == expect, f"{row}: launches {counts} in a step, "
              f"expected {expect}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{row}: losses {losses} not finite and falling")
    timed = mp.train_row(name, config, stem, bs, k, device, setup=setup)
    check(all(math.isfinite(x) for x in timed["losses"]),
          f"{row}: non-finite loss in the timed steps")
    out = {"phase": "family", "part": row, "batch": bs,
           "layers": [config.encoder_layers, config.decoder_layers],
           "d_model": config.d_model, "heads": config.encoder_heads,
           "remat": config.remat, "stem": f"base/{stem.in_channels}",
           "launches_per_step": counts, "losses": losses,
           "timed_losses": timed["losses"],
           "panel_row": {key: timed[key] for key in (
               "config", "batch", "remat", "step_ms", "samples_per_sec",
               "mfu", "fwd_gflops_per_sample")},
           "setup_s": setup_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(out)
    del setup, step, state, frozen, batch
    gc.collect()
    _empty_cache(device)
    return out


def _family_decode(inputs, batch: int, int8: bool,
                   device: str = "cuda") -> dict:
    """perf/model_panel.py's large-v3 decode row on the card: the 'speech'
    stem over 128 mel bins, greedy, FAMILY_NEW_TOKENS new tokens on the
    first ``batch`` rows of ``inputs`` (`model_panel.decode_inputs`; the
    int8 cross cache with ``int8``): K1, K6 (bf16 cache only) and K7
    counted against the model calls, tokens against the same decode on the
    plain versions (equal, or parting at a near-tie of the cached
    decoder's logits: `_bf16_ties`), then the panel's timing."""
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      greedy_decode)
    from neuspeech1_tpu_torch.models import whisper as tw
    from neuspeech1_tpu_torch.perf import model_panel as mp

    model, feats, prompt = inputs
    feats, prompt = feats[:batch], prompt[:batch]
    config = model.config
    name = "large_v3_decode" + ("_int8kv" if int8 else "")
    p = prompt.shape[1]
    gen = GenerationConfig.for_model(config, max_length=p + FAMILY_NEW_TOKENS,
                                     int8_kv_cache=int8)
    with torch.no_grad():
        greedy_decode(model, feats, prompt, gen)
        torch.cuda.synchronize()
        _reset_counts()
        with count_model_calls() as calls:
            tokens = greedy_decode(model, feats, prompt, gen)
            torch.cuda.synchronize()
        launches = _kernel_counts()
        _check_serving_launches(name, config, calls, launches,
                                ("K1", "K7") if int8 else ("K1", "K6", "K7"))
        with _plain_kernels():
            tokens_p = greedy_decode(model, feats, prompt, gen)
        ties = _bf16_ties(model, tw.encoder_apply(model, feats), tokens,
                          tokens_p, p, gen, None, name)
    check(tuple(tokens.shape) == (batch, p + FAMILY_NEW_TOKENS)
          and bool(((tokens >= 0) & (tokens < config.vocab_size)).all()),
          f"{name}: tokens {tuple(tokens.shape)} or ids outside the "
          "vocabulary")
    row = mp.decode_row(model, feats, prompt, int8)
    out = {"phase": "family", "part": name, "batch": batch,
           "new_tokens": FAMILY_NEW_TOKENS, "launches": launches,
           "model_calls": calls,
           "token_agreement_vs_plain": _agreement(tokens, tokens_p, p),
           "plain_tokens_logits_rel_err": ties["logits_rel_err"],
           "rows_parting_from_plain": ties["rows_parting"],
           "panel_row": row}
    emit(out)
    return out


def _family_stems(tmp: str, device: str = "cuda") -> dict:
    """A greedy request of FAMILY_STEM_CLIPS clips through each stem kind
    at whisper-base width, weights from seeds: the EEG stems through
    ``serve.Transcriber`` on 2-10 s synthetic signals, the 'speech' stem
    through ``greedy_decode`` on [80, 3000] features; K1, K6 and K7
    counted against the model calls."""
    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.config import StemConfig
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      greedy_decode)
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.serve import Transcriber

    config, _ = common.preset_model("base")
    vocab = os.path.join(tmp, "stems_vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(f"w{i}" for i in range(config.eot_id)) + "\n")
    t = config.max_source_positions
    out = {}
    for kind, ch in FAMILY_STEMS:
        stem = StemConfig(kind) if ch is None else StemConfig(kind,
                                                              in_channels=ch)
        tag = kind if ch is None else f"{kind}_{ch}"
        params = init_params(config, stem, seed=0)
        if kind == "speech":
            model = module_from_params(params, config, stem, device=device)
            feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (FAMILY_STEM_CLIPS, config.num_mel_bins, 2 * t)).astype(
                np.float32)).to(device, model.dtype)
            prompt = torch.tensor(
                [[config.sot_id, config.first_language_id,
                  config.transcribe_id, config.notimestamps_id]]
                * FAMILY_STEM_CLIPS, device=device)
            gen = GenerationConfig.for_model(
                config, max_length=prompt.shape[1] + FAMILY_STEM_TOKENS)

            def run(model=model, feats=feats, prompt=prompt, gen=gen):
                with torch.no_grad():
                    return greedy_decode(model, feats, prompt, gen).tolist()
        else:
            model_dir = common.save_full_model(
                os.path.join(tmp, f"stem_{tag}"), params, config, stem)
            tr = Transcriber(model_dir, tokenizer=f"word:{vocab}",
                             batch_size=FAMILY_STEM_CLIPS,
                             max_new_tokens=FAMILY_STEM_TOKENS,
                             device=device)
            signals = _signals(ch, 4 * t)[:FAMILY_STEM_CLIPS]

            def run(tr=tr, signals=signals):
                return tr.transcribe(signals)
        run()  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        with count_model_calls() as calls:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _kernel_counts()
        _check_serving_launches(f"stem {tag}", config, calls, launches)
        check(len(res) == FAMILY_STEM_CLIPS,
              f"stem {tag}: {len(res)} outputs for {FAMILY_STEM_CLIPS} clips")
        out[tag] = {"launches": launches, "model_calls": calls,
                    "latency_s": wall, "sample": str(res[0])[:60]}
        emit({"phase": "family", "part": "stem", "stem": tag, **out[tag]})
    gc.collect()
    _empty_cache(device)
    return out


def _quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output kept: (result, text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue()


def _family_transfer(tmp: str, device: str = "cuda") -> dict:
    """perf/flagship_drive.py's phase S (the Schoffelen transfer) at
    whisper-base width, a few steps each on FAMILY_TRANSFER_CLIPS-clip
    corpora: the base, the 208-channel adapter, the recipe's fine-tune
    flags on 301 channels cut to the schoffelen slice (the adapter merged,
    the stem re-initialized for 273 channels), merge_lora, and the eval
    CLI at beam 5, rp 5.0, ngram 2 writing its result files; K1, K2, K3,
    K6 and K7 all launched."""
    from neuspeech1_tpu_torch.perf import flagship_drive as fd

    root = os.path.join(tmp, "transfer")
    lines = []
    _reset_counts()
    t0 = time.perf_counter()
    _, text = _quiet(fd.main, [
        "S", "--root", root, "--clips", str(FAMILY_TRANSFER_CLIPS),
        "--device", device, *FAMILY_TRANSFER_FLAGS], emit=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    recs = [json.loads(x) for x in lines]
    ev = next(r for r in recs if r["phase"] == "S_eval")
    last = recs[-1]
    shapes = {run: list(np.load(os.path.join(
        root, run, "adapter_final.npz"))["model/encoder/stem/conv_a/w"].shape)
        for run in ("runS208", "runS273")}
    check("stem re-initialized: 208 -> 273 channels" in text,
          "transfer: the stem was not re-initialized")
    check(shapes == {"runS208": [512, 208, 3], "runS273": [512, 273, 3]},
          f"transfer: stem shapes {shapes}")
    check(ev["result_files"] == ["test_beam5.json", "test_beam5.jsonl",
                                 "test_beam5.txt"],
          f"transfer: eval files {ev['result_files']}")
    check(all(math.isfinite(v) for v in ev["metrics"].values())
          and all(math.isfinite(x) for _, x in last["eval_loss_trajectory"]),
          f"transfer: non-finite metrics {ev['metrics']}")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K6", "K7")),
          f"transfer: a kernel of the path never ran: {launches}")
    out = {"phase": "family", "part": "transfer", "launches": launches,
           "wall_s": wall, "stem_shapes": shapes, "eval": ev,
           "summaries": [r for r in recs if r["phase"] != "S_eval"]}
    emit(out)
    gc.collect()
    _empty_cache(device)
    return out


def _family_gate(tmp: str, device: str = "cuda") -> dict:
    """The CPU-scale convergence gate of tests/test_convergence.py on the
    card: its corpus, argv and 400 steps through the port's fine-tune CLI
    (bf16, the card's compute type: the kernels take bf16; d_model 48 over
    2 heads of 24, which K1, K2 and K6 pad to 32), held-out WER at step 400
    at most CONVERGENCE_WER."""
    from neuspeech1_tpu_torch.cli.finetune import main as finetune
    from neuspeech1_tpu_torch.data.synthetic import make_separable_corpus
    from neuspeech1_tpu_torch.perf.flagship_drive import (CONVERGENCE_WER,
                                                          convergence_argv)

    corpus, out_dir = os.path.join(tmp, "gate"), os.path.join(tmp, "gate_run")
    make_separable_corpus(corpus, n_clips=300, n_channels=8, seed=3)
    _reset_counts()
    t0 = time.perf_counter()
    _quiet(finetune, convergence_argv(corpus, out_dir)
           + [f"--device={device}", "--bf16=True"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    wers = [(r["step"], r["eval_wer"]) for r in recs if "eval_wer" in r]
    out = {"phase": "family", "part": "convergence_gate", "steps": 400,
           "heldout_wer": wers, "wer_bound": CONVERGENCE_WER,
           "losses": [(r["step"], r["loss"]) for r in recs if "loss" in r],
           "launches": launches, "wall_s": wall}
    emit(out)
    check(wers and wers[-1][0] == 400 and wers[-1][1] <= CONVERGENCE_WER,
          f"convergence gate: held-out WER {wers} past {CONVERGENCE_WER}")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K6", "K7")),
          f"convergence gate: a kernel of the path never ran: {launches}")
    return out


def _family_phase_a(tmp: str, device: str = "cuda") -> dict:
    """perf/flagship_drive.py's phase A on the card: whisper-base --ft_full
    from seeded weights, 600 steps at batch 32 on the 240-clip separable
    corpus; the eval loss at 600 below that at 300 and the held-out WER at
    600 at most PHASE_A_WER."""
    from neuspeech1_tpu_torch.perf import flagship_drive as fd

    lines = []
    _reset_counts()
    t0 = time.perf_counter()
    res, _ = _quiet(fd.main, ["A", "--root", os.path.join(tmp, "flagship"),
                              "--device", device], emit=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_counts()
    a = res["A"]
    evl, wer = dict(a["eval_loss_trajectory"]), dict(a["heldout_wer_trajectory"])
    out = {"phase": "family", "part": "flagship_A", **a,
           "launches": launches, "wall_s": wall, "wer_bound": PHASE_A_WER}
    emit(out)
    check(300 in evl and 600 in evl and evl[600] < evl[300],
          f"phase A: eval loss {evl} does not fall from 300 to 600")
    check(600 in wer and wer[600] <= PHASE_A_WER,
          f"phase A: held-out WER {wer} past {PHASE_A_WER} at 600")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K6", "K7")),
          f"phase A: a kernel of the path never ran: {launches}")
    return out


def phase_family(device: str = "cuda") -> dict:
    """The Whisper family past whisper-base, every stem kind, the
    Schoffelen transfer and the convergence drives (see the module's
    docstring, phase 18)."""
    from neuspeech1_tpu_torch.perf import model_panel as mp

    p = mp.PANELS["family"]
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args, device=device) if name != "kernels" else fn()
        seconds[name] = time.perf_counter() - t0
        return res

    out = {"kernels": part("kernels", _family_kernels)}
    for row in ("small_train", "large_train"):
        out[row] = part(row, _family_train, row)
    # one large-v3 model for both decode rows, inputs at the larger batch
    large = part("large_decode_setup", mp.decode_inputs, p["large"](),
                 p["int8_batch"])
    out["large_decode"] = part("large_decode", _family_decode, large,
                               p["decode_batch"], False)
    out["large_decode_int8_bs32"] = part(
        "large_decode_int8_bs32", _family_decode, large, p["int8_batch"],
        True)
    del large
    gc.collect()
    _empty_cache(device)
    with tempfile.TemporaryDirectory() as tmp:
        out["stems"] = part("stems", _family_stems, tmp)
        out["transfer"] = part("transfer", _family_transfer, tmp)
        out["gate"] = part("gate", _family_gate, tmp)
        out["phase_a"] = part("phase_a", _family_phase_a, tmp)
    check(_jax_free(), "jax or the JAX package was imported")
    emit({"phase": "family", "part": "seconds", **seconds, "card": card()})
    return out


def _family_entry(fm: dict, kernel: str) -> dict:
    """A kernel's launches in the family phase's runs (per step of the
    training rows, per decode and stem request, over the transfer, the
    convergence gate and flagship phase A) and its cases at the family's
    shapes, for the summary's kernel line."""
    out = {}
    for part in ("small_train", "large_train"):
        if fm[part]["launches_per_step"][kernel]:
            out[f"{part}_per_step"] = fm[part]["launches_per_step"][kernel]
    for part in ("large_decode", "large_decode_int8_bs32"):
        if fm[part]["launches"][kernel]:
            out[f"{part}_per_request"] = fm[part]["launches"][kernel]
    for tag, r in fm["stems"].items():
        if r["launches"][kernel]:
            out[f"stem_{tag}_per_request"] = r["launches"][kernel]
    for part in ("transfer", "gate", "phase_a"):
        if fm[part]["launches"][kernel]:
            out[part] = fm[part]["launches"][kernel]
    shapes = [{"case": r["case"],
               "max_abs_err": r.get("max_abs_err", r.get("o_max_abs_err")),
               **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}
              for r in fm["kernels"] if r["kernel"] == kernel]
    return {"family_launches": out, "family_shapes": shapes}


def summary(kernels, sl, bm, sp, tr, rg, pr, ev, ft, md, sph, pl,
            sh, cp, fm) -> dict:
    """One entry per kernel: launches on its path (training for K1, K2, K3;
    the sequence-parallel training step for K4; beam serving for K6, K7;
    speculative serving with the self-prefix drafter for K8; the perf
    probes' full-shape sweep for the probe kernels; greedy serving, and for
    K1, K6 and K7 the eval CLI's run (``eval_launches``), and for K1, K2,
    K3, K6 and K7 the finetune CLI's first run (``finetune_launches``, its
    eval-WER decode's K6 and K7 included) beside them, and for K1, K6 and
    K7 the launches per request of each mode of the modes phase
    (``modes_launches_per_request``), and the speech phase's eval CLI run
    (K1, K6, K7: ``speech_eval_launches``) and fine-tune CLI run (K1, K2,
    K3, K6, K7: ``speech_finetune_launches``), and the parallel phase's
    runs (K1, K2, K3, K4: ``parallel_launches``), and the sharded phase's
    (K1, K2, K3, K6, K7: ``sharded_launches``, per rank, with the times of
    its case at the sharded shape as ``sharded_shape``), and the composed
    phase's (K1, K2, K3, K4, K6, K7: ``composed_launches``, per rank and
    step of each grid and per rank of the greedy request, with the times of
    its case at a composed shape as ``composed_shape``), and the family
    phase's (K1, K2, K3, K6, K7: ``family_launches``, per step of the
    small and large-v3 training rows, per large-v3 decode request, per
    stem request, and over the transfer, the convergence gate and flagship
    phase A, with the times of its cases at the family's shapes as
    ``family_shapes``)), the error and the
    times of its case
    at that path's shape, its
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
    moe = [r for r in kernels if r["kernel"] == "moe_grouped_gemm"]
    moe_layer = next(r for r in moe if r["case"] == "routed_layer_step")
    k4, k4_bwd = first("K4", "sp_step_n1"), first("K4_bwd", "sp_step_n1")
    sp_launches = rg["sp_step"]["launches_per_step"]
    ring_launches = [r["launches"] for r in rg["local_ring"]]
    spec_launches = {n: r["launches"]["K8"]
                     for n, r in sp["requests"].items()}
    launches = tr["launches_per_step"]
    src = "neuspeech1_tpu_torch/csrc/"

    def modes(kernel):
        per = {name: md[name]["launches_per_request"].get(kernel, 0)
               for name in ("sample", "beam_sample", "contrastive",
                            "int8_weights")}
        per["timestamps_4_clips"] = md["timestamps"]["launches"][kernel]
        per.update({f"eval {r['tag']} {flags}": r["launches"][kernel]
                    for flags, r in md["eval"].items()})
        return per

    def speech(kernel):
        """The kernel's launches in the speech phase's two CLI runs."""
        out = {}
        if kernel in ("K1", "K6", "K7"):
            out["speech_eval_launches"] = sph["eval"]["launches"][kernel]
        out["speech_finetune_launches"] = sph["finetune"]["launches"][kernel]
        return out

    def parallel(kernel):
        """The kernel's launches in the parallel phase: per rank and step
        of the data-parallel step, in each GPipe stack (both stages), and
        per step of the SP step without and with remat."""
        out = {}
        if kernel in ("K1", "K2", "K3"):
            out["dp_per_rank_per_step"] = \
                pl["dp_step"]["launches_per_rank_per_step"][kernel]
            out.update({f"gpipe_{g['stack']}": g["launches"][kernel]
                        for g in pl["gpipe"]})
        if kernel in ("K4", "K4_bwd"):
            out["remat_sp_per_step"] = {name: r[kernel] for name, r in
                                        pl["remat_sp"].items()}
        return {"parallel_launches": out}

    def sharded(kernel, case):
        """The kernel's launches per rank in the sharded phase's runs, and
        its kernels-phase case at the sharded shape."""
        out = {}
        for part in ("tp_step", "fsdp_tp_step"):
            n = sh[part]["launches_per_rank_per_step"].get(kernel, 0)
            if n:
                out[f"{part}_per_rank_per_step"] = n
        for name, r in sh["serving"].items():
            if r["launches_per_rank"].get(kernel):
                out[f"serving_{name}_per_rank"] = \
                    r["launches_per_rank"][kernel]
        if sh["cli"]["launches"].get(kernel):
            out["cli_per_rank"] = sh["cli"]["launches"][kernel]
        r = first(kernel, case)
        return {"sharded_launches": out,
                "sharded_shape": {"case": case, "max_abs_err": r.get(
                    "max_abs_err", r.get("o_max_abs_err")), **timing(r)}}

    def composed(kernel, case=None):
        """The kernel's launches per rank in the composed phase's grids (a
        step) and greedy request, and its kernels-phase case at a composed
        shape."""
        out = {f"{name}_per_rank_per_step":
               cp[name]["launches_per_rank_per_step"][kernel]
               for name, _, _ in COMPOSED_GRIDS
               if kernel in cp[name]["launches_per_rank_per_step"]}
        n = cp["serving"]["launches_per_rank"].get(kernel)
        if n:
            out["serving_pipe_seq_per_rank"] = n
        res = {"composed_launches": out}
        if case is not None:
            r = first(kernel, case)
            res["composed_shape"] = {
                "case": case, "max_abs_err": r.get(
                    "max_abs_err", r.get("o_max_abs_err")), **timing(r)}
        return res

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
                **timing(r), "host_us": r["host_us"],
                "variant_ms": {x["k"]: x["ms"] for x in rows},
                **({"f32_gold_share": {x["k"]: x["f32_gold_share"]
                                       for x in rows}}
                   if kernel == "probe_bwd" else {})}

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
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":570",
         "launches": launches["K1"], "serving_launches": sl["launches"]["K1"],
         "beam_launches": bm["launches"]["K1"],
         "eval_launches": ev["launches"]["K1"],
         "finetune_launches": ft["launches"]["K1"],
         "modes_launches_per_request": modes("K1"),
         **speech("K1"), **parallel("K1"),
         **sharded("K1", "tp_train_encoder"),
         **composed("K1", "pp_train_cross"), **_family_entry(fm, "K1"),
         "max_abs_err": k1["o_max_abs_err"], **timing(k1)},
        {"name": "flash_bwd_btc (K2)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":700",
         "launches": launches["K2"],
         "finetune_launches": ft["launches"]["K2"], **speech("K2"),
         **parallel("K2"), **sharded("K2", "tp_train_encoder"),
         **composed("K2", "pp_train_cross"), **_family_entry(fm, "K2"),
         "max_abs_err": k2["max_abs_err"], **timing(k2)},
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
         "replaces": "neuspeech1_tpu/ops/lora_bwd.py:133",
         "launches": launches["K3"],
         "finetune_launches": ft["launches"]["K3"], **speech("K3"),
         **parallel("K3"), **sharded("K3", "tp_fc1"),
         **composed("K3", "pp_sp_fc1"), **_family_entry(fm, "K3"),
         "max_abs_err": k3["max_abs_err"], **timing(k3), **device(k3)},
        {"name": "flash_fwd_btc_bias (K4 forward)", "route": "cuda",
         "source": src + "flash_fwd_btc.cu", "replaces": fa_py + ":755",
         "launches": sp_launches["K4"],
         "local_ring_launches": [r["K4"] for r in ring_launches],
         **parallel("K4"), **composed("K4", "pp_sp_block"),
         "max_abs_err": k4["o_max_abs_err"], **timing(k4)},
        {"name": "flash_bwd_btc_bias (K4 backward)", "route": "cuda",
         "source": src + "flash_bwd_btc.cu", "replaces": fa_py + ":800",
         "launches": sp_launches["K4_bwd"],
         "local_ring_launches": [r["K4_bwd"] for r in ring_launches],
         **parallel("K4_bwd"), **composed("K4_bwd", "pp_sp_block"),
         "max_abs_err": k4_bwd["max_abs_err"], **timing(k4_bwd)},
        {"name": "decode_cross (K6, [B,H,T,D] cache)", "route": "cuda",
         "source": src + "decode_cross.cu", "replaces": fa_py + ":901",
         "launches": bm["launches"]["K6"],
         "greedy_launches": sl["launches"]["K6"],
         "eval_launches": ev["launches"]["K6"],
         "finetune_launches": ft["launches"]["K6"],
         "modes_launches_per_request": modes("K6"), **speech("K6"),
         **sharded("K6", "tp_greedy"), **composed("K6"),
         **_family_entry(fm, "K6"),
         "max_abs_err": k6["max_abs_err"], **timing(k6),
         **device(k6)},
        # the [B, T, H*D] cache entry: no serving path holds that layout,
        # so its launches are those of its own run (counted from 0)
        {"name": "decode_cross_btc (K6, [B,T,H*D] cache)", "route": "cuda",
         "source": src + "decode_cross.cu", "replaces": fa_py + ":986",
         "launches": k6_btc["launches"], "path": "decode_cross_btc entry",
         "max_abs_err": k6_btc["max_abs_err"], **timing(k6_btc),
         **device(k6_btc)},
        {"name": "decode_step (K7)", "route": "cuda",
         "source": src + "decode_step.cu",
         "replaces": "neuspeech1_tpu/ops/decode_step.py:161",
         "launches": bm["launches"]["K7"],
         "greedy_launches": sl["launches"]["K7"],
         "eval_launches": ev["launches"]["K7"],
         "finetune_launches": ft["launches"]["K7"],
         "modes_launches_per_request": modes("K7"), **speech("K7"),
         **sharded("K7", "tp_greedy_last"), **composed("K7"),
         **_family_entry(fm, "K7"),
         "max_abs_err": k7["max_abs_err"], **timing(k7), **device(k7)},
        {"name": "decode_step_multi (K8)", "route": "cuda",
         "source": src + "decode_step_multi.cu",
         "replaces": "neuspeech1_tpu/ops/decode_step.py:244",
         "launches": spec_launches["spec_self"],
         "table_drafter_launches": spec_launches["spec_table"],
         "int8_launches": spec_launches["spec_int8"],
         "max_abs_err": k8["max_abs_err"], **timing(k8), **device(k8)},
        # no TPU kernel: the routed experts' products of the language
        # model's step (moe-llm-train-b32), timed at its four products
        {"name": "moe_grouped_gemm", "route": "cuda",
         "source": src + "moe_grouped_gemm.cu", "replaces": None,
         "path": "models/moe_lm.py GroupedExperts",
         "launches_per_routed_layer_step": moe_layer["launches"],
         "cases": {r["case"]: {"max_abs_err": r["max_abs_err"],
                               "device_ms": r["device_ms"], **timing(r)}
                   for r in moe if r is not moe_layer}},
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
    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall seconds recorded under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        model = serving_model(tmp)
        sl = timed("slice", phase_slice, model)
        bm = timed("beam", phase_beam, model)
        sp = timed("spec", phase_spec, model)
        timed("lora", phase_lora, model)
        ev = timed("eval", phase_eval, model, bm)
        md = timed("modes", phase_modes, model)
    tr = timed("train", phase_train)
    timed("options", phase_options, tr)
    ft = timed("finetune", phase_finetune, tr, bm)
    sph = timed("speech", phase_speech)
    rg = timed("ring", phase_ring, tr)
    pr = timed("probes", phase_probes)
    timed("bench", phase_bench)
    pl = timed("parallel", phase_parallel)
    sh = timed("sharded", phase_sharded)
    cp = timed("composed", phase_composed)
    fm = timed("family", phase_family)
    emit({"phase_seconds": seconds})
    emit(summary(kernels, sl, bm, sp, tr, rg, pr, ev, ft, md, sph, pl, sh,
                 cp, fm))
    print(card(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
