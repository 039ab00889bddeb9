"""Benchmark of the PyTorch port on one NVIDIA GPU: the counterpart of the
JAX package's root ``bench.py``.

    python -m neuspeech1_tpu_torch.bench

Times the flagship configuration: whisper-base with the 'base' EEG stem
over 208 channels x 6000 samples (30 s at 200 Hz), batch 64, 64 labels,
bf16 features and compute over f32 masters, LoRA r=32 alpha=64 on encoder
q/k/v/out/fc1/fc2, the 'fc' fold, clip + AdamW with warmup 500, weights
and data from seeds. Prints ONE JSON line with the JAX bench's keys:

- training: K = 20 chained steps with one ``float(loss)`` at the end, the
  median of 3 such runs: ``train_step_ms``, ``value`` (samples/s), and
  ``mfu`` against the H100 SXM's dense bf16 peak (989 TFLOP/s; None off
  the card) from `fwd_flops_per_sample` (3x forward for a step);
- greedy decode with the trained, unmerged adapters (``lora=``) at the
  training batch: the slope between 8 and 48 new tokens isolates the
  per-token cost from the encoder, with the int8 cross cache
  (``decode_tokens_per_sec``) and the bf16 one
  (``decode_fp_tokens_per_sec``); ``decode_e2e_tokens_per_sec`` includes
  the encoder at 48 tokens.

``vs_baseline`` is the ratio to BASELINE.md's analytic A100 estimate (550
samples/s), not a measurement. The step runs at the config's ``remat``
(off in the presets, as in the JAX bench), which ``remat`` reports. There is no fallback: a failing step
or decode fails the run. `run` takes the config, batch size, K and device,
so a test can run it on the CPU at a tiny size.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig

A100_EST_SAMPLES_PER_SEC = 550.0  # BASELINE.md's analytic estimate
H100_PEAK_BF16_FLOPS = 989e12     # H100 SXM data sheet, dense
LABEL_LEN = 64
DECODE_POINTS = (8, 48)           # new tokens of the two-point slope
REPEATS = 3


def fwd_flops_per_sample(c: WhisperConfig, label_len: int,
                         in_channels: int) -> float:
    """Analytic forward FLOPs per sample (matmuls and convs, 2 per MAC):
    the 'base' stem, the encoder layers (q/k/v/out, QK^T and PV, MLP), the
    decoder layers (self-attention, cross K/V over the encoder frames,
    cross q/out and attention, MLP) and the tied logits; LoRA deltas
    (about 1%) ignored. The JAX package's root bench.py's count."""
    t = c.max_source_positions
    t_in = t * 4
    d, f_enc, f_dec = c.d_model, c.encoder_ffn, c.decoder_ffn
    n = label_len
    stem = (t_in * in_channels * d * 3 * 2 + (t_in // 2) * d * d * 3 * 2
            + t * d * d * 3 * 2)
    enc_layer = 4 * t * d * d * 2 + 2 * t * t * d * 2 + 2 * t * d * f_enc * 2
    dec_layer = (4 * n * d * d * 2 + 2 * n * n * d * 2 + 2 * t * d * d * 2
                 + 2 * n * d * d * 2 + 2 * n * t * d * 2
                 + 2 * n * d * f_dec * 2)
    logits = n * d * c.vocab_size * 2
    return float(stem + c.encoder_layers * enc_layer
                 + c.decoder_layers * dec_layer + logits)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_setup(config: WhisperConfig, stem: StemConfig,
                batch_size: int = 64, device: str = "cuda",
                warmup_steps: int = 500):
    """(step, state, frozen, batch): the timed configuration's training
    step, its state and one batch from seeds, on ``device``; the learning
    rate warms up to 1e-3 over ``warmup_steps``."""
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    dev = torch.device(device)
    model = module_from_params(init_params(config, stem, seed=0, device=dev),
                               config, stem, device=dev, dtype=torch.float32)
    lora = init_lora(config, rank=32, alpha=64, seed=1, device=dev)
    tx = optimizer.make_optimizer(peak_lr=1e-3, warmup_steps=warmup_steps,
                                  total_steps=100_000)
    state, frozen = trainstep.init_train_state(model, lora, tx)
    step = trainstep.make_train_step(config, stem, tx, fold_lora=True)

    rng = np.random.default_rng(0)
    n_samples = 4 * config.max_source_positions
    high = min(50000, config.vocab_size)
    feats = torch.from_numpy(rng.standard_normal(
        (batch_size, stem.in_channels, n_samples)).astype(np.float32)).to(
        dev, torch.bfloat16)
    batch = {"input_features": feats}
    for key in ("labels", "decoder_input_ids"):
        batch[key] = torch.from_numpy(
            rng.integers(0, high, (batch_size, LABEL_LEN))).to(dev)
    return step, state, frozen, batch


def run(config: WhisperConfig, stem: StemConfig, batch_size: int = 64,
        steps: int = 20, device: str = "cuda") -> dict:
    """Times ``steps`` chained training steps (median of 3 runs) and the
    greedy decode slope with the trained adapters; returns the JSON
    result."""
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      greedy_decode)

    dev = torch.device(device)
    step, state, frozen, batch = train_setup(config, stem, batch_size, dev)
    feats = batch["input_features"]

    for _ in range(2):  # allocator, library handles, the schedule's lr 0
        float(step(state, frozen, batch)["loss"])
    totals = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step(state, frozen, batch)
        float(metrics["loss"])  # one device -> host copy for the chain
        totals.append(time.perf_counter() - t0)
    dt = statistics.median(totals) / steps
    samples_per_sec = batch_size / dt
    flops = fwd_flops_per_sample(config, LABEL_LEN, stem.in_channels)
    on_card = dev.type == "cuda"

    prompt = torch.tensor(
        [[config.sot_id, config.first_language_id, config.transcribe_id,
          config.notimestamps_id]] * batch_size, device=dev)

    def timed_decode(max_new: int, int8: bool) -> float:
        gen = GenerationConfig.for_model(
            config, max_length=prompt.shape[1] + max_new, int8_kv_cache=int8)
        greedy_decode(frozen.model, feats, prompt, gen, frozen.lora).cpu()
        times, f = [], feats
        for _ in range(REPEATS):
            _sync(dev)
            t0 = time.perf_counter()
            out = greedy_decode(frozen.model, f, prompt, gen, frozen.lora)
            s = float(out[0, -1].cpu())
            times.append(time.perf_counter() - t0)
            f = feats * (1.0 + s * 1e-9)
        return statistics.median(times)

    lo, hi = DECODE_POINTS
    t_lo, t_hi = timed_decode(lo, True), timed_decode(hi, True)
    t_lo_fp, t_hi_fp = timed_decode(lo, False), timed_decode(hi, False)
    span = batch_size * (hi - lo)
    return {
        "metric": "train_samples_per_sec_per_chip",
        "value": samples_per_sec,
        "unit": "samples/s",
        "vs_baseline": samples_per_sec / A100_EST_SAMPLES_PER_SEC,
        "baseline": "BASELINE.md's analytic A100 estimate, not a measurement",
        "train_step_ms": dt * 1e3,
        "train_step_ms_runs": [1e3 * t / steps for t in totals],
        "mfu": (samples_per_sec * 3.0 * flops / H100_PEAK_BF16_FLOPS
                if on_card else None),
        "fwd_gflops_per_sample": flops / 1e9,
        "remat": config.remat,
        "decode_tokens_per_sec": span / (t_hi - t_lo),
        "decode_e2e_tokens_per_sec": batch_size * hi / t_hi,
        "decode_e2e_includes_encoder_prefill": True,
        "decode_fp_tokens_per_sec": span / (t_hi_fp - t_lo_fp),
        "batch_size": batch_size, "steps": steps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("neuspeech1_tpu_torch.bench times the card: CUDA is "
                         "not available")
    from neuspeech1_tpu_torch.cli import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, stem = common.preset_model("base", "base", in_channels=208)
    print(json.dumps(run(config, stem)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
