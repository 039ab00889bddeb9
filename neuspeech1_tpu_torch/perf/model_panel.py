"""The Whisper family beyond whisper-base on the card: the counterpart of
the JAX package's root ``perf/model_panel.py``.

    python -m neuspeech1_tpu_torch.perf.model_panel [ROW ...]
        [--device cuda] [--model family]

Rows (default: the first three, as in the JAX script):

- ``small_train``: whisper-small (12+12 layers, d_model 768, 12 heads,
  FFN 3072) with the 'base' EEG stem over 208 channels x 6000 samples,
  batch 32, 64 labels, LoRA r=32 alpha=64 on encoder q/k/v/out/fc1/fc2
  plus the stem, the 'fc' fold, bf16 compute on f32 masters, remat as
  ``train/memory.py::resolve_remat("auto", ...)`` picks it for the card's
  memory;
- ``large_train``: whisper-large-v3 (32+32, d_model 1280, 20 heads, FFN
  5120, vocabulary 51866) with the same stem and adapters, ``remat=True``,
  batch 8; batch 4 only after an out-of-memory error, which the row prints;
- ``large_decode``: large-v3 with the 'speech' stem over its 128 mel bins
  x 3000 frames, greedy at batch 8: the time of 8 and of 32 new tokens
  and the two-point slope between them;
- ``large_decode_int8_bs32``: the same at batch 32 with the int8 cross
  cache.

Weights, signals and labels come from seeds. A training row runs one step,
then 3 runs of K chained steps (K = 10 small, 5 large) each ending in one
``float(loss)``, and takes the middle run: ``step_ms``,
``samples_per_sec`` and ``mfu`` (3x `bench.fwd_flops_per_sample` per
sample against the H100 SXM's dense bf16 peak,
``bench.H100_PEAK_BF16_FLOPS``; None off the card). A decode row takes
the middle of 3 timed calls after one warm-up at each point. One JSON
line per row with the JAX script's keys and unrounded values.

``--model test`` runs the rows at the CPU tests' tiny config (smaller
batches and K) so that the script's control flow runs without a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from neuspeech1_tpu_torch import bench
from neuspeech1_tpu_torch.config import StemConfig, preset_config, tiny_config

LABEL_LEN = bench.LABEL_LEN     # 64, as the JAX rows
LORA_RANK = 32
DECODE_POINTS = (8, 32)         # new tokens of the two-point slope
REPEATS = 3
ROWS = ("small_train", "large_train", "large_decode")

# per model: config factories, stem channels, batches and chained steps
PANELS = {
    "family": dict(small=lambda **kw: preset_config("small", **kw),
                   large=lambda **kw: preset_config("large", **kw),
                   channels=208, small_batch=32, large_batches=(8, 4),
                   decode_batch=8, int8_batch=32, small_k=10, large_k=5),
    "test": dict(small=tiny_config, large=tiny_config, channels=8,
                 small_batch=2, large_batches=(2, 1), decode_batch=2,
                 int8_batch=4, small_k=2, large_k=2),
}


def _mfu(samples_per_sec: float, flops: float, device) -> Optional[float]:
    if torch.device(device).type != "cuda":
        return None
    return samples_per_sec * 3.0 * flops / bench.H100_PEAK_BF16_FLOPS


def chained_seconds(step, state, frozen, batch, k: int):
    """(seconds per step, losses): REPEATS runs of ``k`` chained steps,
    each ending in one ``float(loss)``, the middle run's time over ``k``;
    every step's loss, read after the last run (the chain makes no other
    host sync)."""
    losses, totals = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(k):
            m = step(state, frozen, batch)
            losses.append(m["loss"])
        float(m["loss"])
        totals.append(time.perf_counter() - t0)
    return sorted(totals)[len(totals) // 2] / k, [float(x) for x in losses]


def small_remat(config, stem, batch_size: int, device) -> bool:
    """The remat the fine-tune CLI's ``--remat=auto`` picks for the LoRA
    step at ``batch_size`` on ``device``'s memory."""
    from neuspeech1_tpu_torch.train import memory as trainmem

    return trainmem.resolve_remat(
        "auto", config, stem, batch_size,
        trainable_count=trainmem.trainable_count_estimate(
            config, stem, ft_full=False, lora_rank=LORA_RANK),
        label_len=LABEL_LEN, device=device)


def train_row(name: str, config, stem, batch_size: int, k: int, device,
              setup=None) -> dict:
    """A training row: one step, then `chained_seconds`. ``setup``: a
    `bench.train_setup` tuple to time (default: a new one from seeds)."""
    step, state, frozen, batch = setup or bench.train_setup(
        config, stem, batch_size, device)
    float(step(state, frozen, batch)["loss"])
    dt, losses = chained_seconds(step, state, frozen, batch, k)
    sps = batch_size / dt
    flops = bench.fwd_flops_per_sample(config, LABEL_LEN, stem.in_channels)
    return {"config": name, "batch": batch_size, "remat": config.remat,
            "step_ms": dt * 1e3, "samples_per_sec": sps,
            "mfu": _mfu(sps, flops, device),
            "fwd_gflops_per_sample": flops / 1e9, "losses": losses}


def small_train(device="cuda", model: str = "family") -> dict:
    p = PANELS[model]
    stem = StemConfig("base", in_channels=p["channels"])
    bs = p["small_batch"]
    remat = small_remat(p["small"](), stem, bs, device)
    row = train_row("small_train", p["small"](remat=remat), stem, bs,
                    p["small_k"], device)
    return {k: row[k] for k in ("config", "batch", "remat", "step_ms",
                                "samples_per_sec", "mfu")}


def large_train(device="cuda", model: str = "family",
                emit: Callable[[str], None] = print) -> dict:
    """The large-v3 row at the first batch that fits, each out-of-memory
    error printed as a row of its own first."""
    p = PANELS[model]
    stem = StemConfig("base", in_channels=p["channels"])
    config = p["large"](remat=True)
    for bs in p["large_batches"]:
        try:
            row = train_row("large_v3_train", config, stem, bs, p["large_k"],
                            device)
        except torch.OutOfMemoryError as e:
            emit(json.dumps({"config": "large_v3_train", "batch": bs,
                             "error": f"{type(e).__name__}: {str(e)[:200]}"}))
            gc.collect()
            torch.cuda.empty_cache()
            continue
        return {k: row[k] for k in ("config", "batch", "remat", "step_ms",
                                    "samples_per_sec", "mfu",
                                    "fwd_gflops_per_sample")}
    raise RuntimeError("large_v3_train: every batch ran out of memory")


def decode_inputs(config, batch_size: int, device):
    """(serving model, [B, mels, 2 T] features, transcribe prompt) of the
    'speech' stem from seeds."""
    from neuspeech1_tpu_torch.perf.serve_bench import model_and_inputs

    return model_and_inputs(config, StemConfig("speech"), batch_size,
                            torch.device(device))


def decode_seconds(model, feats, prompt, max_new: int, int8: bool
                   ) -> float:
    """The middle of REPEATS greedy calls of ``max_new`` new tokens
    after one warm-up, each ending in a token's copy to the host; the
    features move by that token between calls, as in the JAX script."""
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      greedy_decode)

    gen = GenerationConfig.for_model(
        model.config, max_length=prompt.shape[1] + max_new,
        int8_kv_cache=int8)
    with torch.no_grad():
        greedy_decode(model, feats, prompt, gen).cpu()
        times, f = [], feats
        for _ in range(REPEATS):
            bench._sync(feats.device)
            t0 = time.perf_counter()
            out = greedy_decode(model, f, prompt, gen)
            s = float(out[0, -1].cpu())
            times.append(time.perf_counter() - t0)
            f = feats * (1.0 + s * 1e-9)
    return statistics.median(times)


def decode_row(model, feats, prompt, int8: bool) -> dict:
    lo, hi = DECODE_POINTS
    res = {n: decode_seconds(model, feats, prompt, n, int8)
           for n in DECODE_POINTS}
    slope = (res[hi] - res[lo]) / (hi - lo) * 1e3
    return {"config": "large_v3_decode" + ("_int8kv" if int8 else ""),
            "batch": feats.shape[0], f"ms{lo}": res[lo] * 1e3,
            f"ms{hi}": res[hi] * 1e3, "ms_per_token": slope,
            "tok_per_sec": feats.shape[0] / (slope / 1e3)}


def large_decode(bs: Optional[int] = None, int8: bool = False,
                 device="cuda", model: str = "family") -> dict:
    p = PANELS[model]
    bs = bs or (p["int8_batch"] if int8 else p["decode_batch"])
    return decode_row(*decode_inputs(p["large"](), bs, device), int8)


def main(argv: Optional[List[str]] = None,
         emit: Callable[[str], None] = lambda s: print(s, flush=True)
         ) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", default=list(ROWS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="family", choices=sorted(PANELS))
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("model_panel: CUDA is not available; pass "
                             "--device cpu with --model test")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kw = dict(device=args.device, model=args.model)
    rows = {"small_train": lambda: small_train(**kw),
            "large_train": lambda: large_train(emit=emit, **kw),
            "large_decode": lambda: large_decode(**kw),
            "large_decode_int8_bs32": lambda: large_decode(int8=True, **kw)}
    for name in args.rows:
        emit(json.dumps(rows[name]()))
        gc.collect()
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
