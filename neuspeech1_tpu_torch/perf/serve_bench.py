"""Serving throughput of the port: the counterpart of the JAX package's root
``perf/serve_bench.py``.

    python -m neuspeech1_tpu_torch.perf.serve_bench [--batch 32]
        [--new_tokens 32] [--repeats 4]

Greedy decoding and beam search at the reference eval's settings (beam 5,
repetition penalty 5.0, no-repeat-ngram 2), each with the bf16 and the
int8 cross cache, on a whisper-base EEG model ('base' stem over 208
channels x 6000 samples) with random weights from a seed (the same compute
as a trained one; random weights never emit eot, so every call runs its
whole budget). One JSON line per configuration with the JAX script's keys:
``config``, ``batch``, ``new_tokens``, ``ms_per_batch`` (the median of
``repeats`` calls after one warm-up, host clock, each call ending in the
tokens' copy to the host) and ``utterances_per_sec``. The JAX script's
larger-batch lines are these configurations at ``--batch 64`` and
``--batch 128``. Its ``_pipelined`` lines keep two batches in flight; the
port's decode loops wait on the card at every step, so there is nothing
to overlap and they have no counterpart.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig

BATCH = 32
NEW_TOKENS = 32
REPEATS = 4
BEAM = dict(num_beams=5, repetition_penalty=5.0, no_repeat_ngram_size=2)


def model_and_inputs(config: WhisperConfig, stem: StemConfig, batch: int,
                     device):
    """(serving model in the compute dtype, features in it ([batch, ch,
    4 T] signals, or [batch, mels, 2 T] for the speech stem), the
    transcribe prompt [batch, 4]) from seeds."""
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_params

    model = module_from_params(init_params(config, stem, seed=0), config,
                               stem, device=device)
    rng = np.random.default_rng(0)
    shape = ((batch, config.num_mel_bins, 2 * config.max_source_positions)
             if stem.kind == "speech" else
             (batch, stem.in_channels, 4 * config.max_source_positions))
    feats = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, model.dtype)
    prompt = torch.tensor([[config.sot_id, config.first_language_id,
                            config.transcribe_id, config.notimestamps_id]]
                          * batch, device=device)
    return model, feats, prompt


def timed(fn: Callable, feats, repeats: int) -> List[float]:
    """Seconds of ``repeats`` calls ``fn(feats)`` after one warm-up, each
    ending in its tokens' copy to the host."""
    def tokens(out):
        return (out[0] if isinstance(out, tuple) else out).cpu()

    tokens(fn(feats))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        tokens(fn(feats))
        times.append(time.perf_counter() - t0)
    return times


def line(tag: str, batch: int, new_tokens: int, times: List[float],
         **extra) -> dict:
    dt = statistics.median(times)
    return {"config": tag, "batch": batch, "new_tokens": new_tokens,
            "ms_per_batch": dt * 1e3, "utterances_per_sec": batch / dt,
            **extra}


def run(config: WhisperConfig, stem: StemConfig, batch: int = BATCH,
        new_tokens: int = NEW_TOKENS, repeats: int = REPEATS,
        device="cuda", emit=print) -> List[dict]:
    """The lines, each passed to ``emit`` as a JSON string when made."""
    from neuspeech1_tpu_torch.decode.generate import (
        GenerationConfig, beam_search, greedy_decode)

    out = []
    model, feats, prompt = model_and_inputs(config, stem, batch, device)

    def report(tag, decode, int8, **gen_kw):
        gen = GenerationConfig.for_model(
            config, max_length=prompt.shape[1] + new_tokens,
            int8_kv_cache=int8, **gen_kw)
        with torch.no_grad():
            times = timed(lambda f: decode(model, f, prompt, gen), feats,
                          repeats)
        rec = line(tag, batch, new_tokens, times)
        out.append(rec)
        emit(json.dumps(rec))

    for int8 in (False, True):
        report(f"greedy{'_int8kv' if int8 else ''}", greedy_decode, int8)
    for int8 in (False, True):
        report(f"beam5_rp5_ngram2{'_int8kv' if int8 else ''}", beam_search,
               int8, **BEAM)
    return out


def model_config(name: str):
    """(config, stem): ``name`` a Whisper size of ``config.py``'s presets
    with the 'base' stem over 208 channels, or 'test', the CPU tests' tiny
    config over 8."""
    from neuspeech1_tpu_torch.config import preset_config, tiny_config

    if name == "test":
        return tiny_config(), StemConfig("base", in_channels=8)
    return preset_config(name), StemConfig("base", in_channels=208)


def arguments(description: str):
    """The arguments every serving script takes."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--model", default="base",
                    help="a Whisper size, or 'test' for the tiny config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = arguments(__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--new_tokens", type=int, default=NEW_TOKENS)
    args = ap.parse_args(argv)
    config, stem = model_config(args.model)
    run(config, stem, args.batch, args.new_tokens, args.repeats,
        torch.device(args.device), emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
