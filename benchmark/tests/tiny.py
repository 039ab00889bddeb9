"""Tiny cells for the CPU tests: the real cells' configuration and
traffic files with every size cut, run on the CPU."""

from __future__ import annotations

import copy

from benchmark.lib import harness, spec

N_TEXT = 256


def config(dtype: str = "float32") -> dict:
    c = copy.deepcopy(spec.load_json(
        spec.BENCH_DIR / "configs" / "whisper-base-meg208.json"))
    n = N_TEXT
    c["model"].update(
        d_model=64, encoder_layers=2, decoder_layers=2, encoder_heads=2,
        decoder_heads=2, encoder_ffn=128, decoder_ffn=128,
        max_source_positions=100, max_target_positions=64, eot_id=n,
        sot_id=n + 1, first_language_id=n + 2, num_languages=2,
        translate_id=n + 4, transcribe_id=n + 5, startoflm_id=n + 6,
        startofprev_id=n + 7, nocaptions_id=n + 8, notimestamps_id=n + 9,
        vocab_size=n + 10 + 1501)
    c["stem"]["in_channels"] = 8
    c["signal_samples"] = 400
    c["adapters"]["init_r"] = 4
    # wide enough that the served tokens depend on the clip at this size
    c["init_std"] = 0.3
    c["dtype"] = dtype
    return c


def traffic(kind: str) -> dict:
    if kind == "train_step":
        t = spec.load_json(spec.BENCH_DIR / "traffic" / "train-b64-l128.json")
        t.update(batch=4, label_len=16, real_tokens=[8, 14], pool_clips=16,
                 clip_seconds=[0.5, 2.0], reference_rows=2,
                 trace_after_steps=1, trace_steps=2)
    else:
        t = spec.load_json(spec.BENCH_DIR / "traffic" / "beam5-b128-t48.json")
        t.update(batch=4, pool_clips=16, clip_seconds=[0.5, 2.0],
                 new_tokens=6, checked_requests=2,
                 checked_clips_per_request=4, reference_rows=2,
                 trace_after_requests=1, trace_requests=1)
    return t


def cell(kind: str, limits: dict, dtype: str = "float32") -> spec.Cell:
    return spec.Cell(name=f"tiny-{kind}", chips=1, config=config(dtype),
                     traffic=traffic(kind), limits=limits, end_to_end=[],
                     per_layer=[])


def run(kind: str, limits: dict, seed: int = 2 ** 31 + 7,
        dtype: str = "float32", seconds: float = 0.3,
        trace: bool = False) -> harness.Run:
    return harness.Run(cell=cell(kind, limits, dtype), seed=seed,
                       seconds=seconds, trace=trace, device="cpu")
