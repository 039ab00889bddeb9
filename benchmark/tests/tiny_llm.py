"""A tiny cell of the language-model configuration for the CPU tests: the
real configuration and traffic files with every size cut (hidden 64, 4
heads, qk_nope 16 / rope 8 / v 16, kv_lora 32, 8 experts top-2, one shared,
one dense and two routed layers, a tiny Whisper tower), run on the CPU in
f32."""

from __future__ import annotations

import copy

from benchmark.lib import harness, spec
from benchmark.tests import tiny

CONFIG = "kimi-vl-a3b-lm-meg208"
TRAFFIC = "llm-train-b32-p375-l128"
VOCAB = 512


def config() -> dict:
    c = copy.deepcopy(spec.load_json(spec.BENCH_DIR / "configs"
                                     / f"{CONFIG}.json"))
    c.update(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
             moe_intermediate_size=32, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4,
             n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, start_id=VOCAB - 3, pad_id=VOCAB - 1,
             lm_dtype="float32", init_std=0.1, e_score_correction_bias_std=0.1)
    t = tiny.config()
    c["tower"] = {k: t[k] for k in c["tower"]}
    c["projector"]["init_std"] = 0.1
    return c


def traffic() -> dict:
    t = spec.load_json(spec.BENCH_DIR / "traffic" / f"{TRAFFIC}.json")
    t.update(batch=4, label_len=12, real_tokens=[4, 10], pool_clips=16,
             clip_seconds=[0.5, 2.0], reference_rows=2, trace_after_steps=1,
             trace_steps=2)
    return t


def run(limits: dict, seed: int = 2 ** 31 + 11, seconds: float = 0.2,
        trace: bool = False) -> harness.Run:
    cell = spec.Cell(name="tiny-llm", chips=1, config=config(),
                     traffic=traffic(), limits=limits, end_to_end=[],
                     per_layer=[])
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                       device="cpu")
