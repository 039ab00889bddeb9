"""The language-model training cell at a tiny size on the CPU: the kind
end to end (sound runs correct against the real cell's limits), each fault
it can have caught by those limits, and the operation counts against a
hand count."""

import pytest

from benchmark.lib import moe_counts, spec
from benchmark.run import execute
from benchmark.tests import tiny_llm
from benchmark.tools import llm_readings

CELL = "moe-llm-train-b32"


def limits():
    return spec.load_json(spec.BENCH_DIR / "limits" / f"{CELL}.json")


def test_sound_run_is_correct_and_counts_its_rows():
    r = tiny_llm.run(limits(), trace=True, seconds=1.0)
    out = execute(r)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    # the traced slice's routed rows: batch x positions x experts per
    # token, per routed layer, forward and remat's recompute
    c = r.config
    rows = r.stats["batch"] * moe_counts.sequence(c, r.stats["label_len"]) \
        * c["num_experts_per_tok"]
    counted = r.stats["counters"]["moe.rows"]
    per_step = 2 * moe_counts.routed_layers(c) * rows
    assert counted > 0 and counted % per_step == 0


def test_state_left_unchanged(monkeypatch):
    from neuspeech1_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.Optimizer, "update",
                        lambda self, *a, **k: None)
    out = execute(tiny_llm.run(limits()))
    assert not out["correct"]
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch(monkeypatch):
    from neuspeech1_tpu_torch.train import trainstep

    make = trainstep.make_train_step
    monkeypatch.setattr(trainstep, "make_train_step",
                        lambda *a, **k: llm_readings.halved(make(*a, **k)))
    assert not execute(tiny_llm.run(limits()))["correct"]


@pytest.mark.parametrize("mode", ["unbiased_route", "top5", "one_rank_off"])
def test_router_faults(mode):
    with llm_readings.fault(mode):
        out = execute(tiny_llm.run(limits()))
    assert not out["correct"], out["check"]


def test_route_miss_share_counts_the_faulted_layer():
    """The program's choices against the reference's own top k: none off in
    a sound f32 run; with one rank off in one of the two routed layers,
    about every token of that layer."""
    lim = dict(limits(), route_miss_share=1.0)
    sound = execute(tiny_llm.run(lim))["check"]["route_miss_share"]["value"]
    with llm_readings.fault("one_rank_off"):
        off = execute(tiny_llm.run(lim))["check"]["route_miss_share"]["value"]
    assert sound == 0.0
    assert off == pytest.approx(0.5, abs=0.02)


def test_counts_by_hand():
    c = tiny_llm.config()
    # hidden 64, 4 heads of 16 + 8 (v 16), kv_lora 32, dense 96, 8 experts
    # of 32, top-2, one shared; 1 dense + 2 routed layers; vocab 512; 100
    # tower frames merged by 4 -> 25 + 12 text positions = 37
    assert moe_counts.sequence(c, 12) == 37
    assert moe_counts.routed_layers(c) == 2
    proj = 2 * 64 * (4 * 24 + 32 + 8) + 2 * 32 * 4 * 32 + 2 * 4 * 16 * 64
    attn = 2 * (37 * 38 // 2) * 4 * (24 + 16)
    dense = 6 * 64 * 96
    routed = 2 * 64 * 8 + 2 * 6 * 64 * 32 + 6 * 64 * 32
    head = 12 * 2 * 64 * 512
    assert moe_counts.lm_fwd_flops_per_sample(c, 12) == (
        3 * (37 * proj + attn) + 37 * (dense + 2 * routed) + head)
    rows = 10
    gemms = moe_counts.routed_gemms(c, rows)
    assert gemms[0] == (2 * rows * 64 * 64,
                        2 * (rows * 64 + 8 * 64 * 64 + rows * 64))
    assert gemms[1] == (2 * rows * 32 * 64,
                        2 * (rows * 32 + 8 * 32 * 64 + rows * 64))
    assert gemms[2] == (2 * rows * 64 * 32,
                        2 * (rows * 64 + 8 * 64 * 32 + rows * 32))
    assert gemms[3] == (2 * rows * 64 * 64,
                        2 * (rows * 64 + 8 * 64 * 64 + rows * 64))
    # the cell's own: 32 x 503 x 6 rows a layer, 26 layers
    full = spec.load_json(spec.BENCH_DIR / "configs"
                          / "kimi-vl-a3b-lm-meg208.json")
    f, b = moe_counts.routed_gemms(full, 96576)[0]
    assert f == 2 * 96576 * 2048 * 2816
    least = moe_counts.routed_least_seconds(full, 32, 128)
    assert least == pytest.approx(26 * 2 * (
        2 * 96576 * 2048 * 2816 + 2 * 96576 * 1408 * 2048) / 989e12)
