"""The yardstick's arithmetic: the frozen FLOP counts against a hand count
at both configurations' widths, and the roofline and mfu readers."""

import pytest

from benchmark.lib import counts, spec
from benchmark.lib.harness import Run
from benchmark.lib.trace import Trace

CONFIGS = ("whisper-base-meg208", "whisper-large-v3-meg208")


def config(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def hand_count(c, n):
    """Forward FLOPs of one sample, op by op."""
    m = c["model"]
    d, t, ch = m["d_model"], m["max_source_positions"], c["stem"]["in_channels"]
    mac = 0
    mac += 4 * t * ch * d * 3          # conv_a over 6000 samples
    mac += 2 * t * d * d * 3           # conv_b to 3000
    mac += t * d * d * 3               # conv2 to 1500
    for _ in range(m["encoder_layers"]):
        mac += 4 * t * d * d           # q, k, v, out
        mac += 2 * t * t * d           # scores and PV
        mac += 2 * t * d * m["encoder_ffn"]
    for _ in range(m["decoder_layers"]):
        mac += 4 * n * d * d + 2 * n * n * d          # self-attention
        mac += 2 * t * d * d                          # cross K and V
        mac += 2 * n * d * d + 2 * n * t * d          # cross q, out, attend
        mac += 2 * n * d * m["decoder_ffn"]
    mac += n * d * m["vocab_size"]
    return 2 * mac


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("labels", (64, 128))
def test_fwd_flops_against_a_hand_count(name, labels):
    c = config(name)
    assert counts.fwd_flops_per_sample(c, labels) == hand_count(c, labels)


def test_known_values():
    assert counts.fwd_flops_per_sample(config(CONFIGS[0]), 64) == \
        pytest.approx(112.067608576e9)
    assert counts.fwd_flops_per_sample(config(CONFIGS[0]), 128) == \
        pytest.approx(119.615848448e9)


def test_attention_bwd_bound_matches_the_kernel_table():
    # K2 at B=64 T=1500 H=8 D=64: 0.7455 ms by its operations; the cross
    # shape Tq=64: 0.1224 ms by its bytes
    flops, nbytes = counts.attention_bwd(64, 8, 1500, 1500, 64)
    assert counts.least_seconds(flops, nbytes) * 1e3 == pytest.approx(
        0.7455, abs=5e-4)
    flops, nbytes = counts.attention_bwd(64, 8, 64, 1500, 64)
    assert nbytes / counts.PEAK_BYTES_PER_S > flops / counts.PEAK_BF16_FLOPS
    assert counts.least_seconds(flops, nbytes) * 1e3 == pytest.approx(
        0.1224, abs=2e-3)


def test_decode_cross_bytes():
    c = config(CONFIGS[0])
    # K and V of 128 clips x 1500 frames x 512 in bf16 (2.36 GB over the 6
    # layers), and the 5 beam rows' queries and outputs
    kv = 128 * 1500 * 512 * 2 * 2
    q_out = 128 * 5 * 512 * 2 * 2
    assert counts.decode_cross_bytes(c, 128, 5) == kv + q_out
    assert 6 * kv == pytest.approx(2.36e9, rel=1e-3)


def _run(kind, stats, profile, cfg=CONFIGS[0]):
    cell = spec.Cell(name="x", chips=1, config=config(cfg),
                     traffic=spec.load_json(
                         spec.BENCH_DIR / "traffic" / (
                             "train-b64-l128.json" if kind == "train"
                             else "beam5-b128-t48.json")),
                     limits={}, end_to_end=[], per_layer=[])
    r = Run(cell=cell, seed=0, seconds=1, trace=True, device="cuda")
    r.stats.update(stats)
    r.profile = profile
    return r


def test_train_mfu_reader():
    read = spec.metric_reader("train_mfu")
    c = config(CONFIGS[0])
    r = _run("train", dict(steps_outside=10, seconds_outside=2.0, batch=64,
                           label_len=128), None)
    want = 100 * 3 * counts.fwd_flops_per_sample(c, 128) * 320 / 989e12
    assert read(r) == pytest.approx(want)
    assert 0 < read(r) < 100


def test_rooflines_from_a_synthetic_trace():
    least = counts.train_step_attention_bwd(config(CONFIGS[0]), 64, 128)
    ops = [("void flash_bwd_dkdv_kernel<64>(Params)", 0.0, least),
           ("void flash_bwd_dq_kernel<64>(Params)", 1.0, least),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 2.0,
            0.5)]
    p = Trace(window_s=4.0, busy_s=2 * least + 0.5, ops=ops, spans=[],
              units=1)
    r = _run("train", dict(batch=64, label_len=128), p)
    assert spec.metric_reader("flash_bwd_roofline")(r) == pytest.approx(50.0)
    assert spec.metric_reader("train_elementwise_ms")(r) == \
        pytest.approx(500.0)
    assert spec.metric_reader("idle_share.train")(r) == pytest.approx(
        100 * (1 - (2 * least + 0.5) / 4.0))
    # nothing to read: no value, never 0
    r.profile = Trace(window_s=1.0, busy_s=0.0, ops=[], spans=[], units=1)
    assert spec.metric_reader("flash_bwd_roofline")(r) is None


def test_decode_readers():
    c = config(CONFIGS[0])
    per = counts.decode_cross_bytes(c, 128, 5) / counts.PEAK_BYTES_PER_S
    ops = [("void decode_cross_kernel<64, 2>(...)", i * 1.0, 2 * per)
           for i in range(12)]
    ops += [("void decode_step_kernel(...)", 20.0 + i, 0.001)
            for i in range(84)]
    p = Trace(window_s=100.0, busy_s=1.0, ops=ops, spans=[], units=2)
    r = _run("decode", dict(batch=128, requests_outside=4,
                            seconds_outside=2.0, prompt_len=4,
                            upload_s=0.02), p)
    assert spec.metric_reader("decode_cross_roofline")(r) == \
        pytest.approx(50.0)
    assert spec.metric_reader("decode_ops_per_step")(r) == pytest.approx(
        96 / (2 * 48))
    assert spec.metric_reader("upload_ms")(r) == pytest.approx(20.0)
    flops = counts.decode_request_flops(c, 128, 5, 4, 48)
    assert spec.metric_reader("decode_mfu")(r) == pytest.approx(
        100 * flops * 2 / 989e12)
    assert 16e12 < flops < 18e12
