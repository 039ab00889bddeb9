"""The port's profiling hooks (neuspeech1_tpu_torch/train/profiling.py;
the port of tests/test_trainer.py:171-190): a Profiler window over one
step writes a chrome trace holding the annotated region, the StepTimer
times every step, and ``block`` returns on tensors in any container. Then
the spans and counters: off they call no ``record_function`` and count
nothing, on they nest under the ``ns/`` prefix, the summary's attribution
on a hand-made trace, garbage collections as spans, and the numbers of a
train step and a beam search bit-identical with tracing on and off."""

import gc
import json

import numpy as np
import pytest
import torch

from neuspeech1_tpu_torch.config import StemConfig, tiny_config
from neuspeech1_tpu_torch.decode.generate import GenerationConfig, beam_search
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.models.init import init_params
from neuspeech1_tpu_torch.models.lora import init_lora
from neuspeech1_tpu_torch.train import optimizer, profiling, trainstep
from neuspeech1_tpu_torch.train.profiling import Profiler, StepTimer, annotate


def test_profiler_and_step_timer(tmp_path):
    prof = Profiler(str(tmp_path / "prof"), start_step=1, num_steps=1)
    timer = StepTimer()
    x = torch.ones((8, 8))
    for step in range(3):
        prof.maybe_start(step)
        with timer.measure():
            with annotate("matmul"):
                y = x @ x
            timer.block({"y": [y, (y,)]})
        prof.maybe_stop(step)
    prof.close()
    assert timer.mean_ms >= 0
    assert len(timer.times) == 3
    files = sorted((tmp_path / "prof").iterdir())
    # the chrome trace and, beside it, the summary of its spans
    assert [f.name for f in files] == ["summary_1_2.json", "trace_1_2.json"]
    events = json.loads(files[1].read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    # the window spans steps 1 and 2, as the JAX Profiler's does
    assert names.count("matmul") == 2


def test_close_ends_an_open_window(tmp_path):
    prof = Profiler(str(tmp_path / "p"), start_step=0, num_steps=100)
    prof.maybe_start(0)
    with annotate("open"):
        torch.ones(2).sum()
    prof.close()
    assert prof.trace_path.endswith("trace_0_100.json")
    assert "open" in open(prof.trace_path).read()
    prof.close()  # a second close is a no-op


# --------------------------------------------------------------------------
# spans and counters (the port's one tracing system)
# --------------------------------------------------------------------------

AUG = {"noise": {"prob": 0.5, "min_snr_dB": 5, "max_snr_dB": 20},
       "taylor": {"prob": 0.7}}


def _tiny_train():
    """A fresh AdaLoRA step on a tiny f32 model (augmentation, dropout,
    the orthogonality loss, the fold and the importance EMAs all on), its
    state and one batch, all from seeds."""
    config = tiny_config()
    stem = StemConfig("base", in_channels=8, dropout=0.1)
    model = module_from_params(init_params(config, stem, seed=0,
                                           device="cpu"),
                               config, stem, device="cpu",
                               dtype=torch.float32)
    lora = init_lora(config, rank=4, alpha=8, adalora=True, seed=1,
                     device="cpu")
    tx = optimizer.make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                  total_steps=10)
    state, frozen = trainstep.init_train_state(model, lora, tx, seed=3)
    step = trainstep.make_train_step(
        config, stem, tx, orth_reg_weight=0.5, augment_config=AUG,
        use_dropout=True, track_adalora_importance=True, fold_lora=True)
    rng = np.random.default_rng(0)
    batch = {"input_features": torch.from_numpy(rng.standard_normal(
        (2, 8, 4 * config.max_source_positions)).astype(np.float32))}
    for key in ("labels", "decoder_input_ids"):
        batch[key] = torch.from_numpy(rng.integers(0, 200, (2, 8)))
    return step, state, frozen, batch


def _tiny_beam():
    """A beam search call on a tiny f32 model: () -> (tokens, scores)."""
    config = tiny_config()
    stem = StemConfig("base", in_channels=8)
    model = module_from_params(init_params(config, stem, seed=0,
                                           device="cpu"),
                               config, stem, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 4 * config.max_source_positions)).astype(np.float32))
    prompt = torch.tensor([[config.sot_id, config.first_language_id]] * 2)
    gen = GenerationConfig.for_model(config, max_length=8, num_beams=3,
                                     repetition_penalty=1.5,
                                     no_repeat_ngram_size=2)
    return lambda: beam_search(model, feats, prompt, gen)


def _user_spans(path):
    events = json.load(open(path))["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1e-3)


def test_spans_off_call_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function with nothing recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.tracing()
    before = profiling.counters()
    with profiling.span("a"), profiling.unit("b"), profiling.annotate("c"):
        profiling.count("test.hot")
    assert profiling.traced("d")(lambda x: x + 1)(1) == 2
    step, state, frozen, batch = _tiny_train()
    step(state, frozen, batch)
    _tiny_beam()()
    gc.collect()
    assert profiling.counters() == before
    profiling.count("test.always", 2, always=True)
    assert profiling.counter_changes(before) == {"test.always": 2}


def test_spans_nest_with_the_prefix_under_the_profiler(tmp_path):
    step, state, frozen, batch = _tiny_train()
    beam = _tiny_beam()
    prof = Profiler(str(tmp_path), start_step=0, num_steps=1)
    prof.maybe_start(0)
    step(state, frozen, batch)
    beam()
    prof.maybe_stop(1)
    spans = _user_spans(prof.trace_path)
    names = {e["name"] for e in spans}
    want = {"ns/train/" + s for s in (
        "step", "augment", "dropout", "fold", "forward", "loss", "backward",
        "reduce", "clip", "update", "ipt")}
    want |= {"ns/decode/" + s for s in (
        "generate", "init_cache", "prefill", "processors", "select",
        "finalize", "alive", "wait", "reorder")}
    want |= {"ns/model/encoder", "ns/model/decoder"}
    assert want <= names
    assert all(n.startswith("ns/") for n in names)
    one = {e["name"]: e for e in spans}
    step_span = one["ns/train/step"]
    for name in want:
        if name.startswith("ns/train/") and name != "ns/train/step":
            assert _inside(one[name], step_span), name
    forwards = [e for e in spans if e["name"] == "ns/train/forward"]
    assert any(_inside(e, forwards[0]) for e in spans
               if e["name"] == "ns/model/encoder")
    gen_span = one["ns/decode/generate"]
    for e in spans:
        if e["name"].startswith("ns/decode/") and e is not gen_span:
            assert _inside(e, gen_span), e["name"]
    # the summary beside the trace, and the counters over the window
    summary = json.load(open(prof.summary_path))
    assert summary == json.loads(json.dumps(prof.summary))
    assert summary["spans"]["ns/train/step"]["count"] == 1
    row = summary["spans"]["ns/decode/select"]
    assert row["count"] == summary["counters"]["decode.steps"] >= 1
    # the last position's step takes no wait
    assert row["count"] - 1 <= summary["counters"]["decode.waits"] \
        <= row["count"]
    assert set(row) == {"count", "host_ms", "self_ms", "idle_ms",
                        "device_ms"}
    assert 0 <= row["self_ms"] <= row["host_ms"]


def _x(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summary_attributes_idle_kernels_and_self_time():
    ms = 1000.0  # the trace's unit is the microsecond
    events = [
        _x("ns/a", 0, 100 * ms), _x("ns/b", 10 * ms, 30 * ms),
        _x("ns/c", 45 * ms, 45 * ms), _x("ns/d", 60 * ms, 10 * ms),
        _x("bench/other", 0, 130 * ms),          # not the program's
        # launches: in b, in d, in a alone; one on a thread with no span
        _x("cudaLaunchKernel", 15 * ms, 1, "cuda_runtime", corr=1),
        _x("cudaLaunchKernel", 65 * ms, 1, "cuda_runtime", corr=2),
        _x("cudaLaunchKernel", 95 * ms, 1, "cuda_runtime", corr=3),
        _x("cudaLaunchKernel", 5 * ms, 1, "cuda_runtime", tid=2, corr=4),
        _x("k1", 20 * ms, 10 * ms, "kernel", tid=7, corr=1),
        _x("k2", 70 * ms, 10 * ms, "kernel", tid=7, corr=2),
        _x("k3", 96 * ms, 14 * ms, "kernel", tid=7, corr=3),
        _x("k4", 8 * ms, 4 * ms, "kernel", tid=7, corr=4),
        _x("Memset", 120 * ms, 10 * ms, "gpu_memset", tid=7),  # no launch
    ]
    s = profiling.summarize({"traceEvents": events})
    assert s["window_ms"] == pytest.approx(130)
    assert s["busy_ms"] == pytest.approx(48)
    # gaps [0, 8] in a, [12, 20] in b, [30, 70] and [80, 96] in c, and
    # [110, 120] past every program span
    assert s["idle_ms"] == pytest.approx(82)
    assert s["idle_named_ms"] == pytest.approx(72)
    assert s["idle_named_share"] == pytest.approx(72 / 82)
    assert s["device_unnamed_ms"] == pytest.approx(10)
    assert set(s["spans"]) == {"ns/a", "ns/b", "ns/c", "ns/d"}
    want = {"ns/a": (1, 100, 25, 8, 14 + 4), "ns/b": (1, 30, 30, 8, 10),
            "ns/c": (1, 45, 35, 56, 0), "ns/d": (1, 10, 10, 0, 10)}
    for name, (n, host, own, idle, device) in want.items():
        row = s["spans"][name]
        assert row["count"] == n
        assert (row["host_ms"], row["self_ms"], row["idle_ms"],
                row["device_ms"]) == pytest.approx((host, own, idle, device))
    assert [g[0] for g in s["longest_gaps"]][:3] == ["ns/c", "ns/c", "none"]
    assert s["longest_gaps"][0][1] == pytest.approx(40)
    # the benchmark's spans too, where asked: the last gap is then named
    both = profiling.summarize(events, prefixes=("ns/", "bench/"))
    assert both["idle_named_ms"] == pytest.approx(82)
    assert both["spans"]["bench/other"]["self_ms"] == pytest.approx(30)
    lines = profiling.span_lines(s)
    assert lines[1].endswith("ns/a") and "87.8% named" in lines[-1]


def test_a_collection_under_the_profiler_is_a_span(tmp_path):
    before = profiling.counters()
    gc.collect()
    assert profiling.counters() == before
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            gc.collect()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    spans = _user_spans(path)
    gcs = [e for e in spans if e["name"] == "ns/host/gc"]
    outer = [e for e in spans if e["name"] == "ns/outer"]
    assert gcs and len(outer) == 1
    assert any(_inside(e, outer[0]) for e in gcs)
    changes = profiling.counter_changes(before)
    assert changes["host.gc_collections"] >= 1
    assert changes["host.gc_ms"] > 0


def test_tracing_leaves_the_numbers_bit_identical(tmp_path):
    def train():
        step, state, frozen, batch = _tiny_train()
        m = step(state, frozen, batch)
        return m, state.trainable

    def recording(fn):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert profiling.tracing()
            return fn()

    m0, leaves0 = train()
    m1, leaves1 = recording(train)
    for key in ("loss", "ce_loss", "orth_reg", "grad_norm"):
        assert torch.equal(m0[key], m1[key]), key
    assert leaves0.keys() == leaves1.keys()
    for k in leaves0:
        assert torch.equal(leaves0[k], leaves1[k]), k
    beam = _tiny_beam()
    tokens0, scores0 = beam()
    tokens1, scores1 = recording(beam)
    assert torch.equal(tokens0, tokens1) and torch.equal(scores0, scores1)
