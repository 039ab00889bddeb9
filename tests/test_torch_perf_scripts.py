"""The port's counterparts of the JAX package's root perf scripts
(neuspeech1_tpu_torch/perf/{serve_bench,spec_bench,trace_step}.py): each
``main`` runs on the CPU at the tiny config and prints the JAX script's
keys; their rates are finite, and trace_step's interval union against
hand-made traces. Their times here are CPU times: the card's come from
chip_smoke.py. This file imports neither JAX nor the JAX package."""

import json
import math

import pytest
import torch

from neuspeech1_tpu_torch.perf import serve_bench, spec_bench, trace_step
from neuspeech1_tpu_torch.train import profiling

torch.set_num_threads(1)

TINY = ["--model", "test", "--device", "cpu", "--repeats", "1"]


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_serve_bench_prints_the_jax_keys(capsys):
    assert serve_bench.main(TINY + ["--batch", "2", "--new_tokens", "3"]) \
        == 0
    lines = _lines(capsys)
    assert [r["config"] for r in lines] == [
        "greedy", "greedy_int8kv", "beam5_rp5_ngram2",
        "beam5_rp5_ngram2_int8kv"]
    for r in lines:
        assert set(r) == {"config", "batch", "new_tokens", "ms_per_batch",
                          "utterances_per_sec"}
        assert (r["batch"], r["new_tokens"]) == (2, 3)
        assert math.isfinite(r["utterances_per_sec"]) and \
            r["utterances_per_sec"] > 0
        assert r["utterances_per_sec"] == pytest.approx(
            2e3 / r["ms_per_batch"])


def test_spec_bench_prints_the_jax_keys(capsys):
    assert spec_bench.main(TINY + ["--batch", "2", "--new_tokens", "6",
                                   "--gammas", "2,3"]) == 0
    lines = _lines(capsys)
    assert [r["config"] for r in lines] == [
        "greedy_int8kv", "spec_greedy_int8kv_g2", "spec_g2_analysis",
        "spec_greedy_int8kv_g3", "spec_g3_analysis"]
    assert lines[0]["loop_iters"] == 6
    for r in (lines[1], lines[3]):
        assert set(r) == {"config", "batch", "new_tokens", "ms_per_batch",
                          "utterances_per_sec", "loop_iters"}
        assert 1 <= r["loop_iters"] <= 6
    for r, gen in ((lines[2], lines[1]), (lines[4], lines[3])):
        assert set(r) == {"config", "iter_cost_ratio_vs_greedy_step",
                          "mean_accepted_per_iter", "speedup_formula"}
        assert r["mean_accepted_per_iter"] == 6 / gen["loop_iters"]
        assert math.isfinite(r["iter_cost_ratio_vs_greedy_step"])


def test_trace_step_reports_busy_and_idle(capsys, tmp_path):
    assert trace_step.main(["--model", "test", "--device", "cpu", "--batch",
                            "2", "--steps", "2", "--tracedir",
                            str(tmp_path)]) == 0
    r = _lines(capsys)[-1]
    assert {"wall_ms_per_step", "steps", "span_ms", "busy_ms", "idle_ms",
            "busy_share", "kernels", "top_groups", "top_ops"} <= set(r)
    assert r["steps"] == 2 and r["wall_ms_per_step"] > 0
    # no device here: no device events, an empty span
    assert r["kernels"] == 0 and r["span_ms"] == r["busy_ms"] == 0
    assert r["trace"].startswith(str(tmp_path))
    # the span table: the program's spans of the step, ms per step
    assert {"spans", "idle_named_share", "counters", "summary"} <= set(r)
    assert r["summary"].startswith(str(tmp_path))
    assert {"ns/train/step", "ns/train/forward", "ns/train/backward",
            "ns/train/update"} <= set(r["spans"])
    for row in r["spans"].values():
        assert set(row) == {"count", "host_ms", "self_ms", "idle_ms",
                            "device_ms"}
    assert r["spans"]["ns/train/step"]["count"] == 2
    assert r["idle_named_share"] is None  # no device, no idle to name


def test_parse_trace_takes_the_union_of_device_intervals(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void k1<4>(float*)",
         "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void k1<8>(float*)",
         "ts": 5, "dur": 10},  # overlaps the first: union 0..15
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 20, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 100},  # host work: not the device's
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 2},
        {"ph": "X", "cat": "user_annotation", "name": "ns/train/step",
         "ts": 0, "dur": 50},  # a program span: not the device's
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "flash_bwd_dq_kernel<64, false>((anonymous namespace)::Params)",
         "ts": 41, "dur": 3},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, span, by_name, by_group, n = trace_step.parse_trace(str(path))
    assert (busy, span, n) == (15 + 5 + 4, 44, 5)
    assert by_group["k1"] == 20 and by_group["Memcpy DtoH"] == 5
    assert by_name["k2"] == 2 and by_group["flash_bwd_dq_kernel"] == 3
    # the span table's keys: the gaps [15, 20] and [25, 40] lie in the span
    row = profiling.summarize(str(path))["spans"]["ns/train/step"]
    assert row == {"count": 1, "host_ms": 0.05, "self_ms": 0.05,
                   "idle_ms": 0.02, "device_ms": 0.0}
