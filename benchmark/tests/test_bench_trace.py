"""The frozen trace parser on a small synthetic chrome trace, and the
profiled slice on the CPU."""

import json

import pytest

from benchmark.lib import trace


def write(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_union_and_groups():
    assert trace.union_busy([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert trace.group_of("void at::native::(anonymous namespace)::"
                          "foo_kernel<float, 4>(int)") == \
        "at::native::foo_kernel"


def test_parse_reads_device_work_and_spans(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void k1<1>(int)", "ts": 100,
         "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 140,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void k2(int)", "ts": 400,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 90,
         "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "bench/request",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "bench/upload",
         "ts": 150, "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    t = trace.parse(write(tmp_path, events), window_s=1e-3, units=2)
    assert len(t.ops) == 3
    assert t.busy_s == pytest.approx(160e-6)
    assert t.top_ops(2) == [["k2", pytest.approx(100e-6)],
                            ["k1", pytest.approx(50e-6)]]
    # the one gap, 160-400 us: its middle, 280 us, lies past bench/upload
    # (150-250) and inside bench/request
    assert t.idle_gaps() == [["bench/request", pytest.approx(240e-6)]]
    assert t.count(lambda n: "k" in n) == 2


def test_slice_on_the_cpu_finds_no_device_work():
    s = trace.Slice(True, after=1, units=2, attempts=2)
    try:
        for unit in range(8):
            with trace.span("step"):
                sum(range(1000))
            s.tick(unit)
        assert s.attempts == 0
        assert s.read() is None
        assert s.traced_units == []
        # two slices of two units: their units and the one after each
        assert s.touched() == {1, 2, 3, 4, 5, 6}
    finally:
        s.close()
