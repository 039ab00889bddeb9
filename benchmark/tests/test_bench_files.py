"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric added as files alone are found by name; and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from benchmark.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    return spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_every_cell_resolves():
    b = bench()
    for w in b["workloads"]:
        cell = spec.cell_spec(w["name"])
        assert cell.kind in ("train_step", "decode")
        spec.kind_module(cell.kind)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in names
        assert cell.limits


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for p in b["paths"]:
        assert not (spec.ROOT / p).is_file() and (spec.ROOT / p).is_dir()
    configs = {c["name"] for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert configs == used
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert spec.load_json(spec.ROOT / c["file"])["reduced"] == c["reduced"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.fixture
def copy(tmp_path):
    """A checkout holding BENCHMARK.json and the benchmark's folder."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_added_as_files_is_found(copy):
    bench_dir = copy / "benchmark"
    config = spec.load_json(bench_dir / "configs" / "whisper-base-meg208.json")
    config["name"] = "whisper-base-meg273"
    config["stem"]["in_channels"] = 273
    (bench_dir / "configs" / "whisper-base-meg273.json").write_text(
        json.dumps(config))
    mix = spec.load_json(bench_dir / "traffic" / "beam5-b128-t48.json")
    mix["num_beams"] = 3
    (bench_dir / "traffic" / "beam3-b128-t48.json").write_text(
        json.dumps(mix))
    (bench_dir / "limits" / "meg273-beam3.json").write_text(
        json.dumps({"token_gap": 1.0}))
    (bench_dir / "metrics" / "beam_width.py").write_text(
        "def read(run):\n    return run.traffic['num_beams']\n")
    b = json.loads((copy / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "whisper-base-meg273", "source": "x",
                         "file": "benchmark/configs/whisper-base-meg273.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "meg273-beam3",
                           "config": "whisper-base-meg273",
                           "traffic": "beam3-b128-t48", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if "workloads" in m and "base-beam-b128" in m["workloads"]:
            m["workloads"].append("meg273-beam3")
    b["per_layer"].append({"name": "beam_width", "unit": "beams",
                           "better": "higher", "source": "program_counter",
                           "layer": "decode loops",
                           "moves": "decode_utt_per_s",
                           "workloads": ["meg273-beam3"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.cell_spec("meg273-beam3", root=copy)
    assert cell.config["stem"]["in_channels"] == 273
    assert cell.traffic["num_beams"] == 3 and cell.kind == "decode"
    assert cell.limits == {"token_gap": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {
        "decode_utt_per_s", "decode_p80_ms", "setup_s"}
    assert "beam_width" in {m["name"] for m in cell.per_layer}

    class Run:
        traffic = cell.traffic

    read = spec.metric_reader("beam_width", root=copy)
    assert read(Run()) == 3
    # the cells already there are unchanged
    assert spec.cell_spec("base-beam-b128", root=copy).traffic[
        "num_beams"] == 5
