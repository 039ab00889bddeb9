"""The CUDA sources' build keys (neuspeech1_tpu_torch/ops/_build.py): a
library is named by the hash of its source, the headers that source includes
from csrc/ and the flags, so an edited header rebuilds exactly the sources
that include it. Nothing is compiled here."""

import pytest

from neuspeech1_tpu_torch.ops import _build


@pytest.fixture
def src_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "common.cuh").write_text("// shared\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "common.cuh"\n')
    (tmp_path / "direct.cu").write_text(
        '#include <cuda_runtime.h>\n#include "common.cuh"\nint a;\n')
    (tmp_path / "nested.cu").write_text(' #  include "outer.cuh"\nint b;\n')
    (tmp_path / "alone.cu").write_text("#include <stdint.h>\nint c;\n")
    return tmp_path


def test_sources_follow_quoted_includes(src_dir):
    assert [p.name for p in _build.sources("direct")] == ["direct.cu",
                                                          "common.cuh"]
    assert [p.name for p in _build.sources("nested")] == [
        "nested.cu", "outer.cuh", "common.cuh"]
    assert [p.name for p in _build.sources("alone")] == ["alone.cu"]


@pytest.mark.parametrize("edited,rebuilt", [
    ("common.cuh", {"direct", "nested"}), ("outer.cuh", {"nested"}),
    ("alone.cu", {"alone"})])
def test_editing_a_file_renames_the_libraries_that_include_it(
        src_dir, edited, rebuilt):
    names = ("direct", "nested", "alone")
    before = {n: _build.library_path(n) for n in names}
    with open(src_dir / edited, "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert {n for n in names if after[n] != before[n]} == rebuilt


def test_flash_sources_share_the_header():
    """Both flash sources, the LoRA backward and the probes' forward and
    dot include csrc/flash_sm90.cuh, which includes csrc/decode_sm90.cuh,
    so an edit of either rebuilds all five; the decode step includes only
    decode_sm90.cuh, and a source that includes neither keeps its key."""
    for name in ("flash_fwd_btc", "flash_bwd_btc", "lora_bwd", "probe_fwd",
                 "probe_dot"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "flash_sm90.cuh", "decode_sm90.cuh"]
    assert [p.name for p in _build.sources("decode_step")] == [
        "decode_step.cu", "decode_sm90.cuh"]
    assert [p.name for p in _build.sources("probe_bwd")] == ["probe_bwd.cu"]
