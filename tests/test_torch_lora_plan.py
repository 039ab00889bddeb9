"""K3's launch plan, a pure function of the shapes (``ops/lora_bwd.py::
plan``): how the one-pass kernel cuts x and dy into 64-column panels and
splits them over a cluster of CTAs, which clusters walk which 64-token
tiles, its shared memory against the layout in ``csrc/lora_bwd.cu``, and
what the wrapper allocates per call (followed on a CPU tensor that reports
a CUDA device, up to the kernel's C entry)."""

import re
import types

import numpy as np
import pytest

import chip_smoke
from neuspeech1_tpu_torch.ops import _build
from neuspeech1_tpu_torch.ops import lora_bwd as tlb
from neuspeech1_tpu_torch.perf import lora_variants
from tests.test_torch_decode_plan import _Entry, cpu_as_cuda  # noqa: F401
from tests.test_torch_flash_attention import _on_cuda

SMS = 132  # the H100 SXM's

# chip_smoke's cases (the training step's fc1 and fc2, a ragged N at rank
# 12) and the card tests' (tests/test_torch_cuda_kernels.py::LORA_CASES)
PLAN_SHAPES = [case[1:] for case in chip_smoke.LORA_CASES] + [
    (4096, 512, 2048, 32), (1000, 256, 128, 12), (70, 128, 64, 64),
    (5000, 256, 128, 12), (3000, 512, 2048, 1), (3000, 2048, 512, 16),
    (3000, 512, 2048, 33), (3000, 512, 2048, 64), (63, 512, 2048, 32),
    (64, 2048, 512, 32), (65, 512, 2048, 32), (4223, 512, 2048, 32),
    (4224, 512, 2048, 32), (4225, 2048, 512, 32), (300, 16, 64, 8),
    (200, 16, 2048, 64), (1, 16, 16, 1), (96000, 768, 3072, 32),
    (96000, 1024, 4096, 32), (1500, 2048, 1024, 64)]
WIDE_SHAPES = [(200, 1280, 5120, 32), (100, 768, 3072, 64),
               (10, 4096, 4096, 16)]


def _covers_once(ranges, end: int) -> bool:
    """Whether the ranges, in order, tile [0, end) with no gap or overlap."""
    pos = 0
    for begin, stop in ranges:
        if begin != pos or stop < begin:
            return False
        pos = stop
    return pos == end


@pytest.mark.parametrize("n,din,dout,r", PLAN_SHAPES)
def test_lora_plan_covers_din_and_dout_once(n, din, dout, r):
    """The panels hold din's columns, then dout's, each once; the CTAs of a
    cluster take them in rank order, none more than its two warpgroups keep
    sums for; the cluster is a power of two of at most 8 and a CTA's shared
    memory fits the H100's block."""
    pl = tlb.plan(n, din, dout, r, SMS)
    assert pl is not None
    nx, ny = -(-din // 64), -(-dout // 64)
    assert pl.panels == nx + ny
    assert (nx - 1) * 64 < din <= nx * 64 and (ny - 1) * 64 < dout <= ny * 64
    assert pl.cluster in tlb.CLUSTERS and pl.cluster <= 8
    assert pl.rp in (32, 64) and r <= pl.rp and (r > 32) == (pl.rp == 64)
    assert 1 <= pl.pc <= 2 * tlb.per_warpgroup(pl.rp)
    ranges = [(min(c * pl.pc, pl.panels), min((c + 1) * pl.pc, pl.panels))
              for c in range(pl.cluster)]
    assert _covers_once(ranges, pl.panels)
    # the warpgroups of each CTA split its panels, x's before dy's
    for begin, end in ranges:
        p = end - begin
        half = (p + 1) // 2
        assert max(half, p - half) <= tlb.per_warpgroup(pl.rp)
    assert tlb.smem_bytes(pl.pc, pl.rp) <= tlb.MAX_SMEM_BYTES


@pytest.mark.parametrize("n,din,dout,r", PLAN_SHAPES)
def test_lora_plan_covers_the_tokens_once(n, din, dout, r):
    """The clusters' contiguous tile ranges (the kernel's cid * tiles /
    clusters) tile the 64-token tiles once, every cluster at least one
    tile, and the tiles hold every token."""
    pl = tlb.plan(n, din, dout, r, SMS)
    assert (pl.tiles - 1) * tlb.TOK_TILE < n <= pl.tiles * tlb.TOK_TILE
    assert 1 <= pl.clusters <= pl.tiles
    assert pl.clusters * pl.cluster <= SMS
    ranges = [(c * pl.tiles // pl.clusters, (c + 1) * pl.tiles // pl.clusters)
              for c in range(pl.clusters)]
    assert _covers_once(ranges, pl.tiles)
    assert all(stop > begin for begin, stop in ranges)


@pytest.mark.parametrize("case", chip_smoke.LORA_CASES[:2],
                         ids=lambda c: c[0])
def test_lora_plan_fills_the_card_at_the_training_step(case):
    """fc1 and fc2 of the training step: clusters of 4 CTAs of 10 panels,
    one CTA per SM on all 132."""
    _, n, din, dout, r = case
    pl = tlb.plan(n, din, dout, r, SMS)
    assert (pl.rp, pl.cluster, pl.pc) == (32, 4, 10)
    assert pl.clusters * pl.cluster == SMS


@pytest.mark.parametrize("n,din,dout,r", WIDE_SHAPES)
def test_lora_plan_sends_wide_shapes_to_the_wide_path(n, din, dout, r):
    """More panels than eight CTAs hold sums for: no plan (the wrapper runs
    the wide path)."""
    rp = tlb.padded_rank(r)
    assert -(-din // 64) + -(-dout // 64) > 8 * 2 * tlb.per_warpgroup(rp)
    assert tlb.plan(n, din, dout, r, SMS) is None


def _c_source():
    return (_build.SRC_DIR / "lora_bwd.cu").read_text()


def _c_smem_bytes():
    """``smem_bytes`` of csrc/lora_bwd.cu as a Python function of (pc, rp),
    with the source's integer constants."""
    src = _c_source()
    consts = {n: int(v) for n, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"smem_bytes\(int pc, int rp\) \{\s*return (.*?);\s*\}",
                     src, re.S)
    expr = " ".join(body.group(1).split()).replace("/", "//")
    return lambda pc, rp: eval(expr, {}, {**consts, "pc": pc, "rp": rp})


@pytest.mark.parametrize("pc,rp", [(1, 32), (6, 32), (10, 32), (1, 64),
                                   (5, 64), (6, 64)])
def test_lora_smem_bytes_matches_the_c_source(pc, rp):
    """The wrapper's shared-memory formula, which picks the plan, is the C
    source's, term for term, with the same layout constants."""
    src = _c_source()
    consts = {n: int(v) for n, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kTok"], consts["kCols"], consts["kStages"],
            consts["kXPad"], consts["kMaxSmem"]) == (
        tlb.TOK_TILE, tlb.PANEL_COLS, tlb.STAGES, tlb.X_PAD,
        tlb.MAX_SMEM_BYTES)
    assert tlb.smem_bytes(pc, rp) == _c_smem_bytes()(pc, rp)


@pytest.mark.parametrize("rp", [32, 64])
def test_lora_per_warpgroup_matches_the_c_source(rp):
    """The panels a warpgroup keeps sums for, which bounds the plan, are the
    C source's (its register arrays are sized by them)."""
    body = re.search(r"per_warpgroup\(int rp\) \{\s*return rp == 32 \? "
                     r"(\d+) : (\d+);", _c_source())
    assert tlb.per_warpgroup(rp) == int(body.group(1 if rp == 32 else 2))


def _inputs(rng, n, din, dout, r):
    x = _on_cuda(rng.standard_normal((n, din)))
    dy = _on_cuda(rng.standard_normal((n, dout)))
    a = _on_cuda(rng.standard_normal((din, r)))
    b = _on_cuda(rng.standard_normal((r, dout)))
    return x, dy, a, b


@pytest.mark.parametrize("n,din,dout,r", [(96000, 512, 2048, 32),
                                          (10007, 512, 2048, 12),
                                          (70, 128, 64, 64)])
def test_lora_bwd_allocates_outputs_and_one_partial_buffer(
        monkeypatch, cpu_as_cuda, n, din, dout, r):  # noqa: F811
    """The one-pass path allocates dA, dB, dE and the clusters' partial
    sums, and nothing else (no transposed A, no bf16 t1 / u, no chunk
    partials), and passes the plan to the kernel's entry."""
    entry = _Entry()
    monkeypatch.setattr(tlb, "_library", lambda: types.SimpleNamespace(
        **{tlb._FN: entry}))
    monkeypatch.setattr(tlb, "_sm_count", lambda index: SMS)
    x, dy, a, b = _inputs(np.random.default_rng(23), n, din, dout, r)
    cpu_as_cuda.clear()
    before = tlb.launches
    da, db, de = tlb.lora_adapter_bwd(x, dy, a, b)
    assert tlb.launches == before + 1
    pl = tlb.plan(n, din, dout, r, SMS)
    assert cpu_as_cuda == [(din, r), (r, dout), (r,),
                           (pl.clusters, pl.part_floats())]
    assert (tuple(da.shape), tuple(db.shape), tuple(de.shape)) == (
        (din, r), (r, dout), (r,))
    assert entry.args[4:12] == (n, din, dout, r, pl.rp, pl.cluster, pl.pc,
                                pl.clusters)


def test_lora_bwd_wide_path_takes_the_wide_entry(monkeypatch, cpu_as_cuda):  # noqa: F811
    """Past the plan, the wrapper calls the wide path's entry with its
    scratch: bf16 t1 and u, the 64-token dE partials and the 2048-token dA
    and dB partials."""
    entry = _Entry()
    monkeypatch.setattr(tlb, "_library", lambda: types.SimpleNamespace(
        **{tlb._WIDE_FN: entry}))
    monkeypatch.setattr(tlb, "_sm_count", lambda index: SMS)
    n, din, dout, r = 200, 1280, 5120, 32
    x, dy, a, b = _inputs(np.random.default_rng(24), n, din, dout, r)
    cpu_as_cuda.clear()
    tlb.lora_adapter_bwd(x, dy, a, b)
    assert entry.args[4:9] == (n, din, dout, r, 32)
    assert cpu_as_cuda == [(din, r), (r, dout), (r,), (n, 32), (n, 32),
                           (4, 32), (1, din, 32), (1, 32, dout)]


@pytest.mark.parametrize("name", list(lora_variants.VARIANTS))
def test_lora_variant_applies_to_source(name):
    """K3's A/B variants (neuspeech1_tpu_torch/perf/lora_variants.py) still
    apply to its source: each substitution matches once, the headers are
    written in, the #if blocks pair up, and each plan change names a
    constant of the wrapper."""
    subs, plan = lora_variants.VARIANTS[name]
    base = lora_variants.common.variant_source("lora_bwd", "base", ())
    src = lora_variants.variant_source(name)
    assert (src == base) == (not subs)
    assert '#include "flash_sm90.cuh"' not in src and "wgmma_rs" in src
    assert src.count("#if 0") == src.count("#endif") - base.count("#endif")
    assert all(hasattr(tlb, key) for key in plan)
    # what a variant leaves out never includes the refill of the ring (the
    # kernel would wait for it forever)
    kept = re.sub(r"#if 0\n.*?#endif\n", "", src, flags=re.S)
    assert "issue(it + kStages);" in kept
