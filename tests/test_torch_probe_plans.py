"""The probe kernels' schedules, pure functions of the arguments: the map
from a TPU probe's ``block_q``, ``n_sub`` and ``dimension_semantics`` to
P-fwd's schedule (``perf/common.py``; ``ops/probe_fwd.py::plan``, mirroring
``Sched`` in ``csrc/probe_fwd.cu``), P-bwd's (``ops/probe_bwd.py::plan``,
mirroring ``Sched`` in ``csrc/probe_bwd.cu``), P-dot's tiling
(``ops/probe_dot.py::plan``, mirroring ``csrc/probe_dot.cu``), every
variant of chip_smoke's probe sweep against them, and what the wrappers
hand the C entries (followed on CPU tensors that report a CUDA device)."""

import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
from neuspeech1_tpu_torch.ops import _build
from neuspeech1_tpu_torch.ops import probe_bwd as tpb
from neuspeech1_tpu_torch.ops import probe_dot as tpd
from neuspeech1_tpu_torch.ops import probe_fwd as tpf
from neuspeech1_tpu_torch.perf import btc_probe, bwd_probe, common
from neuspeech1_tpu_torch.perf import kernel_probe, mxu_probe
from tests.test_torch_decode_plan import _Entry, cpu_as_cuda  # noqa: F401
from tests.test_torch_flash_attention import _on_cuda

TK, T = chip_smoke.PROBE_TK, chip_smoke.PROBE_T
SMEM = 232448  # an H100 block's shared memory (227 KB)
PROBE_MODULES = (kernel_probe, mxu_probe, btc_probe)


def _sweep_calls(monkeypatch, kernel="probe_fwd"):
    """Each variant of chip_smoke's probe sweep for ``kernel`` (probe_fwd
    or probe_bwd), run through its ``perf`` make_* function with the
    kernel's entry replaced by a recorder: (tag, the keyword arguments it
    passes)."""
    seen = []

    def record(*arrays, **kw):
        seen.append(kw)

    for mod in PROBE_MODULES + (bwd_probe,):
        if hasattr(mod, kernel):
            monkeypatch.setattr(mod, kernel, record)
    n_arrays = 3 if kernel == "probe_fwd" else 6
    out = []
    for v in chip_smoke._probe_variants():
        if v["kernel"] == kernel:
            v["make"](t_valid=T)(*[None] * n_arrays)
            out.append((v["tag"], seen.pop()))
    return out


def test_every_forward_variant_of_the_sweep_has_a_plan(monkeypatch):
    """All 22 variants map to a built schedule at the probes' TK that fits
    the card's shared memory; none is refused."""
    calls = _sweep_calls(monkeypatch)
    assert len(calls) == 22
    for tag, kw in calls:
        rows, n_sub = kw["rows"], kw.get("n_sub", 1)
        n_kb, mode = kw.get("n_kb", 1), kw.get("mode", "base")
        tpf.check_schedule(mode, rows, n_sub, n_kb, kw.get("order", "head"),
                           TK)
        pl = tpf.plan(rows, n_sub, TK, n_kb)
        assert pl["smem_bytes"] <= SMEM, tag
        assert pl["ctas_per_sm"] * pl["smem_bytes"] <= SMEM, tag
        assert (TK // n_kb) % pl["block_k"] == 0, tag


@pytest.mark.parametrize("block_q,rows,warpgroups", [(512, 128, 2),
                                                     (256, 64, 1)])
def test_block_q_maps_to_whole_warpgroups(block_q, rows, warpgroups):
    """block_q -> rows = block_q / 4, in warpgroups of 64 q rows: one
    warpgroup's CTAs share an SM two at a time, two warpgroups' run
    alone."""
    assert common.fwd_rows(block_q) == rows
    pl = tpf.plan(rows, 1, TK)
    assert pl["warpgroups"] == warpgroups and not pl["turns"]
    assert pl["threads"] == (160 if warpgroups == 1 else 384)
    assert pl["ctas_per_sm"] == (2 if warpgroups == 1 else 1)
    assert pl["block_k"] == 128


@pytest.mark.parametrize("n_sub,turns,block_k", [(1, False, 128),
                                                 (2, True, 128),
                                                 (4, True, 64)])
def test_n_sub_maps_to_turns_on_the_tensor_cores(n_sub, turns, block_k):
    """n_sub 1: the two warpgroups run free; 2: they take turns per
    128-column K tile; 4: per 64-column tile (four turns per 128
    columns). The ring keeps the same bytes."""
    pl = tpf.plan(common.fwd_rows(512), n_sub, TK)
    assert (pl["turns"], pl["block_k"]) == (turns, block_k)
    assert pl["stages"] * block_k == 4 * 128
    assert pl["smem_bytes"] == tpf.plan(128, 1, TK)["smem_bytes"] + \
        16 * (pl["stages"] - 4)


def test_semantics_map_to_the_walk(monkeypatch):
    """The last dimension_semantics entry names the q-block axis:
    'parallel' -> q-tile-major walk, 'arbitrary' -> head-major."""
    assert common.sem_order(("parallel", "parallel")) == "qblock"
    assert common.sem_order(("parallel", "arbitrary")) == "head"
    assert {common.sem_order(s) for s in btc_probe.SEMS} == {"head"}
    orders = {tag: kw.get("order", "head")
              for tag, kw in _sweep_calls(monkeypatch)}
    assert orders["sem_parallel_parallel_bq512"] == "qblock"
    assert orders["sem_parallel_arbitrary_bq256"] == "head"
    assert {o for t, o in orders.items() if not t.startswith("sem_")} == {
        "head"}


def test_small_column_blocks_take_64_row_k_tiles():
    """A column block that is not a multiple of 128 (the CPU tests' TK =
    256 in four blocks) takes 64-row K tiles, with twice the stages."""
    assert tpf.plan(128, 1, 256, 4)["block_k"] == 64
    assert tpf.plan(128, 1, 256, 2)["block_k"] == 128
    assert tpf.plan(64, 1, 768, 4)["stages"] == 6


def _c_source(name):
    return (_build.SRC_DIR / f"{name}.cu").read_text()


def test_forward_plan_mirrors_the_c_source():
    """The Python plan and the C Sched share their constants: stages per
    128 columns, the schedules built, at most 4 column blocks."""
    src = _c_source("probe_fwd")
    assert "kStages = (WG == 1 ? 3 : 4) * (128 / BK)" in src
    assert "kBytes = kBars + 16 * (1 + kStages) + 1024" in src
    assert re.search(r"constexpr int kMaxBlocks = (\d+);", src).group(1) == \
        str(tpf.MAX_BLOCKS)
    assert "#include \"flash_sm90.cuh\"" in src
    assert "mma.sync.aligned" not in src and "mma16816(" not in src
    built = set(re.findall(r"rows == (\d+) && n_sub == (\d)", src))
    built |= {("128", "2"), ("128", "4")} if re.search(
        r"rows == 128 && \(n_sub == 2 \|\| n_sub == 4\)", src) else set()
    assert {(int(r), int(n)) for r, n in built} == set(tpf.SCHEDULES)


def test_dot_plan_mirrors_the_c_source():
    src = _c_source("probe_dot")
    consts = {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", src)}
    assert (consts["kBM"], consts["kBN"], consts["kBK"]) == \
        (tpd.TILE_M, tpd.TILE_N, tpd.TILE_K)
    assert consts["kStages"] == tpd.STAGES
    stage = (consts["kBM"] + consts["kBN"]) * consts["kBK"] * 2
    smem = consts["kStages"] * stage + 2 * 64 * consts["kBN"] * 2 + \
        16 * consts["kStages"] + 1024
    assert tpd.plan(512, 1536, 512)["smem_bytes"] == smem <= SMEM
    assert "mma.sync.aligned" not in src and "mma16816(" not in src


@pytest.mark.parametrize("kdim", [64, 128, 256, 512])
def test_dot_accepts_the_probe_shapes(kdim):
    """M = 512, N = 1536 and each K of the probe fit the tile; the CPU runs
    the plain version."""
    pl = tpd.plan(chip_smoke.PROBE_DOT_M, TK, kdim)
    assert pl["k_steps"] == kdim // 64 and pl["smem_bytes"] <= SMEM
    rng = np.random.default_rng(kdim)
    a = torch.from_numpy(rng.standard_normal((1, 512, kdim), np.float32))
    b = torch.from_numpy(rng.standard_normal((1, kdim, TK), np.float32))
    c = mxu_probe.make_dot(kdim, 1)(a, b)
    assert c.shape == (1, 512, TK) and c.dtype == torch.bfloat16


@pytest.mark.parametrize("m,n,k", [(500, 1536, 64), (512, 1408, 64),
                                   (512, 1536, 96), (512, 1536, 32),
                                   (64, 256, 64)])
def test_dot_refuses_shapes_off_its_tile(m, n, k):
    """M off 128, N off 256, K off 64 (or under it) raise on every
    device."""
    a, b = torch.zeros((1, m, k)), torch.zeros((1, k, n))
    with pytest.raises(ValueError, match="multiple of"):
        tpd.probe_dot(a, b)


@pytest.mark.parametrize("btc", [False, True])
def test_forward_wrapper_hands_the_c_entry_its_schedule(
        monkeypatch, cpu_as_cuda, btc):  # noqa: F811
    """On a tensor that reports a CUDA device the wrapper calls the C
    entry once, with the mode, rows, n_sub, n_kb and order indices and
    strides that view both layouts as B*TK rows of H*64 elements."""
    entry = _Entry()
    monkeypatch.setattr(tpf, "_library", lambda: types.SimpleNamespace(
        **{tpf._FN: entry}))
    shape = (2, 256, 4 * 64) if btc else (8, 256, 64)
    q, k, v = (_on_cuda(np.zeros(shape, np.float32)) for _ in range(3))
    before = tpf.launches
    tpf.probe_fwd(q, k, v, 200, mode="noexp", rows=128, n_sub=4, n_kb=2,
                  order="qblock", btc=btc, want_lse=True)
    assert tpf.launches == before + 1
    (n_bh, n_heads, tk, t_valid, mode, rows, n_sub, n_kb, order, s_b, s_h,
     s_t) = entry.args[5:17]
    assert (n_bh, tk, t_valid, mode, rows, n_sub, n_kb, order) == (
        8, 256, 200, 2, 128, 4, 2, 1)
    assert (n_heads, s_h) == ((4, 64) if btc else (1, 0))
    assert s_b == tk * s_t and s_t == (256 if btc else 64)
    assert cpu_as_cuda == [shape, (8, 256)]


def test_every_backward_variant_of_the_sweep_has_a_plan(monkeypatch):
    """All 7 variants map to a built schedule at the probes' TK whose two
    kernels fit the card's shared memory, one CTA an SM; none is refused.
    Their ops and rows are the sweep's: bf16 and f32 at bq256 and bq512,
    f32 on [B, T, H*D] at bq512, 256, 192."""
    calls = _sweep_calls(monkeypatch, "probe_bwd")
    assert len(calls) == 7
    for tag, kw in calls:
        ops, rows = kw.get("ops", "bf16"), kw["rows"]
        assert ops == ("bf16" if tag.endswith("bf16ops") else "f32"), tag
        assert kw.get("btc", False) == tag.startswith("bwd_btc"), tag
        pl = tpb.plan(rows, ops, TK)
        for side in ("dkdv", "dq"):
            assert pl[side]["smem_bytes"] <= SMEM, (tag, side)
            assert TK % pl[side]["tile_rows"] == 0, (tag, side)
        assert pl["ctas_per_sm"] * pl["dkdv"]["smem_bytes"] <= SMEM
    assert {kw["rows"] for _, kw in calls} == set(tpb.ROWS)


@pytest.mark.parametrize("block_q,rows", [(512, 64), (256, 32), (192, 32)])
@pytest.mark.parametrize("ops,passes", [("bf16", (4, 3)), ("f32", (8, 5))])
def test_block_q_maps_to_the_backward_tiles(block_q, rows, ops, passes):
    """block_q -> R, the q rows of the dk/dv kernel's streamed tiles (512
    -> 64, 256 and 192 -> 32), in a ring of 512 rows; the dq kernel streams
    64-row K/V tiles either way. Tensor-core passes per tile: s and dp one
    each, dv and dk (dq) one each in bf16 and three each (hi, mid, lo) in
    f32."""
    assert common.bwd_rows(block_q) == rows
    pl = tpb.plan(rows, ops, TK)
    assert pl["dkdv"]["tile_rows"] == rows
    assert pl["dkdv"]["stages"] == 512 // rows
    assert (pl["dq"]["tile_rows"], pl["dq"]["stages"]) == (64, 8)
    assert (pl["dkdv"]["passes"], pl["dq"]["passes"]) == passes
    assert pl["dkdv"]["resident_rows"] == pl["dq"]["resident_rows"] == 128
    assert (pl["warpgroups"], pl["threads"], pl["launches"]) == (2, 384, 3)


def test_backward_plan_mirrors_the_c_source():
    """The Python plan and the C Sched share their constants and the
    shared-memory sum; every product is a wgmma (the mma.sync and FFMA
    product loops of the first design are gone); the schedules built are
    the plan's rows, each in both modes."""
    src = _c_source("probe_bwd")
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kRes"], consts["kDqTile"], consts["kRingRows"],
            consts["kThreads"]) == (tpb.RESIDENT_ROWS, tpb.DQ_TILE,
                                    tpb.RING_ROWS, tpb.THREADS)
    assert "kStages = kRingRows / BN;" in src
    assert "kStats = DKDV ? 2 * BN * 4 : 0;" in src
    assert "kBytes = kBars + 8 * (4 + 2 * kStages) + 1024;" in src
    assert "constexpr int P = F32 ? 3 : 1;" in src
    assert (tpb.PASSES["bf16"], tpb.PASSES["f32"]) == (1, 3)
    assert '#include "flash_sm90.cuh"' in src
    for gone in ("mma.sync", "mma_16816(", "gemm_f32", "fmaf(av[i], bv[j]"):
        assert gone not in src, gone
    assert "wgmma_rs<kD>" in src and "wgmma_ss<BN>" in src
    assert {int(r) for r in re.findall(r"rows == (\d+)", src)} == \
        set(tpb.ROWS)
    res = consts["kRes"] * 64 * 2
    for rows in tpb.ROWS:
        for tile, stats, side in ((rows, 8 * rows, "dkdv"),
                                  (consts["kDqTile"], 0, "dq")):
            stages = consts["kRingRows"] // tile
            smem = 4 * res + stages * (2 * tile * 64 * 2 + stats) + \
                8 * (4 + 2 * stages) + 1024
            assert tpb.plan(rows, "f32", TK)[side]["smem_bytes"] == smem


@pytest.mark.parametrize("rows,ops,tk,match", [
    (48, "bf16", 1536, "rows 48"), (64, "tf32", 1536, "ops"),
    (64, "f32", 192, "multiple of 128"), (32, "bf16", 1000,
                                          "multiple of 128")])
def test_backward_refuses_what_is_not_built_on_every_device(rows, ops, tk,
                                                            match):
    """rows off the built tiles, an unknown mode, and TK off the 128-row
    work items raise on CPU tensors too."""
    q = torch.zeros((1, tk, 64))
    with pytest.raises(ValueError, match=match):
        tpb.probe_bwd(q, q, q, q, q, torch.zeros((1, tk)), min(tk, 100),
                      ops=ops, rows=rows)


@pytest.mark.parametrize("ops,rows,btc", [("bf16", 64, False),
                                          ("f32", 32, False),
                                          ("f32", 64, True),
                                          ("bf16", 32, True)])
def test_backward_wrapper_hands_the_c_entry_its_schedule(
        monkeypatch, cpu_as_cuda, ops, rows, btc):  # noqa: F811
    """On a tensor that reports a CUDA device the wrapper calls the C
    entry once, with rows, the mode (1 for f32 operands) and strides that
    view both layouts as B*TK rows of H*64 elements, and allocates dq, dk,
    dv and the f32 delta scratch."""
    entry = _Entry()
    monkeypatch.setattr(tpb, "_library", lambda: types.SimpleNamespace(
        **{tpb._FN: entry}))
    shape = (2, 256, 4 * 64) if btc else (8, 256, 64)
    q, k, v, o, do = (_on_cuda(np.zeros(shape, np.float32))
                      for _ in range(5))
    lse = _on_cuda(np.zeros((2, 4, 256) if btc else (8, 256), np.float32),
                   torch.float32)
    before = tpb.launches
    tpb.probe_bwd(q, k, v, o, do, lse, 250, ops=ops, rows=rows, btc=btc)
    assert tpb.launches == before + 1
    (n_bh, n_heads, tk, t_valid, r, f32_ops, s_b, s_h, s_t,
     scale) = entry.args[10:20]
    assert (n_bh, tk, t_valid, r, f32_ops) == (8, 256, 250, rows,
                                               int(ops == "f32"))
    assert (n_heads, s_h) == ((4, 64) if btc else (1, 0))
    assert s_b == tk * s_t and s_t == (256 if btc else 64)
    assert scale == 64 ** -0.5
    assert cpu_as_cuda == [shape] * 3 + [(8, 256)]
