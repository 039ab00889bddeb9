"""The decode kernels' launch plans, pure functions of the shapes: how K6
(``ops/decode_cross.py::plan``) and K8 (``ops/decode_step.py::
multi_plan``) split each (batch, head) over a cluster of CTAs, K8's shared
memory against the layout in ``csrc/decode_step_multi.cu``, and what a
wrapper allocates per call (followed on a CPU tensor that reports a CUDA
device, up to the kernel's C entry)."""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
from neuspeech1_tpu_torch.ops import _build
from neuspeech1_tpu_torch.ops import decode_cross as tdc
from neuspeech1_tpu_torch.ops import decode_step as tds
from tests.test_torch_flash_attention import _OnCuda, _on_cuda

H = chip_smoke.DECODE_HEADS
DH = chip_smoke.DECODE_HEAD_DIM


def _ranges(cluster: int, size: int, end: int):
    """The [begin, end) of each CTA of a cluster, ranges of ``size`` cut at
    ``end`` (a CTA past the end gets an empty range)."""
    return [(min(r * size, end), min((r + 1) * size, end))
            for r in range(cluster)]


def _covers_once(ranges, end: int) -> bool:
    """Whether the ranges, in order, tile [0, end) with no gap or overlap."""
    pos = 0
    for begin, stop in ranges:
        if begin != pos or stop < begin:
            return False
        pos = stop
    return pos == end


CROSS_SHAPES = [(b, 1 if t_q > tdc.MAX_TQ else t_q, kv_len or t)
                for _, b, t_q, t, kv_len, _ in chip_smoke.DECODE_CROSS_CASES]
CROSS_EDGES = [(1, 1, 1), (2, 1, 17), (2, 64, 191), (2, 65, 193),
               (3, 5, 100), (1, 33, 1537), (64, 4, 1499), (128, 1, 4096)]


@pytest.mark.parametrize("b,t_q,kv_len", CROSS_SHAPES + CROSS_EDGES)
def test_decode_cross_plan_covers_the_cache_once(b, t_q, kv_len):
    """K6: the CTAs' row ranges tile [0, kv_len) once, in rank order, in
    whole 16-row chunks; the cluster is a power of two of at most 8; the
    query groups hold every query row."""
    cluster, rows, groups = tdc.plan(b, H, min(t_q, tdc.MAX_TQ), kv_len)
    assert cluster in (1, 2, 4, 8) and cluster <= tdc.MAX_CLUSTER
    assert rows % tdc.CHUNK_ROWS == 0 and rows > 0
    assert _covers_once(_ranges(cluster, rows, kv_len), kv_len)
    assert (groups - 1) * tdc.GROUP_ROWS < min(t_q, tdc.MAX_TQ) \
        <= groups * tdc.GROUP_ROWS


@pytest.mark.parametrize("case", chip_smoke.DECODE_CROSS_CASES,
                         ids=lambda c: c[0])
def test_decode_cross_plan_fills_the_card(case):
    """K6 at every chip_smoke case fills every SM of the H100's 132 at
    least once (the plan's MIN_CTAS; two CTAs per SM measured slower on the
    card, PERF.md)."""
    _, b, t_q, t, kv_len, _ = case
    cluster, _, groups = tdc.plan(b, H, t_q, kv_len or t)
    weight = 1 if t_q <= 16 else 2  # a CTA of two m16 tiles fills an SM
    assert tdc.MIN_CTAS >= 132
    assert b * H * groups * cluster * weight >= tdc.MIN_CTAS


MULTI_SHAPES = [(rows, g, t_max)
                for _, rows, g, t_max, _, _ in
                chip_smoke.DECODE_STEP_MULTI_CASES]
MULTI_EDGES = [(1, 1, 20), (5, 2, 20), (4, 1, 50), (3, 8, 3556),
               (2, 16, 3247), (2, 16, 3248), (1, 16, 8000), (16, 4, 517),
               (64, 4, 1024)]


@pytest.mark.parametrize("rows,g,t_max", MULTI_SHAPES + MULTI_EDGES)
def test_decode_step_multi_plan_covers_the_cache_once(rows, g, t_max):
    """K8: the CTAs' column ranges tile [0, Tmax) once, in rank order, in
    whole 32-column tiles; the cluster is a power of two of at most 8; each
    CTA's shared memory fits the H100's block."""
    cluster, cols = tds.multi_plan(rows, H, g, DH, t_max)
    assert cluster in (1, 2, 4, 8) and cluster <= tds.MAX_CLUSTER
    assert cols % tds.MULTI_TILE == 0 and cols > 0
    assert _covers_once(_ranges(cluster, cols, t_max), t_max)
    assert tds.multi_smem_bytes(g, DH, cols) <= tds.MAX_SMEM_BYTES


@pytest.mark.parametrize("case", chip_smoke.DECODE_STEP_MULTI_CASES,
                         ids=lambda c: c[0])
def test_decode_step_multi_plan_fills_the_card(case):
    """K8 at every chip_smoke case launches at least one CTA per SM of the
    H100's 132 (the plan's MIN_CTAS; two per SM measured slower on the
    card, PERF.md)."""
    _, rows, g, t_max, _, _ = case
    cluster, _ = tds.multi_plan(rows, H, g, DH, t_max)
    assert tds.MIN_CTAS >= 132
    assert rows * H * cluster >= tds.MIN_CTAS


def _c_smem_bytes():
    """``smem_bytes`` of csrc/decode_step_multi.cu as a Python function of
    (g, dh, cols), with the source's integer constants."""
    src = (_build.SRC_DIR / "decode_step_multi.cu").read_text()
    consts = {n: int(v) for n, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"smem_bytes\(long long g, long long dh,\s*long long "
                     r"cols\) \{\s*return (.*?);\s*\}", src, re.S)
    expr = " ".join(body.group(1).split()).replace("/", "//")
    return lambda g, dh, cols: eval(expr, {}, {**consts, "g": g, "dh": dh,
                                               "cols": cols})


@pytest.mark.parametrize("g,dh,cols", [(1, 32, 32), (4, 64, 160),
                                       (16, 128, 1024), (5, 64, 448),
                                       (16, 64, 2016)])
def test_multi_smem_bytes_matches_the_c_source(g, dh, cols):
    """The wrapper's shared-memory formula, which picks the plan and
    rejects a Tmax too long, is the C source's, term for term."""
    assert tds.MULTI_STAGES == int(re.search(
        r"constexpr int kStages = (\d+);",
        (_build.SRC_DIR / "decode_step_multi.cu").read_text()).group(1))
    assert tds.multi_smem_bytes(g, dh, cols) == _c_smem_bytes()(g, dh, cols)


class _Entry:
    """A stand-in for a kernel library's C entry: records its arguments
    and reports success."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def cpu_as_cuda(monkeypatch):
    """Lets a wrapper's CUDA branch run on CPU tensors that report a CUDA
    device: allocations land on the CPU and are counted; the device and
    stream lookups are stubs."""
    made = []

    def counted(fn):
        def alloc(*args, **kw):
            kw.pop("device", None)
            if "memory_format" in kw and args and isinstance(args[0],
                                                             torch.Tensor):
                args = (args[0].as_subclass(torch.Tensor),) + args[1:]
            x = fn(*args, **kw)
            made.append(tuple(x.shape))
            return x
        return alloc

    for name in ("empty", "empty_like", "zeros", "zeros_like", "ones"):
        monkeypatch.setattr(torch, name, counted(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return made


def test_decode_cross_allocates_only_its_output(monkeypatch, cpu_as_cuda):
    """K6 merges its CTAs through distributed shared memory: a call
    allocates its output and nothing else (no f32 scratch), and passes the
    plan's cluster and split to the kernel."""
    entry = _Entry()
    monkeypatch.setattr(tdc, "_library", lambda: types.SimpleNamespace(
        **{tdc._NAME[1]: entry}))
    rng = np.random.default_rng(21)
    b, t_q, h, d, t = 16, 5, 8, 64, 1500
    q = _on_cuda(rng.standard_normal((b, t_q, h, d)))
    k, v = (_on_cuda(rng.standard_normal((b, h, t, d))) for _ in range(2))
    before = tdc.launches
    o = tdc.decode_cross(q, k, v)
    assert tdc.launches == before + 1
    assert cpu_as_cuda == [(b, t_q, h, d)] and tuple(o.shape) == (b, t_q, h, d)
    cluster, rows, _ = tdc.plan(b, h, t_q, t)
    assert entry.args[4:11] == (b, h, t_q, t, d, cluster, rows)


def test_decode_step_multi_allocates_only_its_output(monkeypatch,
                                                     cpu_as_cuda):
    """K8 allocates its context and nothing else per call, and passes the
    plan's cluster and column range to the kernel."""
    entry = _Entry()
    monkeypatch.setattr(tds, "_multi_library", lambda: types.SimpleNamespace(
        **{tds._MULTI_NAME[1]: entry}))
    rng = np.random.default_rng(22)
    rows, g, h, dh, t_max, idx = 16, 4, 8, 64, 516, 300
    q, kn, vn = (_on_cuda(rng.standard_normal((rows, g, h, dh)))
                 for _ in range(3))
    k_t, v_t = (_on_cuda(rng.standard_normal((rows, h, dh, t_max)))
                for _ in range(2))
    mask = torch.ones((rows, 1, g, t_max), dtype=torch.bool)
    cpu_as_cuda.clear()
    mask = mask.as_subclass(_OnCuda)
    before = tds.multi_launches
    ctx = tds.decode_step_multi(q, kn, vn, mask, k_t, v_t, idx)
    assert tds.multi_launches == before + 1
    assert cpu_as_cuda == [(rows, g, h, dh)]
    assert tuple(ctx.shape) == (rows, g, h, dh)
    cluster, cols = tds.multi_plan(rows, h, g, dh, t_max)
    assert entry.args[7:15] == (rows, g, h, dh, t_max, idx, cluster, cols)
