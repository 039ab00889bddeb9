"""Batched dot probe: the port of the TPU matrix-unit rate probe
``perf/mxu_probe.py::make_dot``: c[g] = a[g] @ b[g] for a [n, M, K] and
b [n, K, N], products accumulated in f32, c rounded to bfloat16.

On CUDA tensors `probe_dot` launches the Hopper kernel of
``csrc/probe_dot.cu`` (persistent CTAs, a TMA ring, wgmma, TMA stores;
128 x 256 output tiles, 64-deep stages) or raises; on CPU tensors it runs
`probe_dot_plain`, also the kernel's gold on the card. The tile is checked
on every device, so that a shape the card cannot run fails on the CPU too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

TILE_M, TILE_N, TILE_K = 128, 256, 64  # csrc/probe_dot.cu kBM, kBN, kBK
STAGES = 3                             # kStages

# Kernel launches since the count was last set to 0, one per wrapper call.
launches = 0

_SOURCE, _FN = "probe_dot", "nsp_probe_dot_bf16"
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel library and declare its C signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        fn = getattr(lib, _FN)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(a, b):
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"probe_dot takes a [n, M, K] and b [n, K, N]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def plan(m: int, n: int, k: int) -> dict:
    """The kernel's tiling of [M, K] @ [K, N] (csrc/probe_dot.cu): the
    output tile, the k-stages of one tile, the ring's stages, threads and
    dynamic shared memory (the stages of A [128, 64] and B [64, 256], two
    [64, 256] staging buffers for the TMA stores, a full and an empty
    mbarrier per stage, 1 KB of alignment). Raises for M, N or K off the
    tile."""
    if m % TILE_M or n % TILE_N or k % TILE_K or k < TILE_K:
        raise ValueError(f"probe_dot takes M a multiple of {TILE_M}, N of "
                         f"{TILE_N} and K of {TILE_K}; got {m}, {n}, {k}")
    stage = (TILE_M + TILE_N) * TILE_K * 2
    smem = STAGES * stage + 2 * 64 * TILE_N * 2 + 16 * STAGES + 1024
    return {"tile": (TILE_M, TILE_N, TILE_K), "k_steps": k // TILE_K,
            "stages": STAGES, "threads": 384, "smem_bytes": smem}


def probe_dot_plain(a, b):
    """Plain PyTorch version: bf16 [n, M, N] from an f32 product of the
    inputs' values."""
    _check(a, b)
    return torch.bmm(a.float(), b.float()).to(torch.bfloat16)


def _probe_dot_cuda(a, b):
    global launches
    n, m, k = a.shape
    width = b.shape[2]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or t.device != a.device \
                or not t.is_contiguous():
            raise ValueError(f"probe_dot takes contiguous bfloat16 on one "
                             f"device; {name} is {t.dtype} on {t.device}")
    c = torch.empty((n, m, width), dtype=torch.bfloat16, device=a.device)
    fn = getattr(_library(), _FN)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, m, width, k,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_dot launch failed: CUDA error {err}")
    launches += 1
    return c


def probe_dot(a, b):
    """a [n, M, K] @ b [n, K, N] -> bf16 [n, M, N]. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise. M, N and K off
    the kernel's tile raise on every device."""
    _check(a, b)
    plan(a.shape[1], b.shape[2], a.shape[2])
    if a.device.type == "cpu":
        return probe_dot_plain(a, b)
    if not a.is_cuda:
        raise ValueError(f"probe_dot: unsupported device {a.device}")
    return _probe_dot_cuda(a, b)
