"""Grouped GEMM of a mixture-of-experts layer: the rows of ``x``, sorted by
expert, each times its expert's weight,

    y[offs[e]:offs[e+1]] = x[offs[e]:offs[e+1]] @ w[e]      (trans_w False)
    y[offs[e]:offs[e+1]] = x[offs[e]:offs[e+1]] @ w[e].T    (trans_w True)

with ``w`` [E, K, N] in the forward and the same tensor read as [E, N, K]
for the input gradient. Products accumulate in f32 and round to the input
dtype. Groups may be empty and of any size.

On CUDA tensors `grouped_gemm` launches the Hopper kernel of
``csrc/moe_grouped_gemm.cu`` (persistent CTAs, a TMA ring, wgmma, the work
list read from ``offs`` on the device, so the host never waits for the
routing) or raises; on CPU tensors it runs `grouped_gemm_plain`, a loop
over the experts, which is also the kernel's gold on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

TILE_M, TILE_K = 128, 64  # csrc/moe_grouped_gemm.cu kBM, kBK (tiles 128 x 256)
MAX_EXPERTS = 256                      # kMaxExperts

# Kernel launches since the count was last set to 0, one per wrapper call.
launches = 0

_SOURCE, _FN = "moe_grouped_gemm", "nsp_moe_grouped_gemm_bf16"
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel library and declare its C signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        fn = getattr(lib, _FN)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def output_width(w, trans_w: bool) -> int:
    return w.shape[1] if trans_w else w.shape[2]


def _check(x, w, offs, trans_w: bool):
    k = w.shape[2] if trans_w else w.shape[1]
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != k:
        raise ValueError(
            f"grouped_gemm takes x [R, K] and w [E, {'N, K' if trans_w else 'K, N'}]"
            f"; got {tuple(x.shape)} and {tuple(w.shape)}")
    if offs.dim() != 1 or offs.shape[0] != w.shape[0] + 1:
        raise ValueError(f"offs holds E + 1 = {w.shape[0] + 1} row offsets; "
                         f"got {tuple(offs.shape)}")


def check_shapes(rows: int, k: int, n: int, experts: int) -> None:
    """The kernel's limits: K a multiple of 64, N of 128, 1..256 experts."""
    if k % TILE_K or n % 128 or not 1 <= experts <= MAX_EXPERTS:
        raise ValueError(
            f"the grouped GEMM kernel takes K a multiple of {TILE_K}, N of "
            f"128 and 1 to {MAX_EXPERTS} experts; got K={k}, N={n}, "
            f"E={experts}")


def grouped_gemm_plain(x, w, offs, trans_w: bool = False):
    """Plain PyTorch version: one product per expert, in f32, rounded to
    ``x.dtype``."""
    _check(x, w, offs, trans_w)
    y = x.new_zeros((x.shape[0], output_width(w, trans_w)))
    bounds = offs.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            we = w[e].float()
            y[lo:hi] = (x[lo:hi].float() @ (we.T if trans_w else we)).to(
                x.dtype)
    return y


def _grouped_gemm_cuda(x, w, offs, trans_w: bool):
    global launches
    rows, k = x.shape
    n = output_width(w, trans_w)
    check_shapes(rows, k, n, w.shape[0])
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"grouped_gemm takes contiguous bfloat16 on one "
                             f"device; {name} is {t.dtype} on {t.device}")
    if offs.dtype != torch.int32 or offs.device != x.device \
            or not offs.is_contiguous():
        raise ValueError("grouped_gemm takes offs as contiguous int32 on x's "
                         "device")
    y = torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
    if rows == 0:
        return y
    if rows < TILE_M:
        # the row map spans at least one tile's box; the padded rows lie
        # past offs[E] and are never written
        x = torch.nn.functional.pad(x, (0, 0, 0, TILE_M - rows))
    fn = getattr(_library(), _FN)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), offs.data_ptr(), y.data_ptr(),
                 x.shape[0], k, n, w.shape[0], int(trans_w),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm launch failed: CUDA error {err}")
    launches += 1
    return y


def grouped_gemm(x, w, offs, trans_w: bool = False):
    """x [R, K] (rows sorted by expert) times each row's expert's ``w``
    [E, K, N] (or, ``trans_w``, the transpose of each [N, K]) -> [R, N];
    ``offs`` int32 [E + 1], expert e's rows at offs[e]..offs[e+1]. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(x, w, offs, trans_w)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, offs, trans_w)
    if not x.is_cuda:
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    return _grouped_gemm_cuda(x, w, offs, trans_w)
