"""Cached self-attention decode steps, each writing its new K/V columns into
the [B, H, Dh, Tmax] cache in place and then attending. The port of the TPU
kernels in ``neuspeech1_tpu/ops/decode_step.py``:

- ``decode_step`` (K7, ``fused_self_decode``): one query per row; the
  cached decoder runs every width-1 step on the greedy and beam caches
  through it. The mask of such a step is the contiguous
  ``position <= cache_index`` rule, so the step needs no mask tensor.
- ``decode_step_multi`` (K8, ``fused_self_decode_multi``): G queries per
  row under an explicit [B or 1, 1, G, Tmax] mask; the cached decoder runs
  every call on the speculative-decode cache (``k_tu``) through it: the
  prompt's prefill and each draft-verify step.

On CUDA tensors each launches its hand-written Hopper kernel
(``csrc/decode_step.cu``, ``csrc/decode_step_multi.cu``), or raises; there is
no fallback. On CPU tensors each runs its plain version, the same function
in plain PyTorch, which is also the gold the kernel is checked against on
the card.

All keep the TPU kernels' rounding points (``_kernel``, ``_kernel_multi``):
the score is accumulated in f32 and rounded once to the cache dtype, then
scaled in f32; masked lanes take -1e30; softmax in f32; the probabilities
are normalised, then rounded to the cache dtype; the PV sum is f32 and
rounded once. The caches are updated in place (the JAX package returns
updated copies through aliased outputs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

MAX_HEAD_DIM = 128
MAX_T = 448  # max_target_positions
# K8: queries per launch, its head dims, and the dynamic shared memory a
# block may use (the H100's 227 KB). Each (row, head) is a cluster of at
# most MAX_CLUSTER CTAs, each holding the scores of its range of columns (a
# multiple of MULTI_TILE), so the speculative cache's Tmax is bounded by
# MAX_CLUSTER ranges in shared memory, not by 448. The plan takes enough
# CTAs that a call runs at least MIN_CTAS, one per SM of the H100's 132
# (two per SM measured slower: each CTA's fixed chain of latencies, not
# the bytes, sets a verify step's time).
MAX_G = 16
MULTI_HEAD_DIMS = (32, 64, 128)
MAX_SMEM_BYTES = 232448
MULTI_TILE = 32
MULTI_STAGES = 4
MAX_CLUSTER = 8
MIN_CTAS = 132
NEG_INF = -1e30  # a masked lane's score, as in the TPU kernel

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that a path went through the kernel): one per wrapper call, K7's
# in ``launches``, K8's in ``multi_launches``.
launches = 0
multi_launches = 0

_NAME = ("decode_step", "nsp_decode_step_bf16")
_MULTI_NAME = ("decode_step_multi", "nsp_decode_step_multi_bf16")
_lib: Optional[ctypes.CDLL] = None
_multi_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel's library; declare its signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_NAME[0])
        fn = getattr(lib, _NAME[1])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 6 + [i32] * 5 + [i64] * 8
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k_new, v_new, k_t, v_t, cache_index: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_step takes q [B, 1, H, Dh]; got "
                         f"{tuple(q.shape)}")
    b, _, h, dh = q.shape
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)} / v_new "
                         f"{tuple(v_new.shape)} differ from q {tuple(q.shape)}")
    if k_t.dim() != 4 or k_t.shape[:3] != (b, h, dh) or v_t.shape != k_t.shape:
        raise ValueError(f"caches must be [B, H, Dh, Tmax] = [{b}, {h}, {dh}, "
                         f"T]; got {tuple(k_t.shape)}, {tuple(v_t.shape)}")
    if not 0 <= cache_index < k_t.shape[3]:
        raise ValueError(f"cache_index {cache_index} outside "
                         f"[0, {k_t.shape[3]})")


def decode_step_plain(q, k_new, v_new, k_t, v_t, cache_index: int):
    """Plain PyTorch version of the kernel: writes k_new, v_new
    [B, 1, H, Dh] into column ``cache_index`` of k_t, v_t [B, H, Dh, Tmax]
    (in place) and returns the context [B, 1, H, Dh] in q's dtype, attending
    columns 0..cache_index."""
    _check(q, k_new, v_new, k_t, v_t, cache_index)
    dt = k_t.dtype
    k_t[..., cache_index] = k_new[:, 0].to(dt)
    v_t[..., cache_index] = v_new[:, 0].to(dt)
    n = cache_index + 1
    s = torch.einsum("bhd,bhdt->bht", q[:, 0].float(), k_t[..., :n].float())
    s = s.to(dt).float() * q.shape[3] ** -0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    ctx = torch.einsum("bht,bhdt->bhd", probs.float(), v_t[..., :n].float())
    return ctx.to(q.dtype)[:, None]


def _decode_step_cuda(q, k_new, v_new, k_t, v_t, cache_index: int):
    global launches
    b, _, h, dh = q.shape
    t_max = k_t.shape[3]
    if dh > MAX_HEAD_DIM or t_max > MAX_T:
        raise ValueError(f"decode_step kernel takes Dh <= {MAX_HEAD_DIM} and "
                         f"Tmax <= {MAX_T}; got Dh {dh}, Tmax {t_max}")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_t", k_t), ("v_t", v_t)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"decode_step kernel takes bfloat16; {name} is "
                             f"{x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    if not (k_t.is_contiguous() and v_t.is_contiguous()):
        raise ValueError("the caches must be contiguous: they are updated "
                         "in place")
    fn = getattr(_library(), _NAME[1])
    ctx = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_t.data_ptr(), v_t.data_ptr(), ctx.data_ptr(), b, h, dh,
                 t_max, cache_index, q.stride(0), q.stride(2),
                 k_new.stride(0), k_new.stride(2), v_new.stride(0),
                 v_new.stride(2), ctx.stride(0), ctx.stride(2), dh ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step launch failed: CUDA error {err}")
    launches += 1
    return ctx


def decode_step(q, k_new, v_new, k_t, v_t, cache_index: int):
    """One decode step of cached self-attention: q, k_new, v_new
    [B, 1, H, Dh]; k_t, v_t [B, H, Dh, Tmax], updated in place at column
    ``cache_index``; returns the context [B, 1, H, Dh], attending columns
    0..cache_index. CPU tensors run the plain version; CUDA tensors launch
    the kernel (bfloat16, Dh <= 128, Tmax <= 448) or raise."""
    _check(q, k_new, v_new, k_t, v_t, cache_index)
    if q.device.type == "cpu":
        return decode_step_plain(q, k_new, v_new, k_t, v_t, cache_index)
    if not q.is_cuda:
        raise ValueError(f"decode_step: unsupported device {q.device}")
    return _decode_step_cuda(q, k_new, v_new, k_t, v_t, cache_index)


def _multi_library() -> ctypes.CDLL:
    """Build and load K8's library; declare its signature."""
    global _multi_lib
    if _multi_lib is None:
        lib = _build.load(_MULTI_NAME[0])
        fn = getattr(lib, _MULTI_NAME[1])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 7 + [i32] * 8 + [i64] * 14
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _multi_lib = lib
    return _multi_lib


def _check_multi(q, k_new, v_new, mask, k_t, v_t, cache_index: int) -> None:
    if q.dim() != 4:
        raise ValueError(f"decode_step_multi takes q [B, G, H, Dh]; got "
                         f"{tuple(q.shape)}")
    b, g, h, dh = q.shape
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)} / v_new "
                         f"{tuple(v_new.shape)} differ from q {tuple(q.shape)}")
    if k_t.dim() != 4 or k_t.shape[:3] != (b, h, dh) or v_t.shape != k_t.shape:
        raise ValueError(f"caches must be [B, H, Dh, Tmax] = [{b}, {h}, {dh}, "
                         f"T]; got {tuple(k_t.shape)}, {tuple(v_t.shape)}")
    t_max = k_t.shape[3]
    if (mask.dtype != torch.bool or mask.dim() != 4
            or mask.shape[0] not in (1, b) or mask.shape[1:] != (1, g, t_max)):
        raise ValueError(f"mask must be bool [B or 1, 1, G, Tmax] = [{b} or "
                         f"1, 1, {g}, {t_max}]; got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not 0 <= cache_index <= t_max - g:
        raise ValueError(f"cache_index {cache_index}: columns {cache_index}.."
                         f"{cache_index + g - 1} outside [0, {t_max})")


def decode_step_multi_plain(q, k_new, v_new, mask, k_t, v_t,
                            cache_index: int):
    """Plain PyTorch version of K8: writes k_new, v_new [B, G, H, Dh] into
    columns ``cache_index .. cache_index + G - 1`` of k_t, v_t
    [B, H, Dh, Tmax] (in place), then attends each query i over the columns
    ``mask[:, 0, i]`` allows; returns the context [B, G, H, Dh] in q's
    dtype."""
    _check_multi(q, k_new, v_new, mask, k_t, v_t, cache_index)
    dt = k_t.dtype
    cols = slice(cache_index, cache_index + q.shape[1])
    k_t[..., cols] = k_new.permute(0, 2, 3, 1).to(dt)
    v_t[..., cols] = v_new.permute(0, 2, 3, 1).to(dt)
    s = torch.einsum("bghd,bhdt->bhgt", q.float(), k_t.float())
    s = s.to(dt).float() * q.shape[3] ** -0.5
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    ctx = torch.einsum("bhgt,bhdt->bghd", probs.float(), v_t.float())
    return ctx.to(q.dtype)


def multi_smem_bytes(g: int, head_dim: int, cols: int) -> int:
    """K8's dynamic shared memory per CTA (``csrc/decode_step_multi.cu::
    smem_bytes``, in its layout's order): the ring of [Dh, 32] tiles, q
    padded to 16 rows, the new K/V columns, the G x cols f32 scores, p
    [16, cols + 8] bf16, the mask's bit words and tile list, the row
    values."""
    return (MULTI_STAGES * head_dim * 64 + 32 * head_dim + 4 * g * head_dim
            + 4 * g * cols + 32 * cols + 256
            + 4 * (g + 2) * (cols // MULTI_TILE) + 528)


@functools.lru_cache(maxsize=256)
def multi_plan(rows: int, heads: int, g: int, head_dim: int, t_max: int):
    """(cluster, cols) of one K8 launch: each (row, head) is a cluster of
    ``cluster`` CTAs, CTA r taking the columns [r * cols, (r + 1) * cols)
    below Tmax, cols a multiple of MULTI_TILE. The cluster doubles, up to
    MAX_CLUSTER, while the call has fewer than MIN_CTAS CTAs or a range's
    scores overflow shared memory, and a range would keep more than one
    tile. Raises ValueError where MAX_CLUSTER ranges still overflow it."""
    cluster = 1
    while True:
        cols = MULTI_TILE * -(-t_max // (cluster * MULTI_TILE))
        fits = multi_smem_bytes(g, head_dim, cols) <= MAX_SMEM_BYTES
        if (fits and rows * heads * cluster >= MIN_CTAS) \
                or cluster == MAX_CLUSTER or cols <= MULTI_TILE:
            break
        cluster *= 2
    if not fits:
        raise ValueError(
            f"decode_step_multi kernel: G {g} x Tmax {t_max} scores over "
            f"{cluster} CTAs need {multi_smem_bytes(g, head_dim, cols)} "
            f"bytes of shared memory each, more than {MAX_SMEM_BYTES}")
    return cluster, cols


def _decode_step_multi_cuda(q, k_new, v_new, mask, k_t, v_t,
                            cache_index: int):
    global multi_launches
    b, g, h, dh = q.shape
    t_max = k_t.shape[3]
    if g > MAX_G or dh not in MULTI_HEAD_DIMS:
        raise ValueError(f"decode_step_multi kernel takes G <= {MAX_G} "
                         f"queries and Dh <= {MAX_HEAD_DIM} in "
                         f"{MULTI_HEAD_DIMS}; got G {g}, Dh {dh}")
    cluster, cols = multi_plan(b, h, g, dh, t_max)
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_t", k_t), ("v_t", v_t)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"decode_step_multi kernel takes bfloat16; "
                             f"{name} is {x.dtype}")
    for name, x in (("k_new", k_new), ("v_new", v_new), ("mask", mask),
                    ("k_t", k_t), ("v_t", v_t)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    if not (k_t.is_contiguous() and v_t.is_contiguous()):
        raise ValueError("the caches must be contiguous: they are updated "
                         "in place")
    if k_t.data_ptr() % 16 or v_t.data_ptr() % 16:
        raise ValueError("the caches must start 16-byte aligned")
    m = mask[:, 0]  # [B or 1, G, Tmax]; a broadcast row has stride 0
    if m.stride(2) != 1:
        raise ValueError("mask must be contiguous along Tmax")
    m_sb = 0 if m.shape[0] == 1 else m.stride(0)
    fn = getattr(_multi_library(), _MULTI_NAME[1])
    ctx = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 m.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), ctx.data_ptr(),
                 b, g, h, dh, t_max, cache_index, cluster, cols,
                 *q.stride()[:3], *k_new.stride()[:3], *v_new.stride()[:3],
                 *ctx.stride()[:3], m_sb, m.stride(1), dh ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step_multi launch failed: CUDA error "
                           f"{err}")
    multi_launches += 1
    return ctx


def decode_step_multi(q, k_new, v_new, mask, k_t, v_t, cache_index: int):
    """G queries of cached self-attention in one step: q, k_new, v_new
    [B, G, H, Dh]; mask [B or 1, 1, G, Tmax] bool, query i's allowed
    columns (the caller's mask excludes the block's columns past i and any
    holes); k_t, v_t [B, H, Dh, Tmax], updated in place at columns
    ``cache_index .. cache_index + G - 1``; returns the context
    [B, G, H, Dh]. CPU tensors run the plain version; CUDA tensors launch
    the kernel (bfloat16, G <= 16, Dh 32, 64 or 128, the G x Tmax scores
    within the shared memory of MAX_CLUSTER CTAs; ``multi_plan``) or raise.
    A query whose mask allows no column gets a context of 0 from the
    kernel (the plain version averages every column)."""
    _check_multi(q, k_new, v_new, mask, k_t, v_t, cache_index)
    if q.device.type == "cpu":
        return decode_step_multi_plain(q, k_new, v_new, mask, k_t, v_t,
                                       cache_index)
    if not q.is_cuda:
        raise ValueError(f"decode_step_multi: unsupported device {q.device}")
    return _decode_step_multi_cuda(q, k_new, v_new, mask, k_t, v_t,
                                   cache_index)
