"""Decode cross-attention (K6): a few query rows of the cached decoder
against the whole encoder K/V cache. The port of the TPU kernels
``neuspeech1_tpu/ops/flash_attention.py::flash_decode_cross`` (cache
[B, H, T, D]) and ``::flash_decode_cross_btc`` (cache [B, T, H*D]).

On CUDA tensors both entries launch the hand-written Hopper kernel in
``csrc/decode_cross.cu`` (one code for both layouts: it reads the cache
through its strides), or raise; there is no fallback. On CPU tensors they
run ``decode_cross_plain``, the same function in plain PyTorch, which is
also the gold the kernel is checked against on the card.

Both keep the TPU kernel's rounding points (``_decode_cross_kernel``):
scores stay f32 with no rounding, the unnormalised ``exp(s - max)`` is
rounded to the value dtype before the PV product, and the f32 PV sum is
divided by the f32 row sum at the end. (The TPU's btc kernel also rounded
each q*k product to bf16 before summing, an artefact of its VPU form; the
port does not.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)
MAX_TQ = 64
# The kernel's plan (csrc/decode_cross.cu): a CTA takes up to GROUP_ROWS
# query rows and a range of cache rows, a multiple of CHUNK_ROWS; the CTAs
# of one (batch, head, query group) form a cluster of at most MAX_CLUSTER,
# enough of them that a call runs at least MIN_CTAS CTAs (one per SM of the
# H100's 132), counting a CTA of two m16 tiles of query rows (16 warps, all
# of an SM's registers) as two, where the cache is long enough. (Two per SM
# measured slower at every small case: longer ranges per CTA and smaller
# clusters cost less than the merge of more splits.)
GROUP_ROWS = 32
CHUNK_ROWS = 16
MAX_CLUSTER = 8
MIN_CTAS = 132

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that a path went through the kernel): one per chunk of at most
# MAX_TQ query rows.
launches = 0

_NAME = ("decode_cross", "nsp_decode_cross_bf16")
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel's library; declare its signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_NAME[0])
        fn = getattr(lib, _NAME[1])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 4 + [i32] * 7 + [i64] * 12
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def plan(batch: int, heads: int, t_q: int, kv_len: int):
    """(cluster, rows_per_split, query groups) of one launch: each
    (batch, head, group of GROUP_ROWS query rows) is a cluster of
    ``cluster`` CTAs, CTA r taking the cache rows [r * rows_per_split,
    (r + 1) * rows_per_split) below kv_len. The cluster doubles, up to
    MAX_CLUSTER, until the call has MIN_CTAS CTAs (a CTA of more than 16
    query rows counting twice) or a CTA's range would fall to one chunk of
    CHUNK_ROWS rows."""
    groups = -(-t_q // GROUP_ROWS)
    weight = 1 if t_q <= 16 else 2  # SMs a CTA fills
    cluster = 1
    while (cluster < MAX_CLUSTER and batch * heads * groups * cluster
           * weight < MIN_CTAS and 2 * cluster * CHUNK_ROWS < kv_len):
        cluster *= 2
    rows = CHUNK_ROWS * -(-kv_len // (cluster * CHUNK_ROWS))
    return cluster, rows, groups


def _check(q, k, v, kv_len: Optional[int]) -> int:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_cross takes q [B, Tq, H, D] and k, v "
                         "[B, H, T, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    t = k.shape[2]
    kv_len = t if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len={kv_len} outside [1, {t}]")
    return kv_len


def decode_cross_plain(q, k, v, kv_len: Optional[int] = None):
    """Plain PyTorch version of the kernel: q [B, Tq, H, D] against k, v
    [B, H, T, D] (any strides), cache rows at or past ``kv_len`` masked ->
    [B, Tq, H, D] in q's dtype. Scores come from f32 copies of q and k (a
    product of two bf16 values is exact in f32, as in the kernel)."""
    kv_len = _check(q, k, v, kv_len)
    d = q.shape[3]
    k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    s = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).transpose(1, 2)[..., None]          # [B, Tq, H, 1]
    o = torch.einsum("bhqk,bhkd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def _check_cuda_operand(name: str, x, device, align: int) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"decode_cross kernel takes bfloat16; {name} is "
                         f"{x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, q on {device}")
    elems = align // 2
    if x.stride(3) != 1 or any(s % elems for s in x.stride()[:3]) \
            or x.data_ptr() % align:
        raise ValueError(
            f"{name} must have a contiguous head dim and {align}-byte "
            f"aligned rows; strides {x.stride()}")


def _decode_cross_cuda(q, k, v, kv_len: int):
    global launches
    b, t_q, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_cross kernel head dim {d} not in {HEAD_DIMS}")
    _check_cuda_operand("q", q, q.device, 4)
    for name, x in (("k", k), ("v", v)):
        _check_cuda_operand(name, x, q.device, 16)
    fn = getattr(_library(), _NAME[1])
    cluster, rows, _ = plan(b, h, t_q, kv_len)
    o = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    # the C entry launches on the current device: make it q's
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, h, t_q, kv_len, d, cluster, rows, *q.stride()[:3],
                 k.stride(0), k.stride(2), k.stride(1),
                 v.stride(0), v.stride(2), v.stride(1),
                 *o.stride()[:3], d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_cross launch failed: CUDA error {err}")
    launches += 1
    return o


def decode_cross(q, k, v, kv_len: Optional[int] = None):
    """Cross-attention of q [B, Tq, H, D] over the cache k, v [B, H, T, D],
    rows at or past ``kv_len`` masked; returns [B, Tq, H, D] in q's dtype.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (bfloat16, D in ``HEAD_DIMS``) or raise. The kernel holds at most
    ``MAX_TQ`` query rows: a longer query (a beam prefill with
    num_beams * prompt length > 64) runs in chunks, one launch each."""
    kv_len = _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_cross_plain(q, k, v, kv_len)
    if not q.is_cuda:
        raise ValueError(f"decode_cross: unsupported device {q.device}")
    chunks = [_decode_cross_cuda(q[:, i:i + MAX_TQ], k, v, kv_len)
              for i in range(0, q.shape[1], MAX_TQ)]
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)


def decode_cross_btc(q, k, v, kv_len: Optional[int] = None):
    """The [B, T, H*D] cache entry (the JAX package's
    ``flash_decode_cross_btc``): q [B, 1, H, D], k, v [B, Tpad, H*D] with
    rows at or past ``kv_len`` masked. The same kernel reads the
    [B, H, Tpad, D] view through its strides; nothing is copied."""
    b, t_q, h, d = q.shape
    if t_q != 1 or k.dim() != 3 or k.shape[2] != h * d:
        raise ValueError(f"decode_cross_btc takes q [B, 1, H, D] and k, v "
                         f"[B, T, H*D]; got {tuple(q.shape)}, {tuple(k.shape)}")

    def bhtd(x):
        return x.view(b, x.shape[1], h, d).transpose(1, 2)

    return decode_cross(q, bhtd(k), bhtd(v), kv_len)
