"""One cached self-attention decode step (K7): the new K/V column written
into the cache in place, then attention over the columns up to it. The port
of the TPU kernel ``neuspeech1_tpu/ops/decode_step.py::fused_self_decode``.

The cached decoder runs every width-1 step through it: the mask of such a
step is the contiguous ``position <= cache_index`` rule, so the step needs
no mask tensor. On CUDA tensors ``decode_step`` launches the hand-written
Hopper kernel in ``csrc/decode_step.cu``, or raises; there is no fallback.
On CPU tensors it runs ``decode_step_plain``, the same function in plain
PyTorch, which is also the gold the kernel is checked against on the card.

Both keep the TPU kernel's rounding points (``_kernel``): the score is
accumulated in f32 and rounded once to the cache dtype, then scaled in f32;
softmax in f32 over the columns ``t <= cache_index``; the probabilities are
normalised, then rounded to the cache dtype; the PV sum is f32 and rounded
once. The cache is updated in place (the JAX package returns updated
copies through aliased outputs).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

MAX_HEAD_DIM = 128
MAX_T = 448  # max_target_positions

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that a path went through the kernel): one per wrapper call.
launches = 0

_NAME = ("decode_step", "nsp_decode_step_bf16")
_lib: Optional[ctypes.CDLL] = None


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
