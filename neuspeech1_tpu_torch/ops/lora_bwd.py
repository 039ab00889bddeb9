"""LoRA fc adapter backward: the port of the TPU kernel
``neuspeech1_tpu/ops/lora_bwd.py::_kernel`` (entry ``lora_adapter_bwd``).

From the activations of one adapted matmul it computes the rank-r products
the adapter gradients need, with the TPU kernel's rounding points:

    t1 = dy B^T, u = x A          (f32)
    dA_raw = x^T cast(t1)         (cast to x's dtype first)
    dB_raw = cast(u)^T dy         (cast to dy's dtype first)
    dE_raw = sum_n u * t1         (from the f32 t1 and u)

On a CUDA tensor ``lora_adapter_bwd`` launches the hand-written Hopper kernel
in ``csrc/lora_bwd.cu`` or raises; it takes any token count N (the JAX
package's shape gate ``pick_block_n``, which sends N not divisible by the
block to an einsum path, has no counterpart on the card). On a CPU tensor it
runs ``lora_adapter_bwd_plain``, also the kernel's gold on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

MAX_RANK = 64
_TOK_TILE = 64    # tokens per dE partial (csrc/lora_bwd.cu kTokTile)
_CHUNK = 2048     # tokens per dA / dB partial (kChunk)

# Kernel launches since the count was last set to 0, one per wrapper call.
launches = 0

_SOURCE, _FN = "lora_bwd", "nsp_lora_bwd_bf16"
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel library and declare its C signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        fn = getattr(lib, _FN)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * 9
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x2, dy2, a, b):
    if x2.dim() != 2 or dy2.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("lora_adapter_bwd takes x [N, din], dy [N, dout], "
                         "A [din, r], B [r, dout]")
    n, din = x2.shape
    r = a.shape[1]
    dout = dy2.shape[1]
    if dy2.shape[0] != n or a.shape[0] != din or tuple(b.shape) != (r, dout):
        raise ValueError(f"shape mismatch: x {tuple(x2.shape)}, dy "
                         f"{tuple(dy2.shape)}, A {tuple(a.shape)}, B "
                         f"{tuple(b.shape)}")
    return n, din, dout, r


def lora_adapter_bwd_plain(x2, dy2, a, b):
    """Plain PyTorch version of the kernel: (dA_raw f32 [din, r], dB_raw f32
    [r, dout], dE_raw f32 [r]), same products and rounding points."""
    _check(x2, dy2, a, b)
    xf, dyf = x2.float(), dy2.float()
    t1 = dyf @ b.float().T
    u = xf @ a.float()
    da = xf.T @ t1.to(x2.dtype).float()
    db = u.to(dy2.dtype).float().T @ dyf
    de = (u * t1).sum(0)
    return da, db, de


def _lora_bwd_cuda(x2, dy2, a, b):
    global launches
    n, din, dout, r = _check(x2, dy2, a, b)
    for name, t in (("x", x2), ("dy", dy2), ("A", a), ("B", b)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"lora_bwd kernel takes bfloat16; {name} is "
                             f"{t.dtype}")
        if t.device != x2.device:
            raise ValueError(f"{name} on {t.device}, x on {x2.device}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_bwd kernel takes rank 1..{MAX_RANK}, got {r}")
    if din % 16 or dout % 16:
        raise ValueError(f"lora_bwd kernel needs din and dout multiples of "
                         f"16, got {din} and {dout}")
    fn = getattr(_library(), _FN)
    rp = 16 if r <= 16 else 32 if r <= 32 else 64
    # the kernel reads rows of x, dy, A^T and B as they lie in memory
    x2, dy2, b = x2.contiguous(), dy2.contiguous(), b.contiguous()
    at = a.t().contiguous()
    dev = x2.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    t1b = torch.empty((n, rp), dtype=torch.bfloat16, device=dev)
    ub = torch.empty_like(t1b)
    chunks = -(-n // _CHUNK)
    de_part = f32(-(-n // _TOK_TILE), rp)
    da_part, db_part = f32(chunks, din, rp), f32(chunks, rp, dout)
    da, db, de = f32(din, r), f32(r, dout), f32(r)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), dy2.data_ptr(), at.data_ptr(), b.data_ptr(),
                 n, din, dout, r, rp, t1b.data_ptr(), ub.data_ptr(),
                 de_part.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
                 da.data_ptr(), db.data_ptr(), de.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_bwd launch failed: CUDA error {err}")
    launches += 1
    return da, db, de


def lora_adapter_bwd(x2, dy2, a, b):
    """(x [N, din], dy [N, dout], A [din, r], B [r, dout]) -> (dA_raw f32
    [din, r], dB_raw f32 [r, dout], dE_raw f32 [r]).

    Raw products only: the caller applies the AdaLoRA E scaling and the
    alpha / r scale (``models/lora.py::FoldedLinear``). CPU tensors run the
    plain version; CUDA tensors launch the kernel (bfloat16, r <= 64, din
    and dout multiples of 16, any N) or raise."""
    if x2.device.type == "cpu":
        return lora_adapter_bwd_plain(x2, dy2, a, b)
    if not x2.is_cuda:
        raise ValueError(f"lora_adapter_bwd: unsupported device {x2.device}")
    return _lora_bwd_cuda(x2, dy2, a, b)
