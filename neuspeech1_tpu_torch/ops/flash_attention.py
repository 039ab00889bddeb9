"""Flash attention on [B, T, H, D] tensors: the port of the TPU kernels
``neuspeech1_tpu/ops/flash_attention.py::_fwd_kernel_btc`` (forward, K1) and
``::_bwd_kernel_btc`` (backward, K2), entry ``flash_attention_bthd``, and of
the ``[B, H, T, D]`` entry ``flash_attention`` (K5: the same kernels on other
strides).

On CUDA tensors the forward launches the hand-written Hopper kernel in
``csrc/flash_fwd_btc.cu`` and the backward the one in
``csrc/flash_bwd_btc.cu``, or they raise; there is no fallback. On CPU
tensors the same ``FlashAttention`` autograd Function runs
``flash_attention_bthd_plain`` and ``flash_attention_bthd_bwd_plain``, the
same functions in plain PyTorch, which are also the gold the kernels are
checked against on the card.

Both keep the TPU kernels' rounding points. Forward: scores and softmax
statistics in f32, p rounded to the value dtype before the PV product, f32
accumulation, the output rounded once. Backward: p recomputed from lse in
f32, p rounded before the dv product, ``delta = rowsum(do * o)`` in f32,
``ds = p (dp - delta)`` rounded to the input dtype, the scale folded into
rounded ``k * scale`` / ``q * scale`` operands, f32 accumulation. The 8-row
lse replication of the TPU kernel was a tile artefact and is dropped: lse is
[B, H, Tq] f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)

# Kernel launches since the counts were last set to 0 (read by chip_smoke.py
# to show that a path went through the kernels): forward (K1) and backward
# (K2), one per wrapper call.
launches = 0
bwd_launches = 0

_FWD = ("flash_fwd_btc", "nsp_flash_fwd_btc_bf16")
_BWD = ("flash_bwd_btc", "nsp_flash_bwd_btc_bf16")
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the forward kernel's library; declare its signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_FWD[0])
        fn = getattr(lib, _FWD[1])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 12
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    """Build and load the backward kernel's library; declare its signature:
    ten pointers, seven ints, a pointer to 24 strides, the scale, the
    stream."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(_BWD[0])
        fn = getattr(lib, _BWD[1])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i32] * 7 + [ptr, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def _check(q, k, v, causal: bool, kv_len: Optional[int]) -> int:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_bthd takes [B, T, H, D] tensors")
    b, t_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    t_kv = k.shape[1]
    if causal and t_q != t_kv:
        raise ValueError("causal flash attention requires Tq == Tkv")
    kv_len = t_kv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= t_kv:
        raise ValueError(f"kv_len={kv_len} outside [1, {t_kv}]")
    return kv_len


def _valid(t_q: int, t_kv: int, kv_len: int, causal: bool, device):
    """[Tq, Tkv] bool: the columns a row attends to."""
    cols = torch.arange(t_kv, device=device)
    valid = (cols < kv_len)[None, :].expand(t_q, t_kv)
    if causal:
        valid = valid & (cols[None, :] <= torch.arange(t_q, device=device)[:, None])
    return valid


def flash_attention_bthd_plain(q, k, v, causal: bool = False,
                               kv_len: Optional[int] = None,
                               return_lse: bool = False):
    """Plain PyTorch version of the forward kernel, with the same rounding
    points.

    Scores are taken from f32 copies of q and k (a product of two bf16
    values is exact in f32, as in the kernel's f32-accumulated product)."""
    kv_len = _check(q, k, v, causal, kv_len)
    t_q, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s.masked_fill(~_valid(t_q, k.shape[1], kv_len, causal, q.device),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    scale = d ** -0.5
    p = torch.exp((s - m) * scale)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    o = o.transpose(1, 2).to(q.dtype)
    if return_lse:
        return o, (m * scale + torch.log(l))[..., 0]
    return o


def flash_attention_bthd_bwd_plain(q, k, v, o, do, lse, causal: bool = False,
                                   kv_len: Optional[int] = None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the
    input dtype from the forward's o and lse [B, H, Tq] f32, with the TPU
    kernel's rounding points (``_bwd_kernel_btc``). K/V rows at or past
    ``kv_len`` get exactly zero gradients: their p is 0."""
    kv_len = _check(q, k, v, causal, kv_len)
    dt = q.dtype
    t_q, d = q.shape[1], q.shape[3]
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.exp((s - (lse * (1.0 / scale))[..., None]) * scale)
    p = p.masked_fill(~_valid(t_q, k.shape[1], kv_len, causal, q.device), 0.0)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]  # [B,H,Tq,1]
    ds = (p * (dp - delta)).to(dt).float()
    k_s = (k.float() * scale).to(dt).float()
    q_s = (q.float() * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k_s)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q_s)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_cuda_operand(name: str, x, device) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"flash kernel takes bfloat16; {name} is {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, q on {device}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} must have a contiguous head dim and 16-byte aligned "
            f"rows; strides {x.stride()}")


def _flash_fwd_cuda(q, k, v, causal: bool, kv_len: int):
    global launches
    b, t_q, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, x, q.device)
    fn = getattr(_library(), _FWD[1])
    o = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    # the C entry launches on the current device: make it q's
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, t_q, kv_len, d, int(causal),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_btc launch failed: CUDA error {err}")
    launches += 1
    return o, lse


def _flash_bwd_cuda(q, k, v, o, do, lse, causal: bool, kv_len: int):
    global bwd_launches
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim {d} not in {HEAD_DIMS}")
    # autograd may hand over a gradient whose head dim is not contiguous
    do = do.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_cuda_operand(name, x, q.device)
    if lse.dtype != torch.float32 or lse.shape != (b, h, t_q) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous [B, H, Tq] f32; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    fn = getattr(_bwd_library(), _BWD[1])
    dq = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t_kv, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, h, t_q, t_kv, kv_len, d, int(causal),
                 ctypes.addressof(strides), d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_btc launch failed: CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


def _device_of(q) -> str:
    if q.device.type == "cpu":
        return "cpu"
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bthd: unsupported device {q.device}")
    return "cuda"


def _forward(q, k, v, causal: bool, kv_len: int):
    if _device_of(q) == "cpu":
        return flash_attention_bthd_plain(q, k, v, causal, kv_len,
                                          return_lse=True)
    return _flash_fwd_cuda(q, k, v, causal, kv_len)


def _backward(q, k, v, o, do, lse, causal: bool, kv_len: int):
    if _device_of(q) == "cpu":
        return flash_attention_bthd_bwd_plain(q, k, v, o, do, lse, causal,
                                              kv_len)
    return _flash_bwd_cuda(q, k, v, o, do, lse, causal, kv_len)


class FlashAttention(torch.autograd.Function):
    """o, lse = FlashAttention.apply(q, k, v, causal, kv_len): the forward
    kernel saving q, k, v, o and lse, the backward kernel for dq, dk, dv
    (the TPU package's ``custom_vjp`` around ``_flash_btc``). lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_len: int):
        o, lse = _forward(q, k, v, causal, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kv_len = causal, kv_len
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, do, lse, ctx.causal, ctx.kv_len)
        return dq, dk, dv, None, None


def flash_attention_bthd(q, k, v, causal: bool = False,
                         kv_len: Optional[int] = None,
                         return_lse: bool = False):
    """Attention on q [B, Tq, H, D] and k, v [B, Tkv, H, D]; returns o
    [B, Tq, H, D] in q's dtype, and with ``return_lse`` also lse [B, H, Tq]
    in f32. Scale D^-1/2. ``kv_len`` masks key/value rows at or past it;
    ``causal`` (Tq == Tkv) masks columns after the row.

    When an input requires grad the call goes through ``FlashAttention``,
    whose backward is the backward kernel. CPU tensors run the plain
    versions. CUDA tensors launch the kernels (bfloat16, D in
    ``HEAD_DIMS``) or raise."""
    kv_len = _check(q, k, v, causal, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = FlashAttention.apply(q, k, v, causal, kv_len)
    else:
        o, lse = _forward(q, k, v, causal, kv_len)
    return (o, lse) if return_lse else o


def flash_attention(q, k, v, causal: bool = False):
    """The ``[B, H, T, D]`` entry (the JAX package's ``flash_attention``):
    q [B, H, Tq, D], k, v [B, H, Tkv, D] -> [B, H, Tq, D]. The same kernels
    read the transposed views through their strides; nothing is copied."""
    o = flash_attention_bthd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal)
    return o.transpose(1, 2)
