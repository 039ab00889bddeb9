"""Flash attention on [B, T, H, D] tensors: the port of the TPU kernels
``neuspeech1_tpu/ops/flash_attention.py::_fwd_kernel_btc`` (forward, K1) and
``::_bwd_kernel_btc`` (backward, K2), entry ``flash_attention_bthd``, and of
the ``[B, H, T, D]`` entry ``flash_attention`` (K5: the same kernels on other
strides), and of the same kernel bodies with an explicit bias row,
``fwd_arrays_btc_bias`` and ``bwd_arrays_btc_bias`` (K4: ``flash_bias_fwd``
and ``flash_bias_bwd``, the blocks of ring attention).

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

K4 takes an additive f32 bias row [Tk] over the key axis instead of kv_len
(0 keeps a column, ``NEG_INF`` masks it) and, in the backward, a given lse
and o: ring attention hands it the global ones, merged over every key block.
A bias at or below ``MASKED_BIAS`` keeps its column out of the row max, as
the kv_len mask does, so a row whose every column is masked gives lse = -inf
and o = 0/0 = NaN, as the TPU kernel does; the ring's merge gates on it.
These are plain functions, not an autograd Function: the ring calls the
forward and the backward from its own.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)

# the masking bias of a key column in K4's bias row, and the threshold at or
# below which a bias masks its column (the kernels' kMaskedBias)
NEG_INF = -1e30
MASKED_BIAS = -1e29

# Kernel launches since the counts were last set to 0 (read by chip_smoke.py
# to show that a path went through the kernels): forward (K1) and backward
# (K2), and K4's forward and backward, one per wrapper call.
launches = 0
bwd_launches = 0
bias_launches = 0
bias_bwd_launches = 0
# K4 launches from the threads of a LocalRing: each count under a lock
_count_lock = threading.Lock()

_FWD = ("flash_fwd_btc", "nsp_flash_fwd_btc_bf16")
_BWD = ("flash_bwd_btc", "nsp_flash_bwd_btc_bf16")
_FWD_BIAS = "nsp_flash_fwd_btc_bias_bf16"
_BWD_BIAS = "nsp_flash_bwd_btc_bias_bf16"
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the forward kernels' library (K1 and K4); declare
    their signatures."""
    global _lib
    if _lib is None:
        lib = _build.load(_FWD[0])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, _FWD[1])
        fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 12
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        fn = getattr(lib, _FWD_BIAS)
        fn.argtypes = ([ptr] * 6 + [i32] * 5 + [i64] * 12
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    """Build and load the backward kernels' library (K2 and K4); declare
    their signatures: K2 ten pointers, seven ints, a pointer to 24 strides,
    the scale, the stream; K4 eleven pointers (the bias after lse) and five
    ints."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(_BWD[0])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, _BWD[1])
        fn.argtypes = [ptr] * 10 + [i32] * 7 + [ptr, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, _BWD_BIAS)
        fn.argtypes = [ptr] * 11 + [i32] * 5 + [ptr, ctypes.c_float, ptr]
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


def _check_bwd_operands(q, k, v, o, do, lse):
    """Checks the backward kernels' operands; returns do, contiguous."""
    b, t_q, h, d = q.shape
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
    return do


def _bwd_outputs(q, k, v, o, do):
    """dq, dk, dv, the delta scratch [B, H, Tq] f32 and the 24 element
    strides the backward kernels' C entries take."""
    b, t_q, h, d = q.shape
    dq = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, k.shape[1], h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]))
    return dq, dk, dv, delta, strides


def _flash_bwd_cuda(q, k, v, o, do, lse, causal: bool, kv_len: int):
    global bwd_launches
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    do = _check_bwd_operands(q, k, v, o, do, lse)
    fn = getattr(_bwd_library(), _BWD[1])
    dq, dk, dv, delta, strides = _bwd_outputs(q, k, v, o, do)
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


@torch.library.custom_op("neuspeech::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, kv_len: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The forward (K1 on CUDA tensors, its plain version on CPU ones) as
    one dispatcher op, ``torch.ops.neuspeech.flash_fwd``: a selective
    checkpoint policy can name it and keep its o and lse instead of
    running it again (``models/whisper.py``'s remat policy 'flash_qkv')."""
    return _forward(q, k, v, causal, kv_len)


@flash_fwd_op.register_fake
def _(q, k, v, causal, kv_len):
    b, t_q, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, t_q), dtype=torch.float32))


class FlashAttention(torch.autograd.Function):
    """o, lse = FlashAttention.apply(q, k, v, causal, kv_len): the forward
    kernel (through ``flash_fwd_op``) saving q, k, v, o and lse, the
    backward kernel for dq, dk, dv (the TPU package's ``custom_vjp`` around
    ``_flash_btc``). lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_len: int):
        o, lse = flash_fwd_op(q, k, v, causal, kv_len)
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


# --------------------------------------------------------------------------
# K4: the kernels with an explicit bias row (ring attention's blocks)
# --------------------------------------------------------------------------

def _check_bias(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_bias_fwd takes [B, T, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bias.dtype != torch.float32 or bias.shape != (k.shape[1],):
        raise ValueError(f"bias must be [Tk] = [{k.shape[1]}] f32; got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _bias_scores(q, k, bias):
    """The f32 scores [B, H, Tq, Tk] plus the bias in raw-score units
    (bias / scale), -inf where the bias masks the column."""
    scale = q.shape[3] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s + torch.where(bias <= MASKED_BIAS, float("-inf"), bias / scale)


def flash_bias_fwd_plain(q, k, v, bias):
    """Plain PyTorch version of K4's forward: (o [B, Tq, H, D] in q's dtype,
    lse [B, H, Tq] f32) of softmax(q k^T D^-1/2 + bias) v, with K1's rounding
    points. A fully masked row gives lse = -inf and o = NaN."""
    _check_bias(q, k, v, bias)
    scale = q.shape[3] ** -0.5
    s = _bias_scores(q, k, bias)
    m = s.amax(dim=-1, keepdim=True)
    # a fully masked row: shift by 0, so that p = exp(-inf) = 0 and l = 0
    p = torch.exp((s - torch.where(m == float("-inf"), 0.0, m)) * scale)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.transpose(1, 2).to(q.dtype), (m * scale + torch.log(l))[..., 0]


def flash_bias_bwd_plain(q, k, v, o, do, lse, bias):
    """Plain PyTorch version of K4's backward: (dq, dk, dv) in q's dtype from
    the given o and lse [B, H, Tq] f32 (global ones in a ring), with K2's
    rounding points; p = exp(q k^T D^-1/2 + bias - lse), 0 in a masked
    column."""
    _check_bias(q, k, v, bias)
    dt = q.dtype
    scale = q.shape[3] ** -0.5
    p = torch.exp((_bias_scores(q, k, bias) - (lse / scale)[..., None]) * scale)
    p = p.masked_fill(bias <= MASKED_BIAS, 0.0)
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


def _check_cuda_bias(q, bias) -> None:
    if bias.device != q.device or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous on {q.device}")


def _flash_bias_fwd_cuda(q, k, v, bias):
    global bias_launches
    b, t_q, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, x, q.device)
    _check_cuda_bias(q, bias)
    fn = getattr(_library(), _FWD_BIAS)
    o = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, h, t_q, k.shape[1], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_btc_bias launch failed: CUDA error {err}")
    with _count_lock:
        bias_launches += 1
    return o, lse


def _flash_bias_bwd_cuda(q, k, v, o, do, lse, bias):
    global bias_bwd_launches
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    do = _check_bwd_operands(q, k, v, o, do, lse)
    _check_cuda_bias(q, bias)
    fn = getattr(_bwd_library(), _BWD_BIAS)
    dq, dk, dv, delta, strides = _bwd_outputs(q, k, v, o, do)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), bias.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, h, t_q, t_kv, d, ctypes.addressof(strides), d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_btc_bias launch failed: CUDA error {err}")
    with _count_lock:
        bias_bwd_launches += 1
    return dq, dk, dv


def flash_bias_fwd(q, k, v, bias):
    """K4's forward (the JAX package's ``fwd_arrays_btc_bias``): q [B, Tq, H,
    D], k, v [B, Tk, H, D], bias [Tk] f32 -> (o [B, Tq, H, D], lse [B, H, Tq]
    f32). CPU tensors run `flash_bias_fwd_plain`; CUDA tensors launch the
    kernel (bfloat16, D in ``HEAD_DIMS``) or raise."""
    _check_bias(q, k, v, bias)
    if _device_of(q) == "cpu":
        return flash_bias_fwd_plain(q, k, v, bias)
    return _flash_bias_fwd_cuda(q, k, v, bias)


def flash_bias_bwd(q, k, v, o, do, lse, bias):
    """K4's backward (``bwd_arrays_btc_bias``): (dq, dk, dv) against one key
    block from the given o and lse, which may be the global ones of a ring.
    CPU tensors run `flash_bias_bwd_plain`; CUDA tensors launch the kernel
    or raise."""
    _check_bias(q, k, v, bias)
    if _device_of(q) == "cpu":
        return flash_bias_bwd_plain(q, k, v, o, do, lse, bias)
    return _flash_bias_bwd_cuda(q, k, v, o, do, lse, bias)
