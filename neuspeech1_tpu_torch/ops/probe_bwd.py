"""Attention backward probe from a given lse: the port of the TPU tuning
probes of the flash backward (``perf/bwd_probe.py::make_bwd``,
``perf/btc_probe.py::make_bwd_btc``).

From q, k, v, o, do and a GIVEN lse (the probes feed lse ~ N(8, 0.1^2):
p is not normalised, and the plain version must not recompute it):

    s  = q k^T D^-1/2, columns at or past t_valid set to -1e30
    p  = exp(s - lse);  dv = p^T do;  dp = do v^T;  delta = rowsum(do * o)
    ds = p (dp - delta) D^-1/2;  dq = ds k;  dk = ds^T q

``ops`` 'bf16': p and ds are cast to bf16 before their products (bf16
operands, f32 accumulation); 'f32': every product on f32 operands in f32.
dq, dk, dv come out in the inputs' dtype. Layouts as in `probe_fwd`:
[B*H, TK, 64] with lse [B*H, TK], or ``btc`` [B, TK, H*64] with lse
[B, H, TK] (the TPU probes carry 8 replicated rows per head; the port
takes one).

On CUDA tensors `probe_bwd` launches the Hopper kernels of
``csrc/probe_bwd.cu`` (three kernels: delta, dk/dv, dq; deterministic) or
raises; on CPU tensors it runs `probe_bwd_plain`, also the kernels' gold on
the card. ``rows`` (R: the q rows of a dq CTA and of each q tile the dk/dv
CTA walks, 32 or 64) shapes only the kernels' schedule and is checked on
every device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build
from neuspeech1_tpu_torch.ops.probe_fwd import (
    HEAD_DIM, NEG_INF, check_shapes, from_heads, heads_view, layout)

OPS = ("bf16", "f32")
ROWS = (32, 64)

# Kernel launches since the count was last set to 0, one per wrapper call.
launches = 0

_SOURCE, _FN = "probe_bwd", "nsp_probe_bwd"
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel library and declare its C signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, _FN)
        fn.argtypes = [ptr] * 10 + [i32] * 6 + [i64] * 3 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, o, do, lse, t_valid, ops, rows, btc):
    check_shapes(btc, q, k, v, o, do)
    n_bh, n_heads, tk, _ = layout(q, btc)
    want = (q.shape[0], n_heads, tk) if btc else (n_bh, tk)
    if tuple(lse.shape) != want:
        raise ValueError(f"lse must be {want}; got {tuple(lse.shape)}")
    if ops not in OPS:
        raise ValueError(f"ops {ops!r} is not one of {OPS}")
    if rows not in ROWS or tk % 64 or tk % rows:
        raise ValueError(f"probe_bwd takes rows in {ROWS} and TK a multiple "
                         f"of 64 and of rows; got rows {rows}, TK {tk}")
    if not 1 <= t_valid <= tk:
        raise ValueError(f"t_valid {t_valid} outside 1..{tk}")


def probe_bwd_plain(q, k, v, o, do, lse, t_valid: int, ops: str = "bf16",
                    btc: bool = False):
    """Plain PyTorch version: (dq, dk, dv) in the inputs' layout and dtype,
    from the given lse, with the rounding points of ``ops``."""
    qh, kh, vh, oh, doh = (heads_view(x, btc).float()
                           for x in (q, k, v, o, do))
    lse_h = lse.reshape(qh.shape[0], -1, 1).float()
    tk, d = qh.shape[1], qh.shape[2]
    scale = d ** -0.5
    s = torch.bmm(qh, kh.transpose(1, 2)) * scale
    s = torch.where(torch.arange(tk, device=q.device) < t_valid, s, NEG_INF)
    p = torch.exp(s - lse_h)
    p_in = p.to(torch.bfloat16).float() if ops == "bf16" else p
    dv = torch.bmm(p_in.transpose(1, 2), doh)
    dp = torch.bmm(doh, vh.transpose(1, 2))
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if ops == "bf16":
        ds = ds.to(torch.bfloat16).float()
    dq = torch.bmm(ds, kh)
    dk = torch.bmm(ds.transpose(1, 2), qh)
    out = tuple(g.to(x.dtype) for g, x in ((dq, q), (dk, k), (dv, v)))
    if btc:
        out = tuple(from_heads(g, q.shape[0]) for g in out)
    return out


def _probe_bwd_cuda(q, k, v, o, do, lse, t_valid, ops, rows, btc):
    global launches
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"probe_bwd takes bfloat16 on one device; {name} "
                             f"is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"probe_bwd takes contiguous arrays; {name} "
                             "is not")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 on {q.device}")
    lse = lse.contiguous()
    n_bh, n_heads, tk, (s_b, s_h, s_t) = layout(q, btc)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((n_bh, tk), dtype=torch.float32, device=q.device)
    fn = getattr(_library(), _FN)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), n_bh, n_heads,
                 tk, t_valid, rows, int(ops == "f32"), s_b, s_h, s_t,
                 HEAD_DIM ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_bwd launch failed: CUDA error {err}")
    launches += 1
    return dq, dk, dv


def probe_bwd(q, k, v, o, do, lse, t_valid: int, ops: str = "bf16",
              rows: int = 64, btc: bool = False):
    """(dq, dk, dv). CPU tensors run the plain version; CUDA tensors launch
    the kernels (bfloat16, contiguous, heads of 64, f32 lse) or raise."""
    _check(q, k, v, o, do, lse, t_valid, ops, rows, btc)
    if q.device.type == "cpu":
        return probe_bwd_plain(q, k, v, o, do, lse, t_valid, ops, btc)
    if not q.is_cuda:
        raise ValueError(f"probe_bwd: unsupported device {q.device}")
    return _probe_bwd_cuda(q, k, v, o, do, lse, t_valid, ops, rows, btc)
