"""Full-row attention forward probe: the port of the TPU tuning probes of the
flash forward (``perf/kernel_probe.py::make_kernel``, ``make_online``,
``make_semantics``; ``perf/mxu_probe.py::make_fwd``;
``perf/btc_probe.py::make_fwd_btc``, ``make_fwd_btc_sem``).

Per (batch, head) and query row, over TK keys of which ``t_valid`` are kept:
s = q k^T D^-1/2 in f32 with columns at or past ``t_valid`` set to -1e30
(``mode`` 'nomask' keeps every column), m = row max, p = f(s - m) with f =
exp ('base', 'nomask'), x * 0.001 + 1 ('noexp') or bf16(exp(bf16(x)))
widened to f32 ('bf16exp'), o = (p cast to v's dtype) v / rowsum(p), and
lse = m + log(rowsum(p)). With ``n_kb > 1`` the columns run in ``n_kb``
blocks under an online softmax (make_online), equal to the full row up to
rounding.

Two layouts: [B*H, TK, 64] (the probes' flattened heads) and, with
``btc=True``, [B, TK, H*64] (heads read in place, lse [B, H, TK]).

On CUDA tensors `probe_fwd` launches the Hopper kernel of
``csrc/probe_fwd.cu`` (wgmma fed by a TMA ring, two sweeps over K: the
block maxima, then p and PV) or raises; on CPU tensors it runs
`probe_fwd_plain`, which is also the kernel's gold on the card. ``rows``
(query rows per CTA, whole warpgroups of 64), ``n_sub`` (how the consumer
warpgroups share the tensor cores: 1 free-running, 2 or 4 taking turns) and
``order`` (the walk over (head, q tile) items) shape only the kernel's
schedule (`plan`); they are checked on every device, so that a
configuration the card cannot run fails on the CPU too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuspeech1_tpu_torch.ops import _build

HEAD_DIM = 64
NEG_INF = -1e30
MODES = ("base", "nomask", "noexp", "bf16exp")
# the items' walk: 'head' = one head's q tiles consecutive (the CTAs in
# flight share its K/V in L2), 'qblock' = one q tile of every head
# consecutive
ORDERS = ("head", "qblock")
# (rows, n_sub) schedules built, each for every mode (csrc/probe_fwd.cu
# launch_tile): one warpgroup; two free-running; two taking turns per
# 128-column K tile (n_sub 2) or per 64-column one (n_sub 4)
SCHEDULES = ((64, 1), (128, 1), (128, 2), (128, 4))
MAX_BLOCKS = 4           # n_kb: the block maxima a thread keeps
MAX_SMEM_BYTES = 232448  # an H100 block's shared memory (227 KB)

# Kernel launches since the count was last set to 0, one per wrapper call.
launches = 0

_SOURCE, _FN = "probe_fwd", "nsp_probe_fwd_bf16"
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel library and declare its C signature."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, _FN)
        fn.argtypes = [ptr] * 5 + [i32] * 9 + [i64] * 3 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def plan(rows: int, n_sub: int, tk: int, n_kb: int = 1) -> dict:
    """The kernel's schedule for ``rows`` q rows per CTA, ``n_sub`` and the
    column blocks of ``tk`` keys, as csrc/probe_fwd.cu builds it
    (``Sched``): consumer warpgroups, K-tile rows, ring stages, turns,
    threads, dynamic shared memory (a Q tile, the stages of K and V tiles,
    two mbarriers for Q and two for each stage, 1 KB of alignment) and
    CTAs an SM. Raises for a schedule that is not built."""
    if rows % 64 or (rows, n_sub) not in SCHEDULES:
        raise ValueError(
            f"no probe_fwd schedule for rows {rows}, n_sub {n_sub}: rows are "
            f"whole warpgroups of 64 q rows, one or two; n_sub is 1, or the "
            f"turns two warpgroups take per 128 columns (2, or 4 on "
            f"64-column tiles); built are {SCHEDULES}")
    if not 1 <= n_kb <= MAX_BLOCKS or tk % (64 * n_kb) or tk % rows:
        raise ValueError(
            f"TK {tk} must be a multiple of rows ({rows}) and of 64 * n_kb "
            f"({n_kb}, at most {MAX_BLOCKS} column blocks)")
    wg = rows // 64
    block_k = 64 if n_sub == 4 or (tk // n_kb) % 128 else 128
    stages = (3 if wg == 1 else 4) * (128 // block_k)
    tile_k = block_k * HEAD_DIM * 2
    smem = rows * HEAD_DIM * 2 + stages * 2 * tile_k + 16 * (1 + stages) \
        + 1024
    return {"warpgroups": wg, "block_k": block_k, "stages": stages,
            "turns": n_sub > 1, "threads": 160 if wg == 1 else 128 * (wg + 1),
            "smem_bytes": smem, "ctas_per_sm": 2 if wg == 1 else 1}


def heads_view(x, btc: bool):
    """[B*H, TK, 64] of a probe array: the array itself, or the heads of a
    [B, TK, H*64] one (a copy)."""
    if not btc:
        return x
    b, t, c = x.shape
    return x.view(b, t, c // HEAD_DIM, HEAD_DIM).transpose(1, 2).reshape(
        -1, t, HEAD_DIM)


def from_heads(x, b: int):
    """The inverse of `heads_view` for [B, TK, H*64]."""
    bh, t, d = x.shape
    return x.view(b, bh // b, t, d).transpose(1, 2).reshape(b, t, -1)


def layout(x, btc: bool):
    """(n_bh, n_heads, tk, (stride of a batch, of a head, of a row)) of a
    probe array in elements, for the kernels' strided head addressing."""
    if btc:
        b, t, c = x.shape
        h = c // HEAD_DIM
        return b * h, h, t, (t * c, HEAD_DIM, c)
    bh, t, _ = x.shape
    return bh, 1, t, (t * HEAD_DIM, 0, HEAD_DIM)


def check_shapes(btc: bool, *xs) -> None:
    want = xs[0].shape
    for x in xs:
        if x.shape != want or x.dim() != 3:
            raise ValueError(f"probe arrays must share one 3-D shape; got "
                             f"{[tuple(t.shape) for t in xs]}")
    if (want[2] % HEAD_DIM) if btc else (want[2] != HEAD_DIM):
        raise ValueError(f"the probes take heads of {HEAD_DIM}; got "
                         f"{tuple(want)} ({'btc' if btc else 'bhtd'})")


def check_schedule(mode: str, rows: int, n_sub: int, n_kb: int, order: str,
                   tk: int) -> None:
    """Raises for a (mode, rows, n_sub, n_kb, order) the kernel does not
    take at ``tk`` keys (see `plan`)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if order not in ORDERS:
        raise ValueError(f"order {order!r} is not one of {ORDERS}")
    plan(rows, n_sub, tk, n_kb)


def _prob(x, mode: str):
    if mode == "noexp":
        return x * 0.001 + 1.0
    if mode == "bf16exp":
        return torch.exp(x.to(torch.bfloat16)).float()
    return torch.exp(x)


def probe_fwd_plain(q, k, v, t_valid: int, mode: str = "base", n_kb: int = 1,
                    btc: bool = False):
    """Plain PyTorch version: (o in q's layout and dtype, lse f32 [B*H, TK]
    or, with ``btc``, [B, H, TK]). Products of the inputs' values in f32;
    p cast to v's dtype for PV, as the probes do."""
    check_shapes(btc, q, k, v)
    qh, kh, vh = (heads_view(x, btc).float() for x in (q, k, v))
    bh, tk, d = qh.shape
    if tk % n_kb:
        raise ValueError(f"TK {tk} is not a multiple of n_kb {n_kb}")
    kb = tk // n_kb
    scale = d ** -0.5
    m = torch.full((bh, tk, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, tk, 1), device=q.device)
    acc = torch.zeros_like(qh)
    cols = torch.arange(tk, device=q.device)
    for j in range(n_kb):
        sl = slice(j * kb, (j + 1) * kb)
        s = torch.bmm(qh, kh[:, sl].transpose(1, 2)) * scale
        if mode != "nomask":
            s = torch.where(cols[sl] < t_valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = _prob(s - m_new, mode)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.bmm(p.to(v.dtype).float(), vh[:, sl])
        m = m_new
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    if btc:
        return from_heads(o, q.shape[0]), lse.view(q.shape[0], -1, tk)
    return o, lse


def _probe_fwd_cuda(q, k, v, t_valid, mode, rows, n_sub, n_kb, order, btc,
                    want_lse):
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"probe_fwd takes bfloat16 on one device; {name} "
                             f"is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"probe_fwd takes contiguous arrays; {name} "
                             "is not")
    n_bh, n_heads, tk, (s_b, s_h, s_t) = layout(q, btc)
    o = torch.empty_like(q)
    lse = (torch.empty((n_bh, tk), dtype=torch.float32, device=q.device)
           if want_lse else None)
    fn = getattr(_library(), _FN)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), n_bh, n_heads, tk,
                 t_valid, MODES.index(mode), rows, n_sub, n_kb,
                 ORDERS.index(order), s_b, s_h, s_t, HEAD_DIM ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_fwd launch failed: CUDA error {err}")
    launches += 1
    if lse is not None and btc:
        lse = lse.view(q.shape[0], n_heads, tk)
    return o, lse


def probe_fwd(q, k, v, t_valid: int, mode: str = "base", rows: int = 128,
              n_sub: int = 1, n_kb: int = 1, order: str = "head",
              btc: bool = False, want_lse: bool = False):
    """o (q's layout) or, with ``want_lse``, (o, lse). CPU tensors run the
    plain version; CUDA tensors launch the kernel (bfloat16, contiguous,
    heads of 64) or raise."""
    check_shapes(btc, q, k, v)
    check_schedule(mode, rows, n_sub, n_kb, order, q.shape[1])
    if not 1 <= t_valid <= q.shape[1]:
        raise ValueError(f"t_valid {t_valid} outside 1..{q.shape[1]}")
    if q.device.type == "cpu":
        o, lse = probe_fwd_plain(q, k, v, t_valid, mode, n_kb, btc)
    elif q.is_cuda:
        o, lse = _probe_fwd_cuda(q, k, v, t_valid, mode, rows, n_sub, n_kb,
                                 order, btc, want_lse)
    else:
        raise ValueError(f"probe_fwd: unsupported device {q.device}")
    return (o, lse) if want_lse else o
