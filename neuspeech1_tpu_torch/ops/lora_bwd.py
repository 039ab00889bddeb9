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

The kernel reads x and dy once: clusters of CTAs split the 64-column panels
of x and dy (``plan``), sum their partial t1 and u through distributed
shared memory before the bf16 rounding, and keep their slices of dA and dB
in registers over a range of 64-token tiles; a second launch sums the
clusters' partials in a fixed order. Shapes past the plan (more panels than
eight CTAs hold) run the wide path, three stages that read x and dy twice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from neuspeech1_tpu_torch.ops import _build

MAX_RANK = 64
# The one-pass kernel's layout (csrc/lora_bwd.cu): tokens per tile, columns
# per panel, tiles in flight, floats past each row of the partial sums, the
# shared memory a block may use (the H100's 227 KB) and the cluster sizes.
TOK_TILE = 64
PANEL_COLS = 64
STAGES = 2
X_PAD = 4
MAX_SMEM_BYTES = 232448
CLUSTERS = (1, 2, 4, 8)
_WIDE_TOK_TILE = 64  # tokens per dE partial of the wide path (kTokTile)
_WIDE_CHUNK = 2048   # tokens per dA / dB partial of the wide path (kChunk)

# Kernel launches since the count was last set to 0, one per wrapper call.
launches = 0

_SOURCE = "lora_bwd"
_FN, _WIDE_FN = "nsp_lora_bwd_bf16", "nsp_lora_bwd_wide_bf16"
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """Build and load the kernel library and declare its C signatures."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, _FN)
        fn.argtypes = [ptr] * 4 + [i32] * 8 + [ptr] * 5
        fn.restype = ctypes.c_int
        wide = getattr(lib, _WIDE_FN)
        wide.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * 9
        wide.restype = ctypes.c_int
        lib.nsp_lora_bwd_resident.argtypes = [i32] * 3
        lib.nsp_lora_bwd_resident.restype = ctypes.c_int
        _lib = lib
    return _lib


def padded_rank(r: int) -> int:
    """The one-pass kernel's rank: r padded with zeros to the wgmma width."""
    return 32 if r <= 32 else 64


def per_warpgroup(rp: int) -> int:
    """Panels whose dA or dB slice one warpgroup keeps in registers
    (``per_warpgroup`` in the C source); a CTA has two warpgroups."""
    return 5 if rp == 32 else 3


def smem_bytes(pc: int, rp: int) -> int:
    """Dynamic shared memory of a CTA of ``pc`` panels at width ``rp``, as
    the C source's ``smem_bytes``, in its layout's order: the ring of
    tiles, the weight slices, bf16(t1) and bf16(u), the f32 partials, the
    mbarriers and the base's alignment."""
    return (STAGES * pc * TOK_TILE * PANEL_COLS * 2 + pc * rp * PANEL_COLS * 2
            + 2 * TOK_TILE * rp * 2 + TOK_TILE * (2 * rp + X_PAD) * 4
            + 64 + 1024)


class Plan(NamedTuple):
    """How the one-pass kernel splits a call: ``rp`` the padded rank;
    clusters of ``cluster`` CTAs, CTA c holding panels [c pc, (c + 1) pc)
    of the ``panels`` (x's, then dy's); ``tiles`` of 64 tokens walked in
    contiguous ranges by at most ``clusters`` clusters."""
    rp: int
    cluster: int
    pc: int
    panels: int
    tiles: int
    clusters: int

    def part_floats(self) -> int:
        """f32 of one cluster's partial sums: every panel's 64 rows of rp,
        then each CTA's dE."""
        return self.panels * PANEL_COLS * self.rp + self.cluster * self.rp


def plan(n: int, din: int, dout: int, r: int,
         sms: int = 132) -> Optional[Plan]:
    """The one-pass kernel's plan for x [n, din], dy [n, dout] at rank r on
    a card of ``sms`` SMs: the smallest cluster whose CTAs hold their share
    of the panels in registers and shared memory, and one cluster per
    ``cluster`` SMs (the kernel takes fewer where the card holds fewer at
    once). None past the largest cluster: the wide path."""
    rp = padded_rank(r)
    panels = -(-din // PANEL_COLS) + -(-dout // PANEL_COLS)
    tiles = -(-n // TOK_TILE)
    for cluster in CLUSTERS:
        pc = -(-panels // cluster)
        if (pc <= 2 * per_warpgroup(rp)
                and smem_bytes(pc, rp) <= MAX_SMEM_BYTES):
            return Plan(rp, cluster, pc, panels, tiles,
                        max(1, min(tiles, sms // cluster)))
    return None


def resident_clusters(pl: Plan) -> int:
    """The clusters of ``pl`` that the current card holds at once, as its
    driver reports them: the kernel's grid is at most this many (and at
    most ``pl.clusters``)."""
    return _library().nsp_lora_bwd_resident(pl.rp, pl.cluster, pl.pc)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    lib = _library()
    dev = x2.device
    # the kernel reads rows of x, dy, A and B as they lie in memory, x and dy
    # through TMA maps, whose base must be 16-byte aligned
    x2, dy2, a, b = (t.contiguous() for t in (x2, dy2, a, b))
    x2, dy2 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x2, dy2))

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pl = plan(n, din, dout, r, _sm_count(dev.index or 0))
    da, db, de = f32(din, r), f32(r, dout), f32(r)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pl is not None:
        part = f32(pl.clusters, pl.part_floats())
        with torch.cuda.device(dev):
            err = getattr(lib, _FN)(
                x2.data_ptr(), dy2.data_ptr(), a.data_ptr(), b.data_ptr(), n,
                din, dout, r, pl.rp, pl.cluster, pl.pc, pl.clusters,
                part.data_ptr(), da.data_ptr(), db.data_ptr(), de.data_ptr(),
                stream)
    else:
        rp = 16 if r <= 16 else padded_rank(r)
        at = a.t().contiguous()
        t1b = torch.empty((n, rp), dtype=torch.bfloat16, device=dev)
        ub = torch.empty_like(t1b)
        chunks = -(-n // _WIDE_CHUNK)
        de_part = f32(-(-n // _WIDE_TOK_TILE), rp)
        da_part, db_part = f32(chunks, din, rp), f32(chunks, rp, dout)
        with torch.cuda.device(dev):
            err = getattr(lib, _WIDE_FN)(
                x2.data_ptr(), dy2.data_ptr(), at.data_ptr(), b.data_ptr(), n,
                din, dout, r, rp, t1b.data_ptr(), ub.data_ptr(),
                de_part.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
                da.data_ptr(), db.data_ptr(), de.data_ptr(), stream)
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
