"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the feature upload's pinned staging.

Needs an NVIDIA GPU, nvcc and no JAX; skips without a GPU. The machine with
the card has no JAX, and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import sys
import threading

import numpy as np
import pytest
import torch

from neuspeech1_tpu_torch.cli import common
from neuspeech1_tpu_torch.ops import decode_cross as tdc
from neuspeech1_tpu_torch.ops import decode_step as tds
from neuspeech1_tpu_torch.ops import flash_attention as tfa
from neuspeech1_tpu_torch.ops import lora_bwd as tlb
from neuspeech1_tpu_torch.ops import moe_gemm as tmg
from neuspeech1_tpu_torch.ops import probe_bwd as tpb
from neuspeech1_tpu_torch.ops import probe_dot as tpd
from neuspeech1_tpu_torch.ops import probe_fwd as tpf
from neuspeech1_tpu_torch.train import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (shape [B, Tq, H, D], Tk, causal, kv_len, layout). The forward runs wide
# CTAs (three warpgroups, 192 q rows) where Tq > 64 and ceil(Tq / 192) * H * B
# fills the card's 132 SMs twice over, else narrow ones (one warpgroup, 64
# rows); K/V tiles are 128 rows (64 at D=128). B * H = 288 puts every case
# with Tq > 64 on the wide path.
FWD_CASES = [
    ((2, 300, 8, 64), 300, False, None, "bthd"),
    ((2, 300, 8, 64), 300, False, 257, "bthd"),
    ((2, 130, 4, 64), 130, True, None, "bthd"),
    ((1, 100, 2, 32), 100, False, None, "bthd"),
    ((1, 100, 2, 128), 100, True, None, "bthd"),
    # the edges of the narrow CTAs
    ((2, 129, 4, 64), 129, False, None, "bthd"),   # one-row q and K/V tails
    ((4, 20, 8, 64), 1500, False, None, "bthd"),   # short queries
    ((4, 64, 8, 64), 1500, False, 1400, "bthd"),   # the decoder's cross shape
    ((2, 300, 4, 64), 300, True, 280, "bthd"),     # causal over three tiles
    ((2, 300, 8, 64), 300, False, 257, "bhtd"),    # K5's transposed views
    # the edges of the wide CTAs
    ((18, 129, 16, 64), 129, False, None, "bthd"),  # a one-row K/V tail
    ((18, 200, 16, 64), 200, False, None, "bthd"),  # 8 rows in the last q tile
    ((18, 200, 16, 64), 200, False, 150, "bthd"),   # kv_len inside the tail tile
    ((18, 192, 16, 64), 300, False, 256, "bthd"),   # kv_len on a tile boundary
    ((18, 448, 16, 64), 448, True, None, "bthd"),   # causal over four tiles
    ((18, 300, 16, 32), 300, False, 200, "bthd"),
    ((18, 300, 16, 128), 300, True, None, "bthd"),
    ((18, 300, 16, 128), 300, False, 200, "bthd"),
    ((18, 300, 16, 64), 300, False, 257, "bhtd"),
    # head dims past HEAD_DIMS, zero-padded to the next by the wrapper
    ((2, 130, 4, 24), 130, False, 100, "bthd"),
    ((16, 32, 2, 24), 80, False, None, "bthd"),
    ((2, 200, 4, 48), 200, True, None, "bthd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_kv,causal,kv_len,layout", FWD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, shape, t_kv, causal,
                                      kv_len, layout):
    """K1 against its plain version. K/V rows at or past kv_len hold NaN in
    the kernel's inputs (the encoder passes padded rows as they lie): the
    kernel must never read them, so o stays finite; the plain version gets
    the same rows as zeros, which its masks also ignore."""
    b, t, h, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(t_):
        if layout == "bhtd":  # [B, H, T, D] storage seen as [B, T, H, D]
            return (torch.randn((b, h, t_, d), generator=gen,
                                device=cuda_device)
                    .to(torch.bfloat16).transpose(1, 2))
        return (torch.randn((b, t_, h * d), generator=gen, device=cuda_device)
                .to(torch.bfloat16).view(b, t_, h, d))

    q, k, v = rand(t), rand(t_kv), rand(t_kv)
    if kv_len is not None:
        k[:, kv_len:] = float("nan")
        v[:, kv_len:] = float("nan")
    before = tfa.launches
    o, lse = tfa.flash_attention_bthd(q, k, v, causal, kv_len, True)
    assert tfa.launches == before + 1
    k0, v0 = torch.nan_to_num(k, nan=0.0), torch.nan_to_num(v, nan=0.0)
    o_p, lse_p = tfa.flash_attention_bthd_plain(q, k0, v0, causal, kv_len,
                                                True)
    assert torch.isfinite(o.float()).all()
    # one or two bf16 ulps of o (|o| < 1); lse stays f32
    assert (o.float() - o_p.float()).abs().max().item() <= 1e-2
    assert (lse - lse_p).abs().max().item() <= 1e-4


def _rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_kv,causal,kv_len", [
    ((2, 300, 8, 64), 300, False, 257), ((2, 130, 4, 64), 130, True, None),
    ((2, 40, 8, 64), 300, False, None), ((1, 100, 2, 128), 100, True, None),
    ((1, 100, 2, 32), 100, False, None),
    # the edges of the backward's tiles (128 K/V rows and 64 q rows per
    # dk/dv tile, 32 at D=128; 128 q rows and 64 K/V rows per dq tile)
    ((2, 129, 4, 64), 129, False, None),    # one-row tails
    ((2, 65, 4, 64), 200, False, None),     # Tk off both tiles
    ((2, 200, 4, 64), 200, False, 150),     # kv_len inside a tile
    ((2, 192, 4, 64), 256, False, 128),     # kv_len on a tile boundary
    ((2, 300, 4, 64), 300, True, None),     # causal over 3+ tiles
    ((4, 64, 8, 64), 1500, False, None),    # the decoder's cross shape
    ((1, 129, 2, 128), 200, False, 150), ((1, 200, 4, 128), 200, True, None),
    ((1, 129, 4, 32), 129, False, None), ((1, 200, 4, 32), 200, True, 190),
    # head dims past HEAD_DIMS, zero-padded by the wrapper
    ((2, 130, 4, 24), 130, False, 100), ((16, 32, 2, 24), 80, False, None),
    ((1, 129, 2, 80), 129, True, None)])
def test_backward_kernel_matches_plain_on_card(cuda_device, shape, t_kv,
                                               causal, kv_len):
    b, t, h, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rand(t_):
        return (torch.randn((b, t_, h * d), generator=gen, device=cuda_device)
                .to(torch.bfloat16).view(b, t_, h, d))

    q, k, v = rand(t), rand(t_kv), rand(t_kv)
    o, lse = tfa.flash_attention_bthd(q, k, v, causal, kv_len, True)
    do = rand(t)
    args = (q, k, v, o, do, lse, causal, kv_len or t_kv)
    before = tfa.bwd_launches
    grads = tfa._flash_bwd_cuda(*args)
    assert tfa.bwd_launches == before + 1
    plain = tfa.flash_attention_bthd_bwd_plain(*args)
    # a few bf16 ulps of the largest gradient (chip_smoke.py K2_REL_TOL)
    for g, p in zip(grads, plain):
        assert _rel_err(g, p) <= 2e-2
    if kv_len is not None:
        assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()


# (N, din, dout, r). The one-pass kernel (ops/lora_bwd.py::plan) cuts x and
# dy into 64-column panels, splits them over clusters of 1-8 CTAs and walks
# 64-token tiles, each cluster a contiguous range: at 512 -> 2048 the card
# holds 33 clusters of 4, so N = 4224 gives each two tiles and 4223 / 4225
# end one token inside or past them; 63 / 64 / 65 end around one tile. Ranks
# 1, 16 and 33 pad to 32 or 64 with zeros; din = 16 leaves most of one panel
# past the end. 1280 -> 5120 at r = 32 and 768 -> 3072 at r = 64 hold more
# panels than eight CTAs: the wide path.
LORA_CASES = [(4096, 512, 2048, 32), (1000, 256, 128, 12), (70, 128, 64, 64),
              # rank < the padded rank over three 2048-token partials
              (5000, 256, 128, 12),
              # the training step's fc1 and fc2 (N = 64 x 1500)
              (96000, 512, 2048, 32), (96000, 2048, 512, 32),
              (3000, 512, 2048, 1), (3000, 2048, 512, 16),
              (3000, 512, 2048, 33), (3000, 512, 2048, 64),
              (63, 512, 2048, 32), (64, 2048, 512, 32), (65, 512, 2048, 32),
              (4223, 512, 2048, 32), (4224, 512, 2048, 32),
              (4225, 2048, 512, 32), (300, 16, 64, 8), (200, 16, 2048, 64),
              (200, 1280, 5120, 32), (100, 768, 3072, 64)]


def _lora_inputs(gen, device, n, din, dout, r):
    x, dy = (torch.randn((n, w), generator=gen, device=device)
             .to(torch.bfloat16) for w in (din, dout))
    a = (0.1 * torch.randn((din, r), generator=gen, device=device)
         ).to(torch.bfloat16)
    bm = (0.1 * torch.randn((r, dout), generator=gen, device=device)
          ).to(torch.bfloat16)
    return x, dy, a, bm


@pytest.mark.cuda
@pytest.mark.parametrize("n,din,dout,r", LORA_CASES)
def test_lora_bwd_kernel_matches_plain_on_card(cuda_device, n, din, dout, r):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, dy, a, bm = _lora_inputs(gen, cuda_device, n, din, dout, r)
    before = tlb.launches
    got = tlb.lora_adapter_bwd(x, dy, a, bm)
    assert tlb.launches == before + 1
    ref = tlb.lora_adapter_bwd_plain(x, dy, a, bm)
    # f32 outputs; a bf16 rounding of t1 or u flipped by summation order
    # moves a sum far less than 2^-8 of its largest entry
    for g, p in zip(got, ref):
        assert g.shape == p.shape and _rel_err(g, p) <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,din,dout,r", [(96000, 512, 2048, 32),
                                          (96000, 2048, 512, 32),
                                          (10007, 512, 2048, 12),
                                          (200, 1280, 5120, 32)])
def test_lora_bwd_same_bits_twice_on_card(cuda_device, n, din, dout, r):
    """The clusters' partial sums are added in a fixed order, with no
    atomics: a second call on the same inputs gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    x, dy, a, bm = _lora_inputs(gen, cuda_device, n, din, dout, r)
    runs = [tlb.lora_adapter_bwd(x, dy, a, bm) for _ in range(2)]
    for g0, g1 in zip(*runs):
        assert torch.equal(g0.view(torch.int32), g1.view(torch.int32))


# (B, Tq, T, kv_len, D) at H = 8. The kernel splits each (batch, head) over
# a cluster of CTAs (ops/decode_cross.py::plan), each streaming 16-row
# chunks: at B=2, kv_len 191 / 192 / 193 give splits of 32 rows with the
# last rows one below, at and one past a split's end (and empty CTAs), and
# 1535 / 1536 / 1537 ranges of 192 and 208 rows ending one below, at and
# one past a chunk's end; Tq > 16 takes two m16 tiles, Tq > 32 two query
# groups, Tq > 64 two launches; B=64 runs one CTA per (batch, head).
DECODE_CROSS_CASES = [
    (8, 1, 1500, None, 64), (16, 5, 1500, None, 64), (16, 20, 1500, 1400, 64),
    (2, 64, 300, 257, 32), (3, 3, 100, None, 128), (2, 85, 300, 257, 64),
    (2, 1, 300, 191, 64), (2, 4, 300, 192, 64), (2, 5, 300, 193, 64),
    (2, 16, 1600, 1535, 64), (2, 20, 1600, 1536, 32),
    (2, 63, 1600, 1537, 128), (2, 64, 300, 193, 128), (2, 65, 300, 191, 32),
    (4, 17, 1500, None, 64), (2, 33, 1500, 1400, 64),
    (64, 4, 1500, 1499, 64),
    # head dims past HEAD_DIMS, zero-padded by the wrapper
    (16, 1, 80, None, 24), (2, 5, 300, 193, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_q,t,kv_len,d", DECODE_CROSS_CASES)
def test_decode_cross_kernel_matches_plain_on_card(cuda_device, b, t_q, t,
                                                   kv_len, d):
    """K6 against its plain version. The K/V rows at or past kv_len hold
    NaN in the kernel's inputs (the copy zero-fills them, never reads them),
    zeros in the plain version's."""
    h = 8
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = (torch.randn((b, t_q, h * d), generator=gen, device=cuda_device)
         .to(torch.bfloat16).view(b, t_q, h, d))
    k, v = (torch.randn((b, h, t, d), generator=gen, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    if kv_len is not None:
        kz, vz = (x.clone() for x in (k, v))
        for x in (kz, vz):
            x[:, :, kv_len:] = 0
        for x in (k, v):
            x[:, :, kv_len:] = float("nan")
    else:
        kz, vz = k, v
    before = tdc.launches
    o = tdc.decode_cross(q, k, v, kv_len)
    # one launch per chunk of at most MAX_TQ query rows
    assert tdc.launches == before + -(-t_q // tdc.MAX_TQ)
    assert bool(torch.isfinite(o.float()).all())
    o_p = tdc.decode_cross_plain(q, kz, vz, kv_len)
    # two bf16 ulps of the largest |o| (chip_smoke.py K6_REL_TOL)
    assert _rel_err(o, o_p) <= 2.0 ** -6
    # the [B, T, H*D] entry reads the same cache through other strides: the
    # same bits as the [B, H, T, D] entry on the same one query row (a wider
    # call spreads its rows over other warps and CTAs, so its row 0 sums in
    # another order)
    kb, vb = (x.transpose(1, 2).reshape(b, t, h * d) for x in (k, v))
    o_btc = tdc.decode_cross_btc(q[:, :1], kb, vb, kv_len)
    torch.testing.assert_close(o_btc, tdc.decode_cross(q[:, :1], k, v, kv_len),
                               rtol=0, atol=0)


# (rows, Tmax, idx, Dh) at H = 8. Tmax picks the copy width (the cache
# rows lie Tmax * 2 bytes apart): 16 bytes at 136, 8 at 132, 4 at 134, 2-byte
# loads at 131; idx 0 and Tmax - 1 at each head dim the kernel unrolls (32,
# 64, 128), and 80 between them. Dh 128 at Tmax 448 late in the cache puts V
# after K in one shared buffer (ops/decode_step.py::step_plan).
DECODE_STEP_CASES = [
    (80, 132, 3, 64), (80, 132, 131, 64), (8, 36, 0, 64), (4, 448, 300, 128),
    (5, 20, 10, 32), (64, 52, 51, 64),
    (6, 131, 130, 64), (6, 131, 64, 64), (6, 132, 77, 64),
    (6, 134, 133, 64), (6, 134, 5, 64), (6, 136, 135, 64), (6, 136, 100, 64),
    (3, 40, 0, 32), (3, 40, 39, 32), (3, 131, 0, 64), (3, 131, 130, 64),
    (3, 134, 0, 128), (3, 134, 133, 128), (2, 448, 447, 128),
    (2, 448, 446, 128), (3, 100, 50, 80), (3, 7, 6, 64),
    # the convergence gate's decode: 2 heads of 24
    (16, 48, 47, 24)]


def _step_inputs(gen, device, rows, t_max, idx, dh):
    """q, k_new, v_new and caches with NaN in every column past idx."""
    h = 8
    q, kn, vn = (torch.randn((rows, 1, h * dh), generator=gen,
                             device=device).to(torch.bfloat16)
                 .view(rows, 1, h, dh) for _ in range(3))
    k_t, v_t = (torch.randn((rows, h, dh, t_max), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
    for x in (k_t, v_t):
        x[..., idx + 1:] = float("nan")
    return q, kn, vn, k_t, v_t


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t_max,idx,dh", DECODE_STEP_CASES)
def test_decode_step_kernel_matches_plain_on_card(cuda_device, rows, t_max,
                                                  idx, dh):
    """K7 against its plain version. The cache columns past idx hold NaN
    (a copy may pick them up, the context must not see them); the caches
    after the in-place write equal the plain write bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, kn, vn, k_t, v_t = _step_inputs(gen, cuda_device, rows, t_max, idx,
                                       dh)
    kp, vp = k_t.clone(), v_t.clone()
    before = tds.launches
    ctx = tds.decode_step(q, kn, vn, k_t, v_t, idx)
    assert tds.launches == before + 1
    ctx_p = tds.decode_step_plain(q, kn, vn, kp, vp, idx)
    assert torch.equal(k_t.view(torch.int16), kp.view(torch.int16))
    assert torch.equal(v_t.view(torch.int16), vp.view(torch.int16))
    assert bool(torch.isfinite(ctx.float()).all())
    # a flipped bf16 score rounding, and an ulp of ctx (chip_smoke.py K7_TOL)
    assert (ctx.float() - ctx_p.float()).abs().max().item() <= 2e-2


# (rows, G, Tmax, idx, Dh, broadcast) at H = 8. At 16 rows the kernel splits
# each (row, head) over 4 CTAs of 160 columns (ops/decode_step.py::
# multi_plan): idx 158, 312 and 478 put the G new columns across a range's
# end, 159 just before it. Tmax 3247 was the cap of the one-CTA design;
# 3248 and 8000 lie past it. Tmax % 8 picks the copy width: 16 bytes at
# 512 and 3248, 8 at 516, 4 at 518 and 50, 2-byte loads at 517.
DECODE_STEP_MULTI_CASES = [
    (16, 4, 516, 8, 64, False), (16, 4, 516, 508, 64, False),
    (16, 4, 516, 0, 64, True), (3, 8, 3556, 1000, 64, False),
    (2, 16, 300, 40, 128, False), (5, 2, 20, 7, 32, True),
    (4, 1, 50, 49, 64, False),
    (16, 4, 516, 158, 64, False), (16, 1, 516, 159, 64, False),
    (16, 5, 516, 478, 64, False), (16, 16, 516, 312, 64, False),
    (16, 4, 512, 200, 64, False), (3, 4, 517, 300, 64, False),
    (3, 4, 518, 300, 32, True), (2, 16, 3247, 3000, 64, False),
    (2, 16, 3248, 3231, 64, False), (1, 16, 8000, 7000, 128, False)]


def _multi_inputs(gen, device, rows, g, t_max, idx, dh, broadcast):
    """q, k_new, v_new, the mask (accepted columns before idx with holes, or
    the prefill's contiguous rule broadcast over rows, and the block's own
    columns up to query i), and the caches with NaN in every column that no
    query's mask allows."""
    h = 8
    q, kn, vn = (torch.randn((rows, g, h * dh), generator=gen, device=device)
                 .to(torch.bfloat16).view(rows, g, h, dh) for _ in range(3))
    k_t, v_t = (torch.randn((rows, h, dh, t_max), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
    n = 1 if broadcast else rows
    valid = torch.rand((n, t_max), generator=gen, device=device) < (
        1.0 if broadcast else 0.7)
    valid[:, idx:] = False
    off = torch.arange(t_max, device=device) - idx
    inblock = (off >= 0) & (off <= torch.arange(g, device=device)[:, None])
    mask = valid[:, None, None, :] | inblock[None, None]
    unused = ~mask[:, 0].any(dim=1).expand(rows, t_max)  # [rows, Tmax]
    for x in (k_t, v_t):
        x.masked_fill_(unused[:, None, None, :], float("nan"))
    return q, kn, vn, mask, k_t, v_t, unused


@pytest.mark.cuda
@pytest.mark.parametrize("rows,g,t_max,idx,dh,broadcast",
                         DECODE_STEP_MULTI_CASES)
def test_decode_step_multi_kernel_matches_plain_on_card(
        cuda_device, rows, g, t_max, idx, dh, broadcast):
    """K8 against its plain version. The columns no query allows (holes,
    and every column past idx + G) hold NaN in the kernel's caches: the
    context must stay finite, and the caches after the in-place write equal
    the plain write on the same caches bit for bit. The plain context comes
    from the caches with those columns zeroed."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, kn, vn, mask, k_t, v_t, unused = _multi_inputs(
        gen, cuda_device, rows, g, t_max, idx, dh, broadcast)
    kp, vp = k_t.clone(), v_t.clone()
    kz, vz = (x.masked_fill(unused[:, None, None, :], 0) for x in (k_t, v_t))
    before = tds.multi_launches
    ctx = tds.decode_step_multi(q, kn, vn, mask, k_t, v_t, idx)
    assert tds.multi_launches == before + 1
    tds.decode_step_multi_plain(q, kn, vn, mask, kp, vp, idx)
    ctx_p = tds.decode_step_multi_plain(q, kn, vn, mask, kz, vz, idx)
    assert torch.equal(k_t.view(torch.int16), kp.view(torch.int16))
    assert torch.equal(v_t.view(torch.int16), vp.view(torch.int16))
    assert bool(torch.isfinite(ctx.float()).all())
    # a flipped bf16 score rounding, and an ulp of ctx (chip_smoke.py K8_TOL)
    assert (ctx.float() - ctx_p.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["K6_greedy", "K6_beam_prefill",
                                   "K6_bench_step", "K8_verify",
                                   "K8_straddle", "K7_beam_last",
                                   "K7_greedy_last", "K7_bench_last"])
def test_decode_same_bits_twice_on_card(cuda_device, entry):
    """K6 and K8 merge their CTAs' partial results in a fixed order, and K7
    sums in a fixed order, with no atomics: a second call on the same inputs
    gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    if entry.startswith("K7"):
        rows, t_max = {"K7_beam_last": (80, 132), "K7_greedy_last": (8, 36),
                       "K7_bench_last": (64, 52)}[entry]
        q, kn, vn, k_t, v_t = _step_inputs(gen, cuda_device, rows, t_max,
                                           t_max - 1, 64)
        runs = [tds.decode_step(q, kn, vn, k_t, v_t, t_max - 1)
                for _ in range(2)]
    elif entry.startswith("K6"):
        b, t_q = {"K6_greedy": (8, 1), "K6_beam_prefill": (16, 20),
                  "K6_bench_step": (64, 1)}[entry]
        q = (torch.randn((b, t_q, 8 * 64), generator=gen, device=cuda_device)
             .to(torch.bfloat16).view(b, t_q, 8, 64))
        k, v = (torch.randn((b, 8, 1500, 64), generator=gen,
                            device=cuda_device).to(torch.bfloat16)
                for _ in range(2))
        runs = [tdc.decode_cross(q, k, v) for _ in range(2)]
    else:
        idx = 508 if entry == "K8_verify" else 158
        q, kn, vn, mask, k_t, v_t, _ = _multi_inputs(
            gen, cuda_device, 16, 4, 516, idx, 64, False)
        runs = [tds.decode_step_multi(q, kn, vn, mask, k_t, v_t, idx)
                for _ in range(2)]
    assert torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))


def _bias_row(t, masked, device):
    bias = torch.zeros(t, device=device)
    bias[t - masked:] = tfa.NEG_INF
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,masked", [
    (4, 1536, 8, 64, 36),    # (a) the SP step's encoder at n = 1, cut to B=4
    (8, 384, 8, 64, 384),    # (b) a ring round's fully masked block
    (8, 384, 8, 64, 152),    # (c) a partly masked block
    (2, 256, 4, 32, 100), (2, 256, 2, 128, 0),
    # the edges of the backward's tiles, as in the K2 test above
    (2, 129, 4, 64, 0), (2, 200, 4, 64, 37), (2, 256, 4, 64, 128),
    (2, 384, 4, 64, 36), (1, 129, 2, 128, 28), (2, 200, 4, 32, 64),
    # the edges of the forward's tiles, as in FWD_CASES (B * H = 288: wide
    # CTAs where Tq > 64)
    (18, 129, 16, 64, 0), (18, 200, 16, 64, 37), (18, 256, 16, 64, 128),
    (18, 300, 16, 32, 100), (18, 300, 16, 128, 28), (4, 64, 8, 64, 10),
    (4, 20, 8, 64, 3)])
def test_bias_kernels_match_plain_on_card(cuda_device, b, t, h, d, masked):
    """K4 forward (NaN / -inf rows where the plain version has them) and
    backward against one block with the global o and lse of a two-block
    merge, as ring attention takes them."""
    from neuspeech1_tpu_torch.parallel.ring_attention import merge

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, k2, v2, do = (
        torch.randn((b, t, h * d), generator=gen, device=cuda_device)
        .to(torch.bfloat16).view(b, t, h, d) for _ in range(6))
    bias = _bias_row(t, masked, cuda_device)
    before = (tfa.bias_launches, tfa.bias_bwd_launches)
    o, lse = tfa.flash_bias_fwd(q, k, v, bias)
    o_p, lse_p = tfa.flash_bias_fwd_plain(q, k, v, bias)
    assert torch.equal(torch.isnan(o), torch.isnan(o_p))
    assert torch.equal(torch.isneginf(lse), torch.isneginf(lse_p))
    if masked == t:
        assert torch.isnan(o).all() and torch.isneginf(lse).all()
    else:
        # as K1: one or two bf16 ulps of o (|o| < 1); lse stays f32
        assert (o.float() - o_p.float()).abs().max().item() <= 1e-2
        assert (lse - lse_p).abs().max().item() <= 1e-4
    o2, lse2 = tfa.flash_bias_fwd_plain(q, k2, v2, torch.zeros_like(bias))
    o_g, lse_g = merge(o_p.float(), lse_p, o2.float(), lse2)
    args = (q, k, v, o_g.to(q.dtype), do, lse_g.contiguous(), bias)
    grads = tfa.flash_bias_bwd(*args)
    assert (tfa.bias_launches, tfa.bias_bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
    plain = tfa.flash_bias_bwd_plain(*args)
    for g, p in zip(grads, plain):
        if masked == t:  # every p is 0
            assert not g.any() and not p.any()
        else:  # as K2 (chip_smoke.py K2_REL_TOL)
            assert _rel_err(g, p) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["K2", "K2_causal", "K4"])
def test_backward_same_bits_twice_on_card(cuda_device, entry):
    """The backward kernels use no atomics: a second call on the same inputs
    gives the same bits (the training step's reproducibility)."""
    b, t, h, d = 4, 1500, 8, 64
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   .view(b, t, h, d) for _ in range(4))
    if entry == "K4":
        bias = _bias_row(t, 36, cuda_device)
        o, lse = tfa.flash_bias_fwd(q, k, v, bias)
        runs = [tfa.flash_bias_bwd(q, k, v, o, do, lse, bias)
                for _ in range(2)]
    else:
        causal = entry == "K2_causal"
        o, lse = tfa.flash_attention_bthd(q, k, v, causal, 1400, True)
        runs = [tfa._flash_bwd_cuda(q, k, v, o, do, lse, causal, 1400)
                for _ in range(2)]
    for g1, g2 in zip(*runs):
        assert torch.equal(g1.view(torch.int16), g2.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["K1", "K1_causal", "K1_cross",
                                   "K1_narrow", "K4"])
def test_forward_same_bits_twice_on_card(cuda_device, entry):
    """The forward kernels use no atomics: a second call on the same inputs
    gives the same o and lse, bit for bit (B=8: wide CTAs; B=2: narrow)."""
    b, t, h, d = (2 if entry == "K1_narrow" else 8), 1500, 8, 64
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = (torch.randn((b, t, h * d), generator=gen,
                           device=cuda_device).to(torch.bfloat16)
               .view(b, t, h, d) for _ in range(3))
    if entry == "K4":
        bias = _bias_row(t, 36, cuda_device)
        runs = [tfa.flash_bias_fwd(q, k, v, bias) for _ in range(2)]
    else:
        if entry == "K1_cross":
            q = q[:, :64]
        causal = entry == "K1_causal"
        runs = [tfa.flash_attention_bthd(q, k, v, causal, 1400, True)
                for _ in range(2)]
    (o1, lse1), (o2, lse2) = runs
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(lse1.view(torch.int32), lse2.view(torch.int32))


@pytest.mark.cuda
def test_scale_in_epilogue_is_exact_on_card(cuda_device):
    """At D=64 the backward kernels scale dq and dk by 2^-3 in the epilogue
    instead of multiplying by bf16(k * 2^-3) and bf16(q * 2^-3): the same
    bits, because scaling by a power of two commutes with every rounding of
    the f32 sum (the f32 product on the card, TF32 off, as the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    ds = torch.randn((256, 1536), generator=gen, device=cuda_device)
    ds = ds.to(torch.bfloat16).float()
    k = torch.randn((1536, 64), generator=gen, device=cuda_device)
    k = k.to(torch.bfloat16)
    scale = 64 ** -0.5
    k_s = (k.float() * scale).to(torch.bfloat16)
    assert torch.equal(k_s.float(), k.float() * scale)
    assert torch.equal(ds @ k_s.float(), (ds @ k.float()) * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_valid_len", [1500, 1000])
def test_local_ring_matches_whole_sequence_on_card(cuda_device,
                                                   kv_valid_len):
    """Ring attention over a LocalRing of 4 threads, each calling the ring's
    forward and backward bodies (CUDA autograd would run the ranks'
    backwards on one thread), against K1/K2 on the whole sequence; 16 K4
    launches each way (chip_smoke.py RING_O_TOL, RING_GRAD_REL_TOL)."""
    from neuspeech1_tpu_torch.parallel.ring_attention import (
        LocalRing, ring_bwd, ring_fwd, shard_bias)

    b, t, h, d, n = 2, 1536, 8, 64, 4
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   .view(b, t, h, d) for _ in range(4))
    t_loc = t // n

    def rank(ring):
        rows = slice(ring.rank * t_loc, (ring.rank + 1) * t_loc)
        ql, kl, vl, dol = (x[:, rows] for x in (q, k, v, do))
        bias = shard_bias(t_loc, ring.rank, kv_valid_len, q.device)
        o, lse = ring_fwd(ql, kl, vl, bias, ring)
        return (o, *ring_bwd(ql, kl, vl, bias, o, lse, dol, ring))

    before = (tfa.bias_launches, tfa.bias_bwd_launches)
    parts = LocalRing.run(rank, n)
    assert (tfa.bias_launches - before[0],
            tfa.bias_bwd_launches - before[1]) == (n * n, n * n)
    o, dq, dk, dv = (torch.cat([p[i] for p in parts], 1) for i in range(4))
    o_ref, lse_ref = tfa.flash_attention_bthd(q, k, v, kv_len=kv_valid_len,
                                              return_lse=True)
    refs = tfa._flash_bwd_cuda(q, k, v, o_ref, do, lse_ref, False,
                               kv_valid_len)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    for g, r in zip((dq, dk, dv), refs):
        assert _rel_err(g, r) <= 3e-2
    assert not dk[:, kv_valid_len:].any() and not dv[:, kv_valid_len:].any()


def _probe_inputs(device, seed, n, shape):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(n)]


# rows are the CTA's q rows in warpgroups of 64 (bq256 -> 64, bq512 ->
# 128); n_sub 2 and 4 take turns on 128- and 64-column K tiles; TK 768 with
# n_kb 4 gives 192-column blocks, so K tiles of 64 rows.
@pytest.mark.cuda
@pytest.mark.parametrize("mode,rows,n_sub,n_kb,order,btc,tk", [
    ("base", 128, 1, 1, "head", False, 1536),
    ("base", 64, 1, 1, "qblock", False, 1536),
    ("nomask", 128, 1, 1, "head", False, 1536),
    ("noexp", 64, 1, 1, "head", False, 1536),
    ("bf16exp", 128, 1, 1, "head", False, 1536),
    ("base", 128, 1, 2, "head", False, 1536),
    ("base", 128, 1, 4, "head", False, 1536),
    ("base", 128, 2, 1, "head", False, 1536),
    ("base", 128, 4, 1, "qblock", False, 1536),
    ("base", 128, 1, 1, "head", True, 1536),
    ("nomask", 128, 2, 1, "head", False, 1536),
    ("base", 128, 1, 2, "head", True, 1536),
    ("noexp", 128, 1, 4, "head", False, 768)])
def test_probe_fwd_kernel_matches_plain_on_card(cuda_device, mode, rows,
                                                n_sub, n_kb, order, btc, tk):
    shape = (1, tk, 4 * 64) if btc else (4, tk, 64)
    t_valid = tk * 1500 // 1536
    q, k, v = _probe_inputs(cuda_device, 8, 3, shape)
    before = tpf.launches
    o, lse = tpf.probe_fwd(q, k, v, t_valid, mode=mode, rows=rows,
                           n_sub=n_sub, n_kb=n_kb, order=order, btc=btc,
                           want_lse=True)
    assert tpf.launches == before + 1
    o_p, lse_p = tpf.probe_fwd_plain(q, k, v, t_valid, mode, n_kb, btc)
    # two bf16 ulps of the largest |o|; lse stays f32 ('noexp' sums
    # p = (s - m) * 0.001 + 1 < 0 over the masked columns: lse is NaN in both)
    assert _rel_err(o, o_p) <= 2.0 ** -6
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4, equal_nan=True)
    again = tpf.probe_fwd(q, k, v, t_valid, mode=mode, rows=rows,
                          n_sub=n_sub, n_kb=n_kb, order=order, btc=btc,
                          want_lse=True)
    # no atomics: the same bits every run
    assert torch.equal(o, again[0])
    assert torch.equal(lse.nan_to_num(), again[1].nan_to_num())


def _probe_bwd_inputs(device, tk, btc):
    """q, k, v, o, do and lse ~ N(8, 0.1^2) of four heads over ``tk`` keys,
    from seeded generators."""
    shape = (1, tk, 4 * 64) if btc else (4, tk, 64)
    arrays = _probe_inputs(device, 9, 5, shape)
    gen = torch.Generator(device=device).manual_seed(19)
    lse = 8.0 + 0.1 * torch.randn((4, tk), generator=gen, device=device)
    return arrays + [lse.view(1, 4, tk) if btc else lse]


# Every (ops, rows, btc) pair at the probes' TK and at the CPU tests' TK =
# 256 (two work items a head; t_valid inside the last K/V tile)
@pytest.mark.cuda
@pytest.mark.parametrize("tk,t_valid", [(1536, 1500), (256, 250)])
@pytest.mark.parametrize("ops,rows,btc", [
    (ops, rows, btc) for ops in tpb.OPS for rows in tpb.ROWS
    for btc in (False, True)])
def test_probe_bwd_kernel_matches_plain_on_card(cuda_device, ops, rows, btc,
                                                tk, t_valid):
    args = _probe_bwd_inputs(cuda_device, tk, btc)
    before = tpb.launches
    got = tpb.probe_bwd(*args, t_valid, ops=ops, rows=rows, btc=btc)
    assert tpb.launches == before + 1
    ref = tpb.probe_bwd_plain(*args, t_valid, ops, btc)
    # bf16 operands: a few ulps of the largest gradient (K2's bound); f32
    # operands: the one rounding of the output, flipped by sum order
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= (2e-2 if ops == "bf16" else 1e-2)
    # masked keys get no gradient (rows are dim 1 in both layouts)
    assert not got[1][:, t_valid:].any() and not got[2][:, t_valid:].any()
    again = tpb.probe_bwd(*args, t_valid, ops=ops, rows=rows, btc=btc)
    for g, h in zip(got, again):  # no atomics: the same bits every run
        assert torch.equal(g, h)


# The f32 mode's outputs bit-equal to the f32 gold: at least the share of
# the FFMA kernel this design replaced, on these inputs, less one point
# (chip_smoke.PROBE_BWD_F32_SHARE_FLOOR, with its measurement), and above
# the bf16 mode's share, which a kernel that ran bf16 passes in f32 mode
# would show.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,btc", [(64, False), (32, False), (64, True),
                                      (32, True)])
def test_probe_bwd_f32_mode_is_bit_close_to_the_f32_gold(cuda_device, rows,
                                                          btc):
    import chip_smoke

    args = _probe_bwd_inputs(cuda_device, 1536, btc)
    gold = tpb.probe_bwd_plain(*args, 1500, "f32", btc)
    f32, bf16 = (chip_smoke._bit_share(tpb.probe_bwd(
        *args, 1500, ops=ops, rows=rows, btc=btc), gold)
        for ops in ("f32", "bf16"))
    assert f32 >= chip_smoke.PROBE_BWD_F32_SHARE_FLOOR, (f32, bf16)
    assert bf16 < f32, (f32, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("kdim", [64, 128, 512])
def test_probe_dot_kernel_matches_plain_on_card(cuda_device, kdim):
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    a = torch.randn((3, 512, kdim), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    b = torch.randn((3, kdim, 1536), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    before = tpd.launches
    c = tpd.probe_dot(a, b)
    assert tpd.launches == before + 1
    # one bf16 rounding of the output, flipped by f32 sum order
    assert _rel_err(c, tpd.probe_dot_plain(a, b)) <= 1e-2
    # no atomics: the same bits every run
    assert torch.equal(c, tpd.probe_dot(a, b))


def _clips(rng, b, length, t=6000, ch=208):
    """[b, ch, t] f32 clips of ``length`` samples of signal, zeros after."""
    feats = np.zeros((b, ch, t), np.float32)
    feats[..., :length] = rng.standard_normal((b, ch, length))
    return feats


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upload_staging_is_fenced_on_card(cuda_device, dtype, monkeypatch):
    """Uploads back to back with no synchronize, each of other data, the
    second longer, the third shorter, each copy queued behind ~0.5 s of
    device sleep so the next upload finds it running: every result keeps
    the bits of its input cast on the host (the third would overwrite the
    second's staging without the fence), the buffer grows for the first
    two, and the last two wait on the fence. A shorter upload first warms
    the path up, so that no first-call cost outlasts a sleep."""
    monkeypatch.setattr(common, "_staging", common._Staging())
    rng = np.random.default_rng(0)
    feats = [_clips(rng, 16, n) for n in (1000, 3000, 200)]
    common.upload_features(feats[2], dtype, cuda_device)
    torch.cuda.synchronize()
    before = profiling.counters()
    outs = []
    for f in feats:
        torch.cuda._sleep(1_000_000_000)
        outs.append(common.upload_features(f, dtype, cuda_device))
    changes = profiling.counter_changes(before)
    torch.cuda.synchronize()
    for f, out in zip(feats, outs):
        assert out.dtype == dtype and out.shape == f.shape
        assert torch.equal(out.cpu(), torch.from_numpy(f).to(dtype))
    assert changes.get("upload.staging_allocs") == 2
    assert changes.get("upload.fence_waits") == 2


@pytest.mark.cuda
def test_upload_without_crop_on_card(cuda_device, monkeypatch):
    """``compact=False`` (the speech eval's log-mel, whose padding is not
    zero) copies every sample through the same staging."""
    monkeypatch.setattr(common, "_staging", common._Staging())
    feats = np.random.default_rng(1).standard_normal(
        (8, 80, 3000)).astype(np.float32)
    feats[..., 1000:] = -1.5
    out = common.upload_features(feats, torch.bfloat16, cuda_device,
                                 compact=False)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), torch.from_numpy(feats).to(torch.bfloat16))


@pytest.mark.cuda
def test_upload_staging_under_threads_on_card(cuda_device, monkeypatch):
    """Sixteen threads upload their own clips of other lengths through the
    one staging buffer with the interpreter switching threads every 10 us:
    a write into the buffer while another thread's copy reads it would
    show in a result."""
    monkeypatch.setattr(common, "_staging", common._Staging())
    results, errors = {}, []

    def work(i):
        try:
            rng = np.random.default_rng(100 + i)
            for j in range(4):
                f = _clips(rng, 4, int(rng.integers(100, 6000)), ch=64)
                torch.cuda._sleep(1_000_000)
                results[i, j] = (f, common.upload_features(
                    f, torch.bfloat16, cuda_device))
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    assert len(results) == 64
    for f, out in results.values():
        assert torch.equal(out.cpu(), torch.from_numpy(f).to(torch.bfloat16))


# The routed experts' grouped GEMM at Kimi-VL-A3B's widths (64 experts,
# hidden 2048, expert width 1408): (name, w's shape, trans_w, counts).
# counts: "uneven" draws each expert's rows, empties every fifth expert and
# puts 1 and 129 rows (one past a 128-row tile) in experts 1 and 2;
# "one" puts every row in expert 3; "tiny" puts one row in the first
# expert and none elsewhere.
MOE_CASES = [
    ("gate_up", (64, 2048, 2816), False, "uneven"),
    ("down", (64, 1408, 2048), False, "uneven"),
    ("down_dgrad", (64, 1408, 2048), True, "uneven"),
    ("gate_up_dgrad", (64, 2048, 2816), True, "uneven"),
    ("gate_up_one_expert", (64, 2048, 2816), False, "one"),
    ("down_dgrad_one_expert", (64, 1408, 2048), True, "one"),
    ("down_tiny", (64, 1408, 2048), False, "tiny"),
    ("gate_up_dgrad_tiny", (64, 2048, 2816), True, "tiny"),
]


def _moe_counts(kind: str, experts: int, gen) -> torch.Tensor:
    if kind == "tiny":
        counts = torch.zeros(experts, dtype=torch.long)
        counts[0] = 1
        return counts
    if kind == "one":
        counts = torch.zeros(experts, dtype=torch.long)
        counts[3] = 1000
        return counts
    counts = torch.randint(0, 400, (experts,), generator=gen)
    counts[::5] = 0
    counts[1], counts[2] = 1, 129
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,trans,counts",
                         MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_grouped_gemm_matches_plain(cuda_device, name, shape, trans,
                                        counts):
    """The grouped GEMM against its plain version (per-expert f32 products
    rounded to bf16): every row of every expert written (a row left out
    keeps whatever the allocator's memory held, and misses the gold), each
    value within one bf16 rounding of the f32 product on top of the f32
    sums' order, and the same bits twice."""
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    experts = shape[0]
    c = _moe_counts(counts, experts, gen)
    offs = torch.cat([torch.zeros(1, dtype=torch.long), c.cumsum(0)])
    rows = int(offs[-1])
    k = shape[2] if trans else shape[1]
    x = torch.randn(rows, k, generator=gen).to(torch.bfloat16)
    w = (torch.randn(shape, generator=gen) * k ** -0.5).to(torch.bfloat16)
    x, w = x.to(cuda_device), w.to(cuda_device)
    offs = offs.to(torch.int32).to(cuda_device)
    gold = tmg.grouped_gemm_plain(x.float(), w.float(), offs, trans)
    before = tmg.launches
    y = tmg.grouped_gemm(x, w, offs, trans)
    again = tmg.grouped_gemm(x, w, offs, trans)
    torch.cuda.synchronize()
    assert tmg.launches == before + 2
    assert y.shape == gold.shape and y.dtype == torch.bfloat16
    assert torch.isfinite(y).all()
    err = (y.float() - gold).abs()
    assert float(err.max()) <= 2 ** -7 * float(gold.abs().max()), name
    assert float((y.float() - gold).norm()) <= 4e-3 * float(gold.norm())
    assert torch.equal(y, again)


@pytest.mark.cuda
def test_moe_grouped_gemm_refuses_off_tile_widths(cuda_device):
    x = torch.zeros(4, 96, dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros(2, 96, 256, dtype=torch.bfloat16, device=cuda_device)
    offs = torch.tensor([0, 2, 4], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tmg.grouped_gemm(x, w, offs)
