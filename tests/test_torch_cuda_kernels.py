"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU, nvcc and no JAX; skips without a GPU. The machine with
the card has no JAX, and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import pytest
import torch

from neuspeech1_tpu_torch.ops import decode_cross as tdc
from neuspeech1_tpu_torch.ops import decode_step as tds
from neuspeech1_tpu_torch.ops import flash_attention as tfa
from neuspeech1_tpu_torch.ops import lora_bwd as tlb
from neuspeech1_tpu_torch.ops import probe_bwd as tpb
from neuspeech1_tpu_torch.ops import probe_dot as tpd
from neuspeech1_tpu_torch.ops import probe_fwd as tpf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,kv_len", [
    ((2, 300, 8, 64), False, None), ((2, 300, 8, 64), False, 257),
    ((2, 130, 4, 64), True, None), ((1, 100, 2, 32), False, None),
    ((1, 100, 2, 128), True, None)])
def test_kernel_matches_plain_on_card(cuda_device, shape, causal, kv_len):
    b, t, h, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, t, h * d), generator=gen, device=cuda_device)
               .to(torch.bfloat16).view(b, t, h, d) for _ in range(3))
    before = tfa.launches
    o, lse = tfa.flash_attention_bthd(q, k, v, causal, kv_len, True)
    assert tfa.launches == before + 1
    o_p, lse_p = tfa.flash_attention_bthd_plain(q, k, v, causal, kv_len, True)
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
    ((1, 129, 4, 32), 129, False, None), ((1, 200, 4, 32), 200, True, 190)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,din,dout,r", [(4096, 512, 2048, 32),
                                          (1000, 256, 128, 12),
                                          (70, 128, 64, 64),
                                          # rank < the padded rank over
                                          # three 2048-token partials
                                          (5000, 256, 128, 12)])
def test_lora_bwd_kernel_matches_plain_on_card(cuda_device, n, din, dout, r):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, dy = (torch.randn((n, w), generator=gen, device=cuda_device)
             .to(torch.bfloat16) for w in (din, dout))
    a = (0.1 * torch.randn((din, r), generator=gen, device=cuda_device)
         ).to(torch.bfloat16)
    bm = (0.1 * torch.randn((r, dout), generator=gen, device=cuda_device)
          ).to(torch.bfloat16)
    before = tlb.launches
    got = tlb.lora_adapter_bwd(x, dy, a, bm)
    assert tlb.launches == before + 1
    ref = tlb.lora_adapter_bwd_plain(x, dy, a, bm)
    # f32 outputs; a bf16 rounding of t1 or u flipped by summation order
    # moves a sum far less than 2^-8 of its largest entry
    for g, p in zip(got, ref):
        assert g.shape == p.shape and _rel_err(g, p) <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_q,t,kv_len,d", [
    (8, 1, 1500, None, 64), (16, 5, 1500, None, 64), (16, 20, 1500, 1400, 64),
    (2, 64, 300, 257, 32), (3, 3, 100, None, 128), (2, 85, 300, 257, 64)])
def test_decode_cross_kernel_matches_plain_on_card(cuda_device, b, t_q, t,
                                                   kv_len, d):
    h = 8
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = (torch.randn((b, t_q, h * d), generator=gen, device=cuda_device)
         .to(torch.bfloat16).view(b, t_q, h, d))
    k, v = (torch.randn((b, h, t, d), generator=gen, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    before = tdc.launches
    o = tdc.decode_cross(q, k, v, kv_len)
    # one launch per chunk of at most MAX_TQ query rows
    assert tdc.launches == before + -(-t_q // tdc.MAX_TQ)
    o_p = tdc.decode_cross_plain(q, k, v, kv_len)
    # two bf16 ulps of the largest |o| (chip_smoke.py K6_REL_TOL)
    assert _rel_err(o, o_p) <= 2.0 ** -6
    # the [B, T, H*D] entry reads the same cache through other strides
    kb, vb = (x.transpose(1, 2).reshape(b, t, h * d) for x in (k, v))
    o_btc = tdc.decode_cross_btc(q[:, :1], kb, vb, kv_len)
    torch.testing.assert_close(o_btc, o[:, :1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t_max,idx,dh", [
    (80, 132, 3, 64), (80, 132, 131, 64), (8, 36, 0, 64), (4, 448, 300, 128),
    (5, 20, 10, 32)])
def test_decode_step_kernel_matches_plain_on_card(cuda_device, rows, t_max,
                                                  idx, dh):
    h = 8
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, kn, vn = (torch.randn((rows, 1, h * dh), generator=gen,
                             device=cuda_device).to(torch.bfloat16)
                 .view(rows, 1, h, dh) for _ in range(3))
    k_t, v_t = (torch.randn((rows, h, dh, t_max), generator=gen,
                            device=cuda_device).to(torch.bfloat16)
                for _ in range(2))
    kp, vp = k_t.clone(), v_t.clone()
    before = tds.launches
    ctx = tds.decode_step(q, kn, vn, k_t, v_t, idx)
    assert tds.launches == before + 1
    ctx_p = tds.decode_step_plain(q, kn, vn, kp, vp, idx)
    assert torch.equal(k_t, kp) and torch.equal(v_t, vp)
    # a flipped bf16 score rounding, and an ulp of ctx (chip_smoke.py K7_TOL)
    assert (ctx.float() - ctx_p.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,g,t_max,idx,dh,broadcast", [
    (16, 4, 516, 8, 64, False), (16, 4, 516, 508, 64, False),
    (16, 4, 516, 0, 64, True), (3, 8, 3556, 1000, 64, False),
    (2, 16, 300, 40, 128, False), (5, 2, 20, 7, 32, True),
    (4, 1, 50, 49, 64, False)])
def test_decode_step_multi_kernel_matches_plain_on_card(
        cuda_device, rows, g, t_max, idx, dh, broadcast):
    h = 8
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, kn, vn = (torch.randn((rows, g, h * dh), generator=gen,
                             device=cuda_device).to(torch.bfloat16)
                 .view(rows, g, h, dh) for _ in range(3))
    k_t, v_t = (torch.randn((rows, h, dh, t_max), generator=gen,
                            device=cuda_device).to(torch.bfloat16)
                for _ in range(2))
    # accepted columns before idx with holes (or the prefill's contiguous
    # rule, broadcast over rows), and the block's own columns up to query i
    n = 1 if broadcast else rows
    valid = torch.rand((n, t_max), generator=gen, device=cuda_device) < (
        1.0 if broadcast else 0.7)
    valid[:, idx:] = False
    off = torch.arange(t_max, device=cuda_device) - idx
    inblock = (off >= 0) & (off <= torch.arange(g, device=cuda_device)[:, None])
    mask = valid[:, None, None, :] | inblock[None, None]
    kp, vp = k_t.clone(), v_t.clone()
    before = tds.multi_launches
    ctx = tds.decode_step_multi(q, kn, vn, mask, k_t, v_t, idx)
    assert tds.multi_launches == before + 1
    ctx_p = tds.decode_step_multi_plain(q, kn, vn, mask, kp, vp, idx)
    assert torch.equal(k_t, kp) and torch.equal(v_t, vp)
    # a flipped bf16 score rounding, and an ulp of ctx (chip_smoke.py K8_TOL)
    assert (ctx.float() - ctx_p.float()).abs().max().item() <= 2e-2


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
    (2, 384, 4, 64, 36), (1, 129, 2, 128, 28), (2, 200, 4, 32, 64)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rows,n_sub,n_kb,order,btc", [
    ("base", 32, 1, 1, "head", False), ("base", 16, 1, 1, "qblock", False),
    ("nomask", 32, 1, 1, "head", False), ("noexp", 16, 1, 1, "head", False),
    ("bf16exp", 32, 1, 1, "head", False), ("base", 32, 1, 2, "head", False),
    ("base", 32, 1, 4, "head", False), ("base", 32, 2, 1, "head", False),
    ("base", 32, 4, 1, "qblock", False), ("base", 32, 1, 1, "head", True)])
def test_probe_fwd_kernel_matches_plain_on_card(cuda_device, mode, rows,
                                                n_sub, n_kb, order, btc):
    shape = (1, 1536, 4 * 64) if btc else (4, 1536, 64)
    q, k, v = _probe_inputs(cuda_device, 8, 3, shape)
    before = tpf.launches
    o, lse = tpf.probe_fwd(q, k, v, 1500, mode=mode, rows=rows, n_sub=n_sub,
                           n_kb=n_kb, order=order, btc=btc, want_lse=True)
    assert tpf.launches == before + 1
    o_p, lse_p = tpf.probe_fwd_plain(q, k, v, 1500, mode, n_kb, btc)
    # two bf16 ulps of the largest |o|; lse stays f32 ('noexp' sums
    # p = (s - m) * 0.001 + 1 < 0 over the masked columns: lse is NaN in both)
    assert _rel_err(o, o_p) <= 2.0 ** -6
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("ops,rows,btc", [
    ("bf16", 64, False), ("bf16", 32, False), ("f32", 64, False),
    ("f32", 32, True)])
def test_probe_bwd_kernel_matches_plain_on_card(cuda_device, ops, rows, btc):
    shape = (1, 1536, 4 * 64) if btc else (4, 1536, 64)
    q, k, v, o, do = _probe_inputs(cuda_device, 9, 5, shape)
    lse = 8.0 + 0.1 * torch.randn((4, 1536), device=cuda_device)
    lse = lse.view(1, 4, 1536) if btc else lse
    before = tpb.launches
    got = tpb.probe_bwd(q, k, v, o, do, lse, 1500, ops=ops, rows=rows,
                        btc=btc)
    assert tpb.launches == before + 1
    ref = tpb.probe_bwd_plain(q, k, v, o, do, lse, 1500, ops, btc)
    # bf16 operands: a few ulps of the largest gradient (K2's bound); f32
    # operands: the one rounding of the output, flipped by sum order
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= (2e-2 if ops == "bf16" else 1e-2)
    # masked keys get no gradient (rows are dim 1 in both layouts)
    assert not got[1][:, 1500:].any() and not got[2][:, 1500:].any()
    again = tpb.probe_bwd(q, k, v, o, do, lse, 1500, ops=ops, rows=rows,
                          btc=btc)
    for g, h in zip(got, again):  # no atomics: the same bits every run
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("kdim", [64, 512])
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
