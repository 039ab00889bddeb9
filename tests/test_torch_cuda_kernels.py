"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU, nvcc and no JAX; skips without a GPU. The machine with
the card has no JAX, and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import pytest
import torch

from neuspeech1_tpu_torch.ops import flash_attention as tfa
from neuspeech1_tpu_torch.ops import lora_bwd as tlb


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
    ((1, 100, 2, 32), 100, False, None)])
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
