"""The port's flash attention (neuspeech1_tpu_torch/ops/flash_attention.py),
forward and backward, against the JAX package's Pallas kernels, run in
interpret mode on the CPU.

CPU tensors take the port's plain versions; the CUDA kernels themselves are
checked on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.ops import flash_attention as jfa
from neuspeech1_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# f32 on both sides; the two differ only in summation order and in where
# the row max is taken (the Pallas kernel includes padded columns).
ATOL = 1e-5

CASES = {
    "no_mask": dict(t_q=100, t_kv=100),
    "kv_len": dict(t_q=128, t_kv=128, kv_len=100),
    "causal": dict(t_q=100, t_kv=100, causal=True),
    "cross": dict(t_q=20, t_kv=100),
    # the edges of the CUDA backward's tiles (128 K/V rows and 64 q rows per
    # dk/dv tile, 128 q rows and 64 K/V rows per dq tile): one-row tails,
    # Tk off the tile, kv_len inside a tile and on its boundary, causal
    # over several tiles, the decoder's cross shape, D = 32 and 128
    "tail_1": dict(t_q=129, t_kv=129),
    "kv_200": dict(t_q=65, t_kv=200),
    "kv_len_in_tile": dict(t_q=200, t_kv=200, kv_len=150),
    "kv_len_on_tile": dict(t_q=192, t_kv=256, kv_len=128),
    "causal_tiles": dict(t_q=300, t_kv=300, causal=True),
    "cross_1500": dict(t_q=64, t_kv=1500, b=1),
    "d32": dict(t_q=100, t_kv=100, d=32),
    "d128_causal": dict(t_q=130, t_kv=130, causal=True, d=128),
    # the edges of the CUDA forward's tiles (64 q rows per CTA, 128 K/V rows
    # per tile): short queries over the encoder's length with kv_len, and a
    # single query over a one-row K/V tail
    "cross_1500_kv_len": dict(t_q=64, t_kv=1500, kv_len=1400),
    "kv_129_q1": dict(t_q=1, t_kv=129),
}


def _case_inputs(case, seed=0):
    return _inputs(case["t_q"], case["t_kv"], seed, b=case.get("b", 2),
                   d=case.get("d", 64))


def _inputs(t_q, t_kv, seed=0, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t_q, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t_kv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, t_kv, h, d)).astype(np.float32)
    return q, k, v


def _np_lse(q, k, causal, kv_len):
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * q.shape[-1] ** -0.5
    t_q, t_kv = s.shape[-2:]
    valid = np.arange(t_kv)[None, :] < (kv_len or t_kv)
    if causal:
        valid = valid & (np.arange(t_kv)[None, :] <= np.arange(t_q)[:, None])
    s = np.where(valid, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel(name):
    case = CASES[name]
    causal, kv_len = case.get("causal", False), case.get("kv_len")
    q, k, v = _case_inputs(case)
    ref = np.asarray(jfa.flash_attention_bthd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=kv_len))
    o, lse = tfa.flash_attention_bthd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_len=kv_len, return_lse=True)
    assert o.shape == q.shape and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), ref, rtol=0, atol=ATOL)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, causal, kv_len),
                               rtol=0, atol=ATOL)


def test_plain_bf16_in_bf16_out():
    """bf16 inputs give a bf16 output within bf16 rounding of an f64
    computation on the same (rounded) inputs."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(40, 40, seed=3))
    o = tfa.flash_attention_bthd(q, k, v)
    assert o.dtype == torch.bfloat16
    q64, k64, v64 = (x.double().numpy() for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q64, k64) * 64 ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v64)
    # |o| < 1: bf16 spacing is at most 2^-8, and p is rounded to bf16 too
    np.testing.assert_allclose(o.double().numpy(), ref, rtol=0, atol=1e-2)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: lets the CPU tests follow
    the wrapper's CUDA branch up to the point where it needs the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _on_cuda(x, dtype=torch.bfloat16):
    return torch.from_numpy(x).to(dtype).as_subclass(_OnCuda)


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    def no_plain(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(tfa, "flash_attention_bthd_plain", no_plain)
    monkeypatch.setattr(tfa, "_library", no_library)
    q, k, v = (_on_cuda(x) for x in _inputs(64, 64))
    before = tfa.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tfa.flash_attention_bthd(q, k, v)
    assert tfa.launches == before


# requires_grad: an input that needs a gradient goes through the autograd
# Function, whose forward validates like the plain call. A head dim past
# 128 is refused; one under it outside HEAD_DIMS is zero-padded to the next
# (`kernel_head_dim`), as the TPU kernels take any head dim.
REJECTS = {"head_dim": "head dim 160", "dtype": "takes bfloat16",
           "requires_grad": "head dim 160",
           "strided_head": "contiguous head dim",
           "causal_shape": "Tq == Tkv", "kv_len": "kv_len=0"}


@pytest.mark.parametrize("bad", list(REJECTS))
def test_cuda_path_rejects_what_kernel_does_not_take(monkeypatch, bad):
    def no_library():
        raise AssertionError("validation must fail before the launch")

    monkeypatch.setattr(tfa, "_library", no_library)
    d = 160 if bad in ("head_dim", "requires_grad") else 64
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    t_kv = 80 if bad == "causal_shape" else 64
    q = _on_cuda(_inputs(64, 64, d=d)[0], dtype)
    k, v = (_on_cuda(x, dtype) for x in _inputs(64, t_kv, d=d)[1:])
    if bad == "requires_grad":
        q.requires_grad_(True)
    if bad == "strided_head":  # same shape, head dim not contiguous
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match=REJECTS[bad]):
        tfa.flash_attention_bthd(q, k, v, causal=bad == "causal_shape",
                                 kv_len=0 if bad == "kv_len" else None)


def _jax_grads(q, k, v, do, causal, kv_len):
    def f(q, k, v):
        return jfa.flash_attention_bthd(q, k, v, causal=causal, kv_len=kv_len)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_grads(q, k, v, do, causal, kv_len, fn=None):
    fn = fn or (lambda q, k, v: tfa.flash_attention_bthd(
        q, k, v, causal=causal, kv_len=kv_len))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fn(q, k, v)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax_kernel(name):
    """dq, dk, dv through the port's FlashAttention (plain forward and
    backward on the CPU) against jax.grad through the Pallas forward and
    backward kernels, f32, max-abs 1e-5 as for the forward."""
    case = CASES[name]
    causal, kv_len = case.get("causal", False), case.get("kv_len")
    q, k, v = _case_inputs(case, seed=5)
    do = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    before = tfa.bwd_launches
    o_ref, g_ref = _jax_grads(q, k, v, do, causal, kv_len)
    o, grads = _torch_grads(q, k, v, do, causal, kv_len)
    np.testing.assert_allclose(o, o_ref, rtol=0, atol=ATOL)
    for got, ref, n in zip(grads, g_ref, "qkv"):
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=n)
    if kv_len is not None:  # K/V rows past kv_len: exactly zero
        assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()
        assert grads[1][:, :kv_len].any()
    assert tfa.bwd_launches == before  # CPU tensors never reach the kernel


def test_bwd_plain_bf16_rounding_points():
    """In bf16 the plain backward rounds where the TPU kernel does: its
    grads are bf16 and lie within bf16 rounding of an f64 autograd
    reference on the same rounded inputs."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(40, 40, seed=7))
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    o, lse = tfa.flash_attention_bthd_plain(q, k, v, return_lse=True)
    grads = tfa.flash_attention_bthd_bwd_plain(q, k, v, o, do, lse)
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * 64 ** -0.5
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)
    o64.backward(do.double())
    for got, x in zip(grads, (q64, k64, v64)):
        assert got.dtype == torch.bfloat16
        ref = x.grad
        # |g| < 4 here: bf16 spacing 2^-6 at most, and p, ds rounded too
        assert (got.double() - ref).abs().max().item() <= 5e-2


def test_bhtd_entry_equals_bthd_entry():
    """The [B, H, T, D] entry (the JAX package's flash_attention, K5) is
    the BTHD entry on transposed views: equal outputs and grads."""
    q, k, v = _inputs(50, 50, seed=9)
    do = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)

    def bhtd(q, k, v):
        return tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True
                                   ).transpose(1, 2)

    o1, g1 = _torch_grads(q, k, v, do, True, None)
    o2, g2 = _torch_grads(q, k, v, do, True, None, fn=bhtd)
    np.testing.assert_array_equal(o1, o2)
    for a, b in zip(g1, g2):
        np.testing.assert_array_equal(a, b)
    ref = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        causal=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o2, ref, rtol=0, atol=ATOL)


def test_cuda_backward_never_takes_plain_path(monkeypatch):
    """Through autograd on CUDA tensors the backward launches the kernel or
    raises: with its library failing to load it raises, and the plain
    backward is never called."""
    def no_plain(*a, **kw):
        raise AssertionError("plain backward called for a CUDA tensor")

    def no_library():
        raise RuntimeError("backward kernel library unavailable")

    def fwd_on_cpu(q, k, v, causal, kv_len):  # stands in for the K1 launch
        o, lse = tfa.flash_attention_bthd_plain(
            *(torch.Tensor(x) for x in (q, k, v)), causal, kv_len, True)
        return o.as_subclass(_OnCuda), lse.as_subclass(_OnCuda)

    monkeypatch.setattr(tfa, "_flash_fwd_cuda", fwd_on_cpu)
    # autograd saves o and lse without the CUDA disguise; the operand
    # checks have their own test above
    monkeypatch.setattr(tfa, "_check_cuda_operand", lambda *a: None)
    monkeypatch.setattr(tfa, "flash_attention_bthd_bwd_plain", no_plain)
    monkeypatch.setattr(tfa, "_bwd_library", no_library)
    q, k, v = (_on_cuda(x).requires_grad_() for x in _inputs(64, 64))
    before = tfa.bwd_launches
    o = tfa.flash_attention_bthd(q, k, v)
    with pytest.raises(RuntimeError, match="backward kernel library"):
        o.sum().backward()
    assert tfa.bwd_launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_in_epilogue_is_exact_at_d64(seed):
    """At D=64 the CUDA backward multiplies by k and q and scales dq and dk
    by 2^-3 once, where the TPU kernel multiplies by bf16(k * scale) and
    bf16(q * scale): scaling by a power of two commutes with the bf16
    rounding of the operand and with every rounding of the f32 sum, so the
    two give the same bits (the card test repeats this on cuBLAS)."""
    rng = np.random.default_rng(seed)
    ds = torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32))
    ds = ds.to(torch.bfloat16).float()
    k = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    k = k.to(torch.bfloat16)
    scale = 64 ** -0.5
    k_s = (k.float() * scale).to(torch.bfloat16)
    assert torch.equal(k_s.float(), k.float() * scale)
    assert torch.equal(ds @ k_s.float(), (ds @ k.float()) * scale)
