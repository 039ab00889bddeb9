"""The decode kernels' plain versions in the port against the JAX package's
TPU kernels, which run in interpret mode on the CPU: decode cross-attention
(neuspeech1_tpu_torch/ops/decode_cross.py against
``flash_decode_cross`` and ``flash_decode_cross_btc``) and the fused
self-attention decode step (ops/decode_step.py against
``fused_self_decode``). In f32 the two differ only by summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.ops.decode_step import fused_self_decode
from neuspeech1_tpu.ops.flash_attention import (flash_decode_cross,
                                                flash_decode_cross_btc)
from neuspeech1_tpu_torch.ops import decode_cross as tdc
from neuspeech1_tpu_torch.ops import decode_step as tds
from tests.test_torch_flash_attention import _on_cuda

torch.set_num_threads(1)

# f32: summation order only. bf16 inputs: a few bf16 ulps of |o| < 1 where
# the two round at the same points (and, for the btc kernel, where the TPU
# rounded each q*k product to bf16 and the port does not).
F32_ATOL = 1e-5
BF16_ATOL = 1e-2


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor in ``dtype``."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return j, t


def _close(ours: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("tq", [1, 3, 15])
def test_decode_cross_plain_matches_jax(tq, d, dtype, atol):
    """[B, H, T, D] cache, cache rows past kv_len masked."""
    rng = np.random.default_rng(10 * tq + d)
    b, h, t, kv_len = 2, 4, 150, 131
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((b, tq, h, d), (b, h, t, d), (b, h, t, d)))
    ref = flash_decode_cross(qj, kj, vj, kv_len=kv_len)
    ours = tdc.decode_cross(qt, kt, vt, kv_len)
    assert ours.shape == (b, tq, h, d) and ours.dtype == qt.dtype
    _close(ours, ref, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("b,h,d,t,t_pad", [(2, 8, 64, 37, 40),
                                           (3, 4, 32, 16, 16),
                                           (1, 2, 128, 50, 56)])
def test_decode_cross_btc_plain_matches_jax(b, h, d, t, t_pad, dtype, atol):
    """[B, Tpad, H*D] cache with zero-padded rows past kv_len."""
    rng = np.random.default_rng(3 + t)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t_pad, h * d)).astype(np.float32)
            for _ in range(2))
    k[:, t:] = v[:, t:] = 0.0
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    ref = flash_decode_cross_btc(qj, kj, vj, kv_len=t)
    ours = tdc.decode_cross_btc(qt, kt, vt, t)
    assert ours.shape == (b, 1, h, d)
    _close(ours, ref, atol)


def test_decode_cross_rejects_bad_arguments():
    q = torch.zeros((2, 1, 4, 32))
    k = torch.zeros((2, 4, 10, 32))
    with pytest.raises(ValueError, match="kv_len"):
        tdc.decode_cross(q, k, k, kv_len=11)
    with pytest.raises(ValueError, match="shape mismatch"):
        tdc.decode_cross(q, k[:1], k[:1])
    with pytest.raises(ValueError, match="decode_cross_btc"):
        tdc.decode_cross_btc(torch.zeros((2, 2, 4, 32)), k[:, 0], k[:, 0])


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("idx", [0, 5, 35])
def test_decode_step_plain_matches_jax(idx, dtype, atol):
    """The caches after the in-place write equal the kernel's aliased
    outputs exactly; the context agrees within summation order."""
    rng = np.random.default_rng(idx)
    b, h, dh, t_max = 3, 4, 64, 36
    q, kn, vn = (rng.standard_normal((b, 1, h, dh)).astype(np.float32)
                 for _ in range(3))
    # earlier columns hold values, later ones garbage that must be ignored
    k_t, v_t = (rng.standard_normal((b, h, dh, t_max)).astype(np.float32)
                for _ in range(2))
    (qj, qt), (knj, knt), (vnj, vnt), (kj, kt), (vj, vt) = (
        _pair(x, dtype) for x in (q, kn, vn, k_t, v_t))
    ctx_ref, k_ref, v_ref = fused_self_decode(qj, knj, vnj, kj, vj,
                                              jnp.int32(idx))
    ctx = tds.decode_step(qt, knt, vnt, kt, vt, idx)
    np.testing.assert_array_equal(kt.float().numpy(),
                                  np.asarray(k_ref.astype(jnp.float32)))
    np.testing.assert_array_equal(vt.float().numpy(),
                                  np.asarray(v_ref.astype(jnp.float32)))
    assert ctx.shape == (b, 1, h, dh) and ctx.dtype == qt.dtype
    _close(ctx, ctx_ref, atol)


def test_decode_step_attends_only_written_columns():
    """Columns past cache_index never reach the context."""
    rng = np.random.default_rng(7)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((2, 1, 2, 32))
                                  .astype(np.float32)) for _ in range(3))
    k_t, v_t = (torch.from_numpy(rng.standard_normal((2, 2, 32, 12))
                                 .astype(np.float32)) for _ in range(2))
    k2, v2 = k_t.clone(), v_t.clone()
    k2[..., 5:], v2[..., 5:] = 1e4, -1e4
    a = tds.decode_step(q, kn, vn, k_t, v_t, 4)
    b = tds.decode_step(q, kn, vn, k2, v2, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cache_index"):
        tds.decode_step(q, kn, vn, k_t, v_t, 12)


def _no_plain(*a, **kw):
    raise AssertionError("plain version called for a CUDA tensor")


def _no_library():
    raise RuntimeError("kernel library unavailable")


@pytest.mark.parametrize("kernel", ["decode_cross", "decode_step"])
def test_cuda_tensor_never_takes_plain_path(monkeypatch, kernel):
    """On a CUDA tensor each wrapper goes for its kernel (here: a library
    that cannot load) and never for the plain version."""
    rng = np.random.default_rng(8)
    if kernel == "decode_cross":
        monkeypatch.setattr(tdc, "decode_cross_plain", _no_plain)
        monkeypatch.setattr(tdc, "_library", _no_library)
        args = (_on_cuda(rng.standard_normal((2, 5, 4, 64))),
                _on_cuda(rng.standard_normal((2, 4, 300, 64))),
                _on_cuda(rng.standard_normal((2, 4, 300, 64))))
        call, mod = tdc.decode_cross, tdc
    else:
        monkeypatch.setattr(tds, "decode_step_plain", _no_plain)
        monkeypatch.setattr(tds, "_library", _no_library)
        args = (*(_on_cuda(rng.standard_normal((2, 1, 4, 64)))
                  for _ in range(3)),
                *(_on_cuda(rng.standard_normal((2, 4, 64, 20)))
                  for _ in range(2)), 7)
        call, mod = tds.decode_step, tds
    before = mod.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        call(*args)
    assert mod.launches == before


@pytest.mark.parametrize("tq", [64, 65, 150])
def test_decode_cross_cuda_chunks_long_queries(monkeypatch, tq):
    """On a CUDA tensor a query of more than MAX_TQ rows goes to the kernel
    in chunks of at most MAX_TQ rows (here a stand-in running the plain
    version), joined in order."""
    seen = []

    def kernel(q, k, v, kv_len):
        seen.append(q.shape[1])
        return tdc.decode_cross_plain(*(x.as_subclass(torch.Tensor)
                                        for x in (q, k, v)), kv_len)

    monkeypatch.setattr(tdc, "_decode_cross_cuda", kernel)
    rng = np.random.default_rng(11)
    q = _on_cuda(rng.standard_normal((2, tq, 4, 32)), torch.float32)
    k, v = (_on_cuda(rng.standard_normal((2, 4, 40, 32)), torch.float32)
            for _ in range(2))
    ours = tdc.decode_cross(q, k, v, 37)
    assert seen == [min(tdc.MAX_TQ, tq - i) for i in range(0, tq, tdc.MAX_TQ)]
    ref = tdc.decode_cross_plain(*(x.as_subclass(torch.Tensor)
                                   for x in (q, k, v)), 37)
    # f32 einsums over fewer rows may sum in another order
    torch.testing.assert_close(ours.as_subclass(torch.Tensor), ref, rtol=0,
                               atol=F32_ATOL)


CROSS_REJECTS = {"dtype": "takes bfloat16", "head_dim": "head dim 48",
                 "strided_head": "contiguous head dim"}


@pytest.mark.parametrize("bad", list(CROSS_REJECTS))
def test_decode_cross_cuda_rejects_what_kernel_does_not_take(monkeypatch,
                                                             bad):
    monkeypatch.setattr(tdc, "_library", _no_library)
    rng = np.random.default_rng(9)
    d = 48 if bad == "head_dim" else 64
    tq = 3
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    q = _on_cuda(rng.standard_normal((2, tq, 4, d)), dtype)
    k = _on_cuda(rng.standard_normal((2, 4, 40, d)), dtype)
    if bad == "strided_head":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match=CROSS_REJECTS[bad]):
        tdc.decode_cross(q, k, k)


STEP_REJECTS = {"dtype": "takes bfloat16", "t_max": "Tmax <= 448",
                "head_dim": "Dh <= 128", "strided_cache": "contiguous"}


@pytest.mark.parametrize("bad", list(STEP_REJECTS))
def test_decode_step_cuda_rejects_what_kernel_does_not_take(monkeypatch,
                                                            bad):
    monkeypatch.setattr(tds, "_library", _no_library)
    rng = np.random.default_rng(10)
    dh = 256 if bad == "head_dim" else 64
    t = 449 if bad == "t_max" else 20
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    q = _on_cuda(rng.standard_normal((2, 1, 4, dh)), dtype)
    cache = _on_cuda(rng.standard_normal((2, 4, dh, t)), dtype)
    if bad == "strided_cache":
        cache = cache.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match=STEP_REJECTS[bad]):
        tds.decode_step(q, q, q, cache, cache.clone(), 3)
