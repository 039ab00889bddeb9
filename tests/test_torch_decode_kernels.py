"""The decode kernels' plain versions in the port against the JAX package's
TPU kernels, which run in interpret mode on the CPU: decode cross-attention
(neuspeech1_tpu_torch/ops/decode_cross.py against
``flash_decode_cross`` and ``flash_decode_cross_btc``) and the fused
self-attention decode steps (ops/decode_step.py against
``fused_self_decode`` and ``fused_self_decode_multi``). In f32 the two
differ only by summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.ops.decode_step import (fused_self_decode,
                                            fused_self_decode_multi)
from neuspeech1_tpu.ops.flash_attention import (flash_decode_cross,
                                                flash_decode_cross_btc)
from neuspeech1_tpu_torch.ops import decode_cross as tdc
from neuspeech1_tpu_torch.ops import decode_step as tds
from tests.test_torch_flash_attention import _OnCuda, _on_cuda

torch.set_num_threads(1)

# f32: summation order only. bf16 inputs: a few bf16 ulps of |o| < 1 where
# the two round at the same points (and, for the btc kernel, where the TPU
# rounded each q*k product to bf16 and the port does not).
F32_ATOL = 1e-5
BF16_ATOL = 1e-2
# K8 in bf16: the bound of the JAX package's own K8 test
# (tests/test_decode_step_kernel.py::test_fused_multi_matches_xla)
MULTI_BF16_ATOL = 2e-2


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


@pytest.mark.parametrize("kernel", ["decode_cross", "decode_step",
                                    "decode_step_multi"])
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
    elif kernel == "decode_step":
        monkeypatch.setattr(tds, "decode_step_plain", _no_plain)
        monkeypatch.setattr(tds, "_library", _no_library)
        args = (*(_on_cuda(rng.standard_normal((2, 1, 4, 64)))
                  for _ in range(3)),
                *(_on_cuda(rng.standard_normal((2, 4, 64, 20)))
                  for _ in range(2)), 7)
        call, mod = tds.decode_step, tds
    else:
        monkeypatch.setattr(tds, "decode_step_multi_plain", _no_plain)
        monkeypatch.setattr(tds, "_multi_library", _no_library)
        mask = torch.ones((1, 1, 4, 20), dtype=torch.bool).as_subclass(_OnCuda)
        args = (*(_on_cuda(rng.standard_normal((2, 4, 4, 64)))
                  for _ in range(3)), mask,
                *(_on_cuda(rng.standard_normal((2, 4, 64, 20)))
                  for _ in range(2)), 7)
        call, mod = tds.decode_step_multi, tds
    counter = "multi_launches" if kernel == "decode_step_multi" else "launches"
    before = getattr(mod, counter)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        call(*args)
    assert getattr(mod, counter) == before


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


# a head dim past 128 is refused; one under it outside the kernel's head
# dims is zero-padded to the next (`ops/flash_attention.py::kernel_head_dim`)
CROSS_REJECTS = {"dtype": "takes bfloat16", "head_dim": "head dim 160",
                 "strided_head": "contiguous head dim"}


@pytest.mark.parametrize("bad", list(CROSS_REJECTS))
def test_decode_cross_cuda_rejects_what_kernel_does_not_take(monkeypatch,
                                                             bad):
    monkeypatch.setattr(tdc, "_library", _no_library)
    rng = np.random.default_rng(9)
    d = 160 if bad == "head_dim" else 64
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


def _spec_mask(rng, b, g, t_max, idx, broadcast=False):
    """A verify step's mask [B or 1, 1, G, Tmax]: accepted columns before
    idx with random holes (rejected drafts), and for query i the block's own
    columns idx .. idx + i. ``broadcast``: the prefill's contiguous rule
    [1, 1, G, Tmax] (every column before idx + i)."""
    if broadcast:
        valid = np.zeros((1, t_max), bool)
        valid[:, :idx] = True
    else:
        valid = rng.random((b, t_max)) < 0.7
        valid[:, idx:] = False
    off = np.arange(t_max)[None, None, None, :] - idx
    inblock = (off >= 0) & (off <= np.arange(g)[None, None, :, None])
    return valid[:, None, None, :] | inblock


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL),
                                        ("bfloat16", MULTI_BF16_ATOL)])
@pytest.mark.parametrize("g,idx,broadcast", [
    (2, 0, True), (4, 0, True), (2, 5, False), (4, 9, False),
    (4, 36, False), (2, 38, False), (4, 17, True)])
def test_decode_step_multi_plain_matches_jax(g, idx, broadcast, dtype, atol):
    """K8's plain version against ``fused_self_decode_multi``: the caches
    after the in-place writes equal the kernel's aliased outputs exactly;
    the context agrees within the JAX test's bounds (summation order in
    f32; a flipped bf16 rounding of a score or a probability in bf16)."""
    rng = np.random.default_rng(100 * g + idx)
    b, h, dh, t_max = 3, 2, 16, 40
    q, kn, vn = (rng.standard_normal((b, g, h, dh)).astype(np.float32)
                 for _ in range(3))
    # columns past the block hold garbage the mask must keep out
    k_t, v_t = (rng.standard_normal((b, h, dh, t_max)).astype(np.float32)
                for _ in range(2))
    mask = _spec_mask(rng, b, g, t_max, idx, broadcast)
    (qj, qt), (knj, knt), (vnj, vnt), (kj, kt), (vj, vt) = (
        _pair(x, dtype) for x in (q, kn, vn, k_t, v_t))
    ctx_ref, k_ref, v_ref = fused_self_decode_multi(
        qj, knj, vnj, jnp.asarray(mask), kj, vj, jnp.int32(idx))
    ctx = tds.decode_step_multi(qt, knt, vnt, torch.from_numpy(mask), kt, vt,
                                idx)
    np.testing.assert_array_equal(kt.float().numpy(),
                                  np.asarray(k_ref.astype(jnp.float32)))
    np.testing.assert_array_equal(vt.float().numpy(),
                                  np.asarray(v_ref.astype(jnp.float32)))
    assert ctx.shape == (b, g, h, dh) and ctx.dtype == qt.dtype
    _close(ctx, ctx_ref, atol)


def test_decode_step_multi_attends_only_allowed_columns():
    """Columns the mask leaves out (holes, the tail past the block) never
    reach the context; a column range past Tmax is refused."""
    rng = np.random.default_rng(12)
    b, g, h, dh, t_max, idx = 2, 3, 2, 8, 16, 6
    q, kn, vn = (torch.from_numpy(rng.standard_normal((b, g, h, dh))
                                  .astype(np.float32)) for _ in range(3))
    k_t, v_t = (torch.from_numpy(rng.standard_normal((b, h, dh, t_max))
                                 .astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(_spec_mask(rng, b, g, t_max, idx))
    k2, v2 = k_t.clone(), v_t.clone()
    outside = ~mask[:, 0].any(dim=1)                 # [B, Tmax]
    outside[:, idx:idx + g] = False                  # overwritten anyway
    k2[outside[:, None, None, :].expand_as(k2)] = 1e4
    v2[outside[:, None, None, :].expand_as(v2)] = -1e4
    a = tds.decode_step_multi(q, kn, vn, mask, k_t, v_t, idx)
    c = tds.decode_step_multi(q, kn, vn, mask, k2, v2, idx)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside"):
        tds.decode_step_multi(q, kn, vn, mask, k_t, v_t, t_max - g + 1)
    with pytest.raises(ValueError, match="mask must be bool"):
        tds.decode_step_multi(q, kn, vn, mask[:, :, :2], k_t, v_t, idx)


MULTI_REJECTS = {"dtype": "takes bfloat16", "head_dim": "Dh <= 128",
                 "queries": "G <= 16", "smem": "shared memory",
                 "strided_cache": "contiguous"}


@pytest.mark.parametrize("bad", list(MULTI_REJECTS))
def test_decode_step_multi_cuda_rejects_what_kernel_does_not_take(
        monkeypatch, bad):
    monkeypatch.setattr(tds, "_multi_library", _no_library)
    rng = np.random.default_rng(13)
    dh = 256 if bad == "head_dim" else 64
    g = tds.MAX_G + 1 if bad == "queries" else 4
    # G x Tmax f32 scores past the shared memory of a cluster of 8 CTAs
    # (ops/decode_step.py::multi_plan: 8 x 5024 columns at G = 4, Dh = 64)
    t = 40000 if bad == "smem" else 20
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    q = _on_cuda(rng.standard_normal((2, g, 4, dh)), dtype)
    cache = torch.zeros((2, 4, dh, t), dtype=dtype).as_subclass(_OnCuda)
    if bad == "strided_cache":
        cache = cache.transpose(0, 1).contiguous().transpose(0, 1)
    mask = torch.ones((1, 1, g, t), dtype=torch.bool).as_subclass(_OnCuda)
    with pytest.raises(ValueError, match=MULTI_REJECTS[bad]):
        tds.decode_step_multi(q, q, q, mask, cache, cache.clone(), 3)
