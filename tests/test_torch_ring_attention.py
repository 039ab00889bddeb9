"""The port's ring (sequence-parallel) attention
(neuspeech1_tpu_torch/parallel) against the JAX package on the CPU, f32:
K4's plain versions against the Pallas bias kernels in interpret mode, the
ring on LocalRing threads against the JAX tests' reference and the JAX ring
on the virtual mesh, and the sequence-parallel encoder and training step
against the single-device ones. DistRing over gloo is checked against
LocalRing in tests/test_torch_dist_ring.py.

On the CPU autograd runs each thread's backward on that thread, so a
LocalRing's ranks can call ``.backward()`` each; the CUDA kernels and the
ring on the card are checked by tests/test_torch_cuda_kernels.py and
chip_smoke.py."""

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.ops import flash_attention as jfa
from neuspeech1_tpu.parallel.ring_attention import (
    ring_flash_attention as jax_ring_flash_attention)
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (
    module_from_params, params_from_lora)
from neuspeech1_tpu_torch.ops import flash_attention as tfa
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel.ring_attention import (
    LocalRing, merge, ring_flash_attention)
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_ring_attention import _qkv, _ref, _seq_mesh
from tests.test_torch_flash_attention import _on_cuda
from tests.test_torch_train import TSTEM, _batch, _setup, _torch_batch
from tests.test_torch_whisper import port, tiny
from tests.test_train import mini_cfg

torch.set_num_threads(1)

# f32 on both sides: summation order, and where the row max is taken (the
# Pallas kernel includes masked columns)
ATOL = 1e-5
# the JAX ring tests' bounds against their reference
RING_TOL, RING_GRAD_TOL = 2e-5, 5e-4
# the JAX package's bound against HF torch (test_model_parity.py), and the
# JAX SP encoder test's
RTOL, ATOL_MODEL = 1e-4, 2e-4
SP_GRAD_TOL = 2e-4

# masked key columns at the end of a 256-column block: none, part, all; then
# the edges of the CUDA backward's tiles (128 K/V rows and 64 q rows per
# dk/dv tile, 128 q rows and 64 K/V rows per dq tile): a one-row K/V tail,
# Tk off the tiles with the mask inside a tile, the mask on a tile boundary,
# three q tiles, D = 32 and 128. Tq stays a multiple of 128, as the Pallas
# backward's q blocks need.
BIAS_CASES = {
    "none": dict(masked=0), "part": dict(masked=100),
    "all": dict(masked=256),
    "tk_tail": dict(masked=0, t_k=129),
    "tk_200_part": dict(masked=37, t_q=256, t_k=200),
    "mask_on_tile": dict(masked=128),
    "tq_384": dict(masked=36, t_q=384, t_k=384),
    "d32": dict(masked=100, h=4, d=32),
    "d128": dict(masked=100, d=128),
}


def _bias_case(case, seed):
    """(q, k, v, k2, v2) and the bias row of a BIAS_CASES entry."""
    shape = dict(BIAS_CASES[case])
    masked = shape.pop("masked")
    q, k, v, k2, v2 = _block_inputs(seed, **shape)
    return (q, k, v, k2, v2), _bias(k.shape[1], masked)


def _block_inputs(seed=0, b=2, t_q=128, t_k=256, h=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t_q, h, d)).astype(np.float32)
    k, v, k2, v2 = (rng.standard_normal((b, t_k, h, d)).astype(np.float32)
                    for _ in range(4))
    return q, k, v, k2, v2


def _bias(t_k, masked):
    bias = np.zeros(t_k, np.float32)
    bias[t_k - masked:] = tfa.NEG_INF
    return bias


def _btc(x):
    b, t, h, d = x.shape
    return jnp.asarray(x.reshape(b, t, h * d))


def _jax_bias_fwd(q, k, v, bias):
    """fwd_arrays_btc_bias in interpret mode, as [B, T, H, D] and [B, H, T]."""
    b, t, h, d = q.shape
    o, lse = jfa.fwd_arrays_btc_bias(
        _btc(q), _btc(k), _btc(v),
        jnp.asarray(np.broadcast_to(bias, (1, 8, bias.shape[0]))),
        d ** -0.5, t, d)
    return np.asarray(o).reshape(q.shape), np.asarray(lse)[:, ::8]


def _assert_same_nan_inf(got, ref):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_bias_fwd_plain_matches_jax_kernel(case):
    """K4's forward: rows with none, part or all of their columns masked;
    NaN (o) and -inf (lse) in the same places as the Pallas kernel's."""
    (q, k, v, _, _), bias = _bias_case(case, 0)
    o_ref, lse_ref = _jax_bias_fwd(q, k, v, bias)
    o, lse = tfa.flash_bias_fwd(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    o, lse = o.numpy(), lse.numpy()
    _assert_same_nan_inf(o, o_ref)
    _assert_same_nan_inf(lse, lse_ref)
    if case == "all":
        assert np.isnan(o).all() and np.isneginf(lse).all()
    else:
        assert np.isfinite(o).all() and np.isfinite(lse).all()
        np.testing.assert_allclose(o, o_ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(lse, lse_ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_bias_bwd_plain_matches_jax_kernel(case):
    """K4's backward against one block with the GLOBAL o and lse of two
    merged blocks (the block and an unmasked one), as the ring takes them:
    a fully masked block gets exactly zero gradients."""
    (q, k, v, k2, v2), bias = _bias_case(case, 1)
    tq, tk, tv, tk2, tv2 = (torch.from_numpy(x) for x in (q, k, v, k2, v2))
    tb = torch.from_numpy(bias)
    o_a, lse_a = tfa.flash_bias_fwd(tq, tk, tv, tb)
    o_b, lse_b = tfa.flash_bias_fwd(tq, tk2, tv2, torch.zeros_like(tb))
    o_g, lse_g = merge(o_a, lse_a, o_b, lse_b)
    assert torch.isfinite(o_g).all() and torch.isfinite(lse_g).all()
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    got = tfa.flash_bias_bwd(tq, tk, tv, o_g, torch.from_numpy(do), lse_g, tb)
    d = q.shape[-1]
    ref = jfa.bwd_arrays_btc_bias(
        _btc(q), _btc(k), _btc(v), _btc(o_g.numpy()), _btc(do),
        jnp.asarray(np.repeat(lse_g.numpy(), 8, axis=1)),
        jnp.asarray(np.broadcast_to(bias, (1, 8, bias.shape[0]))),
        d ** -0.5, q.shape[1], d)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(g.shape),
                                   rtol=0, atol=ATOL, err_msg=name)
    if case == "all":
        assert not any(g.any() for g in got)


def _ring_run(n, q, k, v, kv_valid_len=None, grads=False, do=None):
    """ring_flash_attention on a LocalRing(n): per rank the output and, with
    ``grads``, the grads of q, k, v through autograd on the rank's thread,
    of sum(o^2) or against the output gradient ``do``."""
    def rank(ring):
        qq, kk, vv = (torch.from_numpy(np.array(x)).requires_grad_(grads)
                      for x in (q, k, v))
        o = ring_flash_attention(qq, kk, vv, ring, kv_valid_len)
        if not grads:
            return o.detach().numpy(), None
        if do is None:
            (o ** 2).sum().backward()
        else:
            o.backward(torch.from_numpy(np.asarray(do)))
        return o.detach().numpy(), [x.grad.numpy() for x in (qq, kk, vv)]

    return LocalRing.run(rank, n)


@pytest.mark.parametrize("kv_valid_len", [None, 470, 200])
def test_ring_forward_matches_reference(kv_valid_len):
    """LocalRing(4) at T=512: padding in the last shard (470) and the last
    two shards fully masked (200) both merge exactly."""
    q, k, v = _qkv()
    ref = np.asarray(_ref(q, k, v, kv_valid_len))
    for o, _ in _ring_run(4, q, k, v, kv_valid_len):
        np.testing.assert_allclose(o, ref, rtol=RING_TOL, atol=RING_TOL)


def test_ring_grads_match_reference():
    """Grads of sum(o^2) through autograd on 4 CPU threads, whole on every
    rank, against jax.grad of the reference."""
    q, k, v = _qkv(seed=3)
    kv_valid_len = 450

    def loss_ref(q, k, v):
        return jnp.sum(_ref(q, k, v, kv_valid_len).astype(jnp.float32) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    runs = _ring_run(4, q, k, v, kv_valid_len, grads=True)
    for _, grads in runs:
        for g, r in zip(grads, g_ref):
            np.testing.assert_allclose(g, np.asarray(r), rtol=RING_GRAD_TOL,
                                       atol=RING_GRAD_TOL)


def test_ring_matches_jax_ring():
    """One forward and grad against the JAX ring_flash_attention on the
    virtual mesh, T=256 over 2 ranks, kv_valid_len 200: f32 on both sides,
    the same merge and the same per-block kernels, so summation order is
    the only difference."""
    q, k, v = _qkv(t=256, seed=4)
    kv_valid_len = 200
    mesh = _seq_mesh(2)

    def loss(q, k, v):
        o = jax_ring_flash_attention(q, k, v, mesh, "seq",
                                     kv_valid_len=kv_valid_len)
        return jnp.sum(o ** 2), o

    (_, o_ref), g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    o_ref = np.asarray(o_ref)
    for o, grads in _ring_run(2, q, k, v, kv_valid_len, grads=True):
        np.testing.assert_allclose(o, o_ref, rtol=RING_TOL, atol=RING_TOL)
        for g, r in zip(grads, g_ref):
            np.testing.assert_allclose(g, np.asarray(r), rtol=RING_TOL,
                                       atol=RING_TOL)


def test_ring_batch_and_seq_axes_compose():
    """Data x sequence: the batch split over two independent LocalRing(4)s
    running at once, each half against the reference."""
    q, k, v = _qkv(b=4, t=512, seed=5)
    ref = np.asarray(_ref(q, k, v))
    out = [None, None]

    def data_rank(i):
        rows = slice(2 * i, 2 * i + 2)
        out[i] = _ring_run(4, q[rows], k[rows], v[rows])

    threads = [threading.Thread(target=data_rank, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 1):
        for o, _ in out[i]:
            np.testing.assert_allclose(o, ref[2 * i:2 * i + 2], rtol=RING_TOL,
                                       atol=RING_TOL)


@pytest.mark.parametrize("t,d", [(500, 64), (512, 48)])
def test_ring_shard_constraints(t, d):
    """T=500 over 4 gives 125-row shards (not a 128-row multiple); D=48 is
    not a kernel head dim."""
    q = np.zeros((1, t, 2, d), np.float32)
    with pytest.raises(ValueError):
        _ring_run(4, q, q, q)


def _sp_geometry():
    """The JAX test_encoder_seq_parallel_matches_plain geometry: T=256 over
    2 seq ranks, 1024-sample inputs over 6 channels."""
    cfg = mini_cfg(d_model=128, encoder_heads=2, decoder_heads=2,
                   max_source_positions=256, max_target_positions=16)
    stem = StemConfig("base", in_channels=6)
    params = jax.device_get(init_params(jax.random.key(0), cfg, stem))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 6, 1024)).astype(np.float32)
    dec_in = rng.integers(0, 60, (2, 8)).astype(np.int32)
    return cfg, stem, params, feats, dec_in


def _paths(grads_module):
    return {k: t.detach().numpy() for k, t in
            topt.named_leaves(grads_module).items()}


def test_encoder_seq_parallel_matches_plain():
    """The whole model's forward, loss and grads with the encoder's
    self-attention on a LocalRing(2) (``seq_parallel_axis``) against the
    JAX plain forward; the layer stack's grads summed over the ring as the
    training step sums them, and every rank's grads equal bit for bit."""
    cfg, stem, params, feats, dec_in = _sp_geometry()

    def loss(params):
        out = jw.forward(params, feats, dec_in, cfg, stem)
        return jnp.sum(out.astype(jnp.float32) ** 2) / out.size

    ref_l, ref_g = jax.jit(jax.value_and_grad(loss))(params)
    ref = _paths(module_from_params(jax.device_get(ref_g), port(cfg),
                                    port(stem), device="cpu"))
    cfg_sp = port(dataclasses.replace(cfg, seq_parallel_axis="seq"))

    def rank(ring):
        model = module_from_params(params, cfg_sp, port(stem), device="cpu")
        model.requires_grad_(True)
        with pmesh.set_mesh({"seq": ring}):
            out = tw.forward(model, torch.from_numpy(feats),
                             torch.from_numpy(dec_in).long())
            value = (out.float() ** 2).sum() / out.numel()
            value.backward()
            grads = {k: t.grad for k, t in
                     topt.named_leaves(model).items()}
            grads = tts.sum_seq_sharded_grads(grads, ring)
        return value.item(), {k: g.numpy() for k, g in grads.items()}

    runs = LocalRing.run(rank, 2)
    for value, grads in runs:
        np.testing.assert_allclose(value, float(ref_l), rtol=1e-5)
        assert set(grads) == set(ref)
        for k, g in grads.items():
            np.testing.assert_allclose(g, ref[k], rtol=SP_GRAD_TOL,
                                       atol=SP_GRAD_TOL, err_msg=k)
    for k, g in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][k], g, err_msg=k)


def test_encoder_routes_self_attention_through_the_ring(monkeypatch):
    """Under ``seq_parallel_axis`` the encoder's self-attention calls K4's
    entry (2 ranks x 2 rounds x 2 layers) and never K1's; without an
    ambient mesh, or with a mesh lacking the axis, it raises; with a
    ``pipeline_axis`` as well (it raised until the axes composed) K4's
    entry runs in every stage's rounds, 4 ranks x 2 microbatches x 2
    rounds x 1 layer, and every rank gets the SP encoder's states. A
    ``pipeline_axis`` alone calls K1's entry once per layer and
    microbatch, and gives the plain stack's output on every rank."""
    calls = {"k1": 0, "k4": 0}
    k1, k4 = tw.flash_attention_bthd, tfa.flash_bias_fwd

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(tw, "flash_attention_bthd", count("k1", k1))
    monkeypatch.setattr(tfa, "flash_bias_fwd", count("k4", k4))
    config = tiny(seq_parallel_axis="seq")
    stem = StemConfig("base", in_channels=8)
    params = jax.device_get(init_params(jax.random.key(0), config, stem))
    model = module_from_params(params, port(config), port(stem), device="cpu")
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 400)).astype(np.float32))

    def rank(ring):
        with pmesh.set_mesh({"seq": ring}), torch.no_grad():
            return tw.encoder_apply(model, feats)

    outs = LocalRing.run(rank, 2)
    assert calls == {"k1": 0, "k4": 2 * 2 * config.encoder_layers}
    assert outs[0].shape == (2, config.max_source_positions, config.d_model)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="ambient mesh"), torch.no_grad():
        tw.encoder_apply(model, feats)
    with pmesh.set_mesh({"data": types.SimpleNamespace(size=1)}), \
            pytest.raises(ValueError, match="no axis 'seq'"), torch.no_grad():
        tw.encoder_apply(model, feats)
    # sequence parallelism inside pipeline stages: each (pipe, seq) rank
    # runs its stage's layer on its shard of each of two microbatches, two
    # rounds of K4 each, and every rank gets the SP encoder's states
    sp = outs[0]
    model.config = port(tiny(seq_parallel_axis="seq", pipeline_axis="pipe"))
    calls.update(k1=0, k4=0)

    def sp_stage(mesh):
        with pmesh.set_mesh(mesh), torch.no_grad():
            return tw.encoder_apply(model, feats)

    outs = LocalRing.run_mesh(sp_stage, pipe=2, seq=2)
    assert calls == {"k1": 0, "k4": 4 * 2 * 2 * config.encoder_layers // 2}
    for o in outs:
        torch.testing.assert_close(o, sp, rtol=0, atol=0)
    # a pipeline_axis alone: two stages of one layer, two microbatches, the
    # stages' self-attention on K1's entry as in the plain stack
    model.config = port(tiny())
    calls.update(k1=0, k4=0)
    with torch.no_grad():
        plain = tw.encoder_apply(model, feats)
    model.config = port(tiny(pipeline_axis="pipe"))

    def stage(ring):
        with pmesh.set_mesh({"pipe": ring}), torch.no_grad():
            return tw.encoder_apply(model, feats)

    outs = LocalRing.run(stage, 2)
    assert calls == {"k1": config.encoder_layers * (1 + 2), "k4": 0}
    for o in outs:
        torch.testing.assert_close(o, plain, rtol=0, atol=0)


N_STEPS = 2


def _train_run(config, ring=None):
    """N_STEPS of the fold_lora step from test_torch_train's weights and
    batch: per step the metrics and the trainable leaves after the
    update."""
    _, _, model, t_lora = _setup(tiny(), config)
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state, frozen = tts.init_train_state(model, t_lora, tx)
    step = tts.make_train_step(config, TSTEM, tx, fold_lora=True)
    batch = _torch_batch(_batch(tiny()))
    out = []
    with pmesh.set_mesh(None if ring is None else {"seq": ring}):
        for _ in range(N_STEPS):
            m = step(state, frozen, batch)
            leaves = params_from_lora(t_lora)
            leaves["stem"] = model.encoder.stem.conv_a.weight.detach().numpy(
            ).copy()
            out.append(({k: float(m[k]) for k in ("loss", "grad_norm")},
                        leaves))
    return out


def test_sp_train_steps_equal_on_every_rank_and_match_single_device():
    """Two fold_lora steps with the encoder on a LocalRing(2) (100 frames
    padded to 256: the second rank's keys are all masked): every rank's
    metrics and updated leaves equal bit for bit, and equal to the
    single-device step within the JAX package's bound."""
    single = _train_run(port(tiny()))
    sp = LocalRing.run(
        lambda ring: _train_run(port(tiny(seq_parallel_axis="seq")), ring), 2)
    for step in range(N_STEPS):
        (m0, l0), (m1, l1) = sp[0][step], sp[1][step]
        assert m0 == m1
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(l0),
                                jax.tree_util.tree_leaves(l1)):
            np.testing.assert_array_equal(a, b,
                                          err_msg=jax.tree_util.keystr(path))
        m_ref, l_ref = single[step]
        for k in m_ref:
            np.testing.assert_allclose(m0[k], m_ref[k], rtol=RTOL,
                                       atol=ATOL_MODEL, err_msg=k)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(l0),
                                jax.tree_util.tree_leaves(l_ref)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_MODEL,
                                       err_msg=jax.tree_util.keystr(path))


def test_sp_step_takes_a_data_axis():
    """Data-parallel gradient averaging is ported: the SP step under a
    {data: 2, seq: 2} mesh, each data rank on one of the batch's two rows,
    gives the single-device step's metrics and leaves on every rank."""
    single = _train_run(port(tiny()))

    def rank(mesh):
        config = port(tiny(seq_parallel_axis="seq"))
        _, _, model, t_lora = _setup(tiny(), config)
        tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
        state, frozen = tts.init_train_state(model, t_lora, tx)
        step = tts.make_train_step(config, TSTEM, tx, fold_lora=True)
        with pmesh.set_mesh(mesh):
            shard = pmesh.batch_sharding()
            batch = {k: shard.shard(v)
                     for k, v in _torch_batch(_batch(tiny())).items()}
            out = []
            for _ in range(N_STEPS):
                m = step(state, frozen, batch)
                out.append(({k: float(m[k]) for k in ("loss", "grad_norm")},
                            params_from_lora(t_lora)))
        return out

    runs = LocalRing.run_mesh(rank, data=2, seq=2)
    for step in range(N_STEPS):
        m_ref, l_ref = single[step]
        for run in runs:
            m, leaves = run[step]
            assert m == runs[0][step][0]
            for k in m_ref:
                np.testing.assert_allclose(m[k], m_ref[k], rtol=RTOL,
                                           atol=ATOL_MODEL, err_msg=k)
            ref = {k: v for k, v in l_ref.items() if k != "stem"}
            assert jax.tree_util.tree_structure(leaves) == \
                jax.tree_util.tree_structure(ref)
            for (path, a), b in zip(
                    jax.tree_util.tree_leaves_with_path(leaves),
                    jax.tree_util.tree_leaves(ref)):
                np.testing.assert_allclose(
                    a, b, rtol=RTOL, atol=ATOL_MODEL,
                    err_msg=jax.tree_util.keystr(path))


def test_bias_kernels_on_cuda_never_take_the_plain_path(monkeypatch):
    """On CUDA tensors K4's entries launch the kernel or raise: with the
    libraries failing to load they raise, the plain versions are never
    called, and no launch is counted."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(tfa, "flash_bias_fwd_plain", no_plain)
    monkeypatch.setattr(tfa, "flash_bias_bwd_plain", no_plain)
    monkeypatch.setattr(tfa, "_library", no_library)
    monkeypatch.setattr(tfa, "_bwd_library", no_library)
    q, k, v, _, _ = _block_inputs()
    q, k, v = (_on_cuda(x) for x in (q, k, v))
    bias = torch.zeros(k.shape[1]).as_subclass(type(q))
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1]).as_subclass(type(q))
    before = (tfa.bias_launches, tfa.bias_bwd_launches)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tfa.flash_bias_fwd(q, k, v, bias)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tfa.flash_bias_bwd(q, k, v, q, q, lse, bias)
    assert (tfa.bias_launches, tfa.bias_bwd_launches) == before


BIAS_REJECTS = {"head_dim": "head dim 48", "dtype": "takes bfloat16",
                "bias_shape": r"bias must be \[Tk\]",
                "strided_head": "contiguous head dim"}


@pytest.mark.parametrize("bad", list(BIAS_REJECTS))
def test_bias_cuda_path_rejects_what_kernel_does_not_take(monkeypatch, bad):
    def no_library():
        raise AssertionError("validation must fail before the launch")

    monkeypatch.setattr(tfa, "_library", no_library)
    d = 48 if bad == "head_dim" else 64
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    q, k, v, _, _ = _block_inputs(d=d)
    q, k, v = (_on_cuda(x, dtype) for x in (q, k, v))
    if bad == "strided_head":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    t_k = k.shape[1] + (1 if bad == "bias_shape" else 0)
    bias = torch.zeros(t_k).as_subclass(type(q))
    with pytest.raises(ValueError, match=BIAS_REJECTS[bad]):
        tfa.flash_bias_fwd(q, k, v, bias)
