"""The port's model (neuspeech1_tpu_torch/models) against the JAX package on
the same weights and inputs, in f32 on the CPU, with the JAX encoder's
attention through its Pallas flash kernel (interpret mode)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import (
    WHISPER_PRESETS, StemConfig, WhisperConfig, tiny_config)
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.convert import load_npz
from neuspeech1_tpu.models.init import init_params as jax_init_params
from neuspeech1_tpu.models.init import sinusoids as jax_sinusoids
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.cli import common
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import load_npz as port_load_npz
from neuspeech1_tpu_torch.models.convert import (
    module_from_params, params_from_module, save_npz)
from neuspeech1_tpu_torch.models.init import init_params, sinusoids
from neuspeech1_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash_attention import _OnCuda

torch.set_num_threads(1)

# the bound the JAX package holds against HF torch (test_model_parity.py)
RTOL, ATOL = 1e-4, 2e-4


def tiny(**kw):
    """d_head 64, so the JAX BTC flash gate holds and its Pallas kernel runs
    (T=100 padded to 128 with kv_len=100)."""
    return tiny_config(d_model=128, encoder_heads=2, decoder_heads=2,
                       encoder_ffn=256, decoder_ffn=256,
                       flash_attention="on", **kw)


def port(cfg):
    """The port's config (or stem config) with the same fields as the JAX
    one: the port is never handed a JAX config object."""
    cls = tc.WhisperConfig if isinstance(cfg, WhisperConfig) else tc.StemConfig
    return cls(**dataclasses.asdict(cfg))


def scaled_params(config, stem, scale=8.0):
    """init_params weights with every weight matrix and embedding scaled to
    std 0.16, so that outputs depend visibly on the input."""
    params = jax.device_get(jax_init_params(jax.random.key(0), config, stem))

    def f(path, x):
        return x * scale if path[-1].key in ("w", "token_embed") else x

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def pair():
    config, stem = tiny(), StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 8, 400)).astype(np.float32)
    return (config, stem, params,
            module_from_params(params, port(config), port(stem), device="cpu"),
            feats)


def test_encoder_matches_jax(pair):
    config, stem, params, model, feats = pair
    ref = np.asarray(jax.jit(
        lambda p, f: jw.encoder_apply(p, f, config, stem))(params, feats))
    with torch.no_grad():
        ours = tw.encoder_apply(model, torch.from_numpy(feats)).numpy()
    assert ours.shape == (2, config.max_source_positions, config.d_model)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_forward_logits_match_jax(pair):
    config, stem, params, model, feats = pair
    dec = np.random.default_rng(1).integers(0, config.vocab_size, (2, 9))
    ref = np.asarray(jax.jit(lambda p, f, d: jw.forward(p, f, d, config, stem))(
        params, feats, dec.astype(np.int32)))
    with torch.no_grad():
        ours = tw.forward(model, torch.from_numpy(feats),
                          torch.from_numpy(dec)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_cached_decode_steps_match_teacher_forcing(pair):
    """Prefill plus single-token steps on the k_t caches give the logits of
    the cache-free causal forward (the same check the JAX cache passes)."""
    config, stem, params, model, feats = pair
    dec = torch.from_numpy(
        np.random.default_rng(2).integers(0, config.vocab_size, (2, 7)))
    with torch.no_grad():
        enc = tw.encoder_apply(model, torch.from_numpy(feats))
        full = tw.decoder_apply(model, dec, enc)
        cache = tw.init_cache(model, enc, max_len=10)
        logits, cache = tw.decoder_apply(model, dec[:, :4], enc, cache=cache,
                                         cache_index=0)
        steps = [logits]
        for i in range(4, 7):
            logits, cache = tw.decoder_apply(model, dec[:, i:i + 1], enc,
                                             cache=cache, cache_index=i)
            steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["speech", "base", "replace", "premel"])
def test_stems_match_jax(kind):
    config = tiny()
    stem = StemConfig(kind, in_channels=8)
    params = scaled_params(config, stem)
    model = module_from_params(params, port(config), port(stem), device="cpu")
    n_in = config.num_mel_bins if kind == "speech" else 8
    t_in = config.max_source_positions * (2 if kind == "speech" else 4)
    feats = np.random.default_rng(3).standard_normal(
        (2, n_in, t_in)).astype(np.float32)
    ref = np.asarray(jw.apply_stem(params["encoder"], feats, config, stem))
    with torch.no_grad():
        ours = tw.apply_stem(model, torch.from_numpy(feats)).numpy()
    assert ours.shape == (2, config.max_source_positions, config.d_model)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_weight_bridge_round_trip_is_exact(pair, tmp_path):
    config, stem, params, model, _ = pair
    back = params_from_module(model)
    same = jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape and np.array_equal(a, b), params, back)
    assert jax.tree_util.tree_all(same)
    assert model.encoder.layers[1].fc1.weight.shape == (256, 128)  # [out, in]
    path = str(tmp_path / "params.npz")
    save_npz(path, back)
    for loaded in (load_npz(path), port_load_npz(path)):
        assert jax.tree_util.tree_structure(loaded) == \
            jax.tree_util.tree_structure(params)
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, loaded, params))


def test_bridge_rejects_a_tree_that_does_not_fit(pair):
    config, stem, params, _, _ = pair
    with pytest.raises(KeyError):
        module_from_params({**params, "extra": {}}, port(config), port(stem),
                           device="cpu")
    wider = dataclasses.replace(config, encoder_ffn=512)
    with pytest.raises(ValueError):
        module_from_params(params, port(wider), port(stem), device="cpu")


def test_init_matches_jax_tree_and_distributions():
    config, stem = tiny(), StemConfig("premel", in_channels=8)
    ours = init_params(port(config), port(stem), seed=0)
    ref = jax.device_get(jax_init_params(jax.random.key(0), config, stem))
    ours_np = jax.tree_util.tree_map(lambda t: t.numpy(), ours)
    assert jax.tree_util.tree_structure(ours_np) == \
        jax.tree_util.tree_structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours_np),
                            jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path[-1].key in ("w", "token_embed") or (
                path[-1].key == "pos_embed" and path[0].key == "decoder"):
            assert abs(a.std() - 0.02) < 2e-3, path
        elif path[-1].key != "pos_embed":  # biases and layer norms exact
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    np.testing.assert_allclose(ours_np["encoder"]["pos_embed"],
                               jax_sinusoids(100, 128), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sinusoids(100, 128).numpy(),
                               jax_sinusoids(100, 128), rtol=0, atol=1e-6)


def test_f32_model_on_cuda_raises_instead_of_plain_attention(pair,
                                                              monkeypatch):
    """On a CUDA tensor the encoder takes the flash kernel whatever the
    model's dtype: an f32 model with flash on raises at the kernel's dtype
    check and never routes to plain attention."""
    config, stem, params, model, feats = pair

    def no_plain(*a, **kw):
        raise AssertionError("plain attention called for a CUDA tensor")

    def no_library():
        raise AssertionError("validation must fail before the launch")

    monkeypatch.setattr(tw, "attention", no_plain)
    monkeypatch.setattr(tfa, "flash_attention_bthd_plain", no_plain)
    monkeypatch.setattr(tfa, "_library", no_library)
    assert model.dtype == torch.float32
    before = tfa.launches
    with torch.no_grad(), pytest.raises(ValueError, match="takes bfloat16"):
        tw.encoder_apply(model, torch.from_numpy(feats).as_subclass(_OnCuda))
    assert tfa.launches == before


def test_preset_model_is_whisper_base_over_208_channels():
    config, stem = common.preset_model("base", "base", in_channels=208)
    assert config == tc.WhisperConfig(**tc.WHISPER_PRESETS["base"])
    # the port's own copy of the config: field for field the JAX preset
    assert dataclasses.asdict(config) == dataclasses.asdict(
        WhisperConfig(**WHISPER_PRESETS["base"]))
    assert (config.d_model, config.encoder_layers, config.decoder_layers,
            config.encoder_heads, config.vocab_size, config.dtype) == \
        (512, 6, 6, 8, 51865, "bfloat16")
    assert stem == tc.StemConfig("base", in_channels=208)
    assert dataclasses.asdict(stem) == dataclasses.asdict(
        StemConfig("base", in_channels=208))


def test_unported_cache_layouts_raise(pair):
    """The 'btc' cross layout raises, alone and beside the int8 and
    speculative caches (which are ported: tests/test_torch_int8_cache.py)."""
    config, stem, params, model, feats = pair
    enc = torch.zeros((1, config.max_source_positions, config.d_model))
    for kw in (dict(cross_layout="btc"),
               dict(cross_layout="btc", int8_cross=True),
               dict(cross_layout="btc", self_t_major=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tw.init_cache(model, enc, max_len=8, **kw)


@pytest.mark.parametrize("t", [3, 4, 9])
def test_decoder_flash_gates(monkeypatch, t):
    """Teacher forcing follows the JAX package's decoder flash gates: cross
    attention through flash from decoder_flash_cross_min_q (1) tokens on,
    causal self-attention from decoder_flash_self_min_q (4 here); cached
    decode steps never take flash."""
    config = tiny(decoder_flash_self_min_q=4)
    stem = StemConfig("base", in_channels=8)
    model = module_from_params(scaled_params(config, stem), port(config),
                               port(stem), device="cpu")
    calls = []

    def counting(q, k, v, causal=False, kv_len=None, return_lse=False):
        calls.append((causal, q.shape[1], k.shape[1]))
        return tfa.flash_attention_bthd(q, k, v, causal, kv_len, return_lse)

    monkeypatch.setattr(tw, "flash_attention_bthd", counting)
    enc = torch.randn((2, config.max_source_positions, config.d_model))
    tokens = torch.randint(0, config.vocab_size, (2, t))
    with torch.no_grad():
        tw.decoder_apply(model, tokens, enc)
    n = config.decoder_layers
    n_self = n if t >= 4 else 0
    assert calls.count((False, t, config.max_source_positions)) == n
    assert calls.count((True, t, t)) == n_self
    assert len(calls) == n + n_self
    calls.clear()
    with torch.no_grad():
        cache = tw.init_cache(model, enc, max_len=t + 1)
        tw.decoder_apply(model, tokens, enc, cache=cache, cache_index=0)
    assert calls == []


def test_forward_with_decoder_self_flash_matches_jax():
    """Logits with the decoder's causal self-attention through flash (the
    self gate set to 4 tokens, 9 given) against the JAX package, whose
    decoder then runs its Pallas kernel too."""
    config = tiny(decoder_flash_self_min_q=4)
    stem = StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    feats = np.random.default_rng(4).standard_normal(
        (2, 8, 400)).astype(np.float32)
    dec = np.random.default_rng(5).integers(0, config.vocab_size, (2, 9))
    ref = np.asarray(jax.jit(lambda p, f, d: jw.forward(p, f, d, config, stem))(
        params, feats, dec.astype(np.int32)))
    with torch.no_grad():
        ours = tw.forward(module_from_params(params, port(config), port(stem),
                                             device="cpu"),
                          torch.from_numpy(feats),
                          torch.from_numpy(dec)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_f32_master_model_computes_in_config_dtype():
    """A model holding f32 masters under a bf16 config computes in bf16
    (weights cast at each use, as the JAX package casts its masters), and
    matches the bf16-held model up to the rounding of the casts."""
    config = dataclasses.replace(tiny(), dtype="bfloat16")
    stem = StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    f32 = module_from_params(params, port(config), port(stem), device="cpu",
                             dtype=torch.float32)
    bf16 = module_from_params(params, port(config), port(stem), device="cpu")
    assert f32.encoder.conv2.weight.dtype == torch.float32
    feats = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 8, 400)).astype(np.float32))
    dec = torch.randint(0, config.vocab_size, (1, 5))
    with torch.no_grad():
        a, b = tw.forward(f32, feats, dec), tw.forward(bf16, feats, dec)
    assert a.dtype == b.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)
