"""LoRA adapters in the port's cached decoder and decode loops against the
JAX package, in f32 on the CPU: the cached decoder's logits with encoder and
decoder adapters (self-attention q/k/v/out, cross-attention q/out, the MLP;
the cross cache projected without them), and greedy, beam-5 and
speculative tokens with ``lora=`` exactly equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import spec as jspec
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import spec as tspec
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                 module_from_params)
from tests.test_torch_whisper import ATOL, RTOL, port, scaled_params, tiny

torch.set_num_threads(1)

RANK = 4
B_STD = 0.05
PREFILL, STEPS = 4, 3


def adapter_tree(config, seed=0):
    """A JAX-layout adapter tree of rank 4 on every linear of both stacks:
    encoder and decoder self-attention q/k/v/out, decoder cross-attention
    q/k/v/out, fc1 and fc2; A ~ N(0, 1/r), every B ~ N(0, 0.05^2),
    alpha 2r."""
    rng = np.random.default_rng(seed)

    def entry(n_layers, d_in, d_out):
        return {"A": (rng.standard_normal((n_layers, d_in, RANK))
                      / np.sqrt(RANK)).astype(np.float32),
                "B": (B_STD * rng.standard_normal((n_layers, RANK, d_out))
                      ).astype(np.float32),
                "alpha": np.full((n_layers, 1, 1), 2.0 * RANK, np.float32)}

    d = config.d_model
    tree = {}
    for part, n, ffn, attns in (
            ("encoder", config.encoder_layers, config.encoder_ffn,
             ("self_attn",)),
            ("decoder", config.decoder_layers, config.decoder_ffn,
             ("self_attn", "cross_attn"))):
        layers = {a: {m: entry(n, d, d) for m in ("q", "k", "v", "out")}
                  for a in attns}
        layers["fc1"] = entry(n, d, ffn)
        layers["fc2"] = entry(n, ffn, d)
        tree[part] = {"layers": layers}
    return tree


@pytest.fixture(scope="module")
def setup():
    config, stem = tiny(), StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    feats = np.random.default_rng(0).standard_normal(
        (3, 8, 400)).astype(np.float32)
    prompt = np.asarray([ByteTokenizer(config).prefix_tokens()] * 3, np.int32)
    model = module_from_params(params, port(config), port(stem), device="cpu")
    lora = adapter_tree(config)
    return (config, stem, params, model, feats, prompt, lora,
            lora_from_params(lora, device="cpu"))


def _cached_logits_jax(params, config, enc, tokens, lora):
    cache = jw.init_cache(params, enc, config, max_len=PREFILL + STEPS)
    logits, cache = jw.decoder_apply(params, tokens[:, :PREFILL], enc, config,
                                     lora=lora, cache=cache, cache_index=0)
    out = [logits]
    for i in range(PREFILL, PREFILL + STEPS):
        logits, cache = jw.decoder_apply(params, tokens[:, i:i + 1], enc,
                                         config, lora=lora, cache=cache,
                                         cache_index=i)
        out.append(logits)
    return np.asarray(jnp.concatenate(out, axis=1))


def _cached_logits_port(model, enc, tokens, lora):
    with torch.no_grad():
        cache = tw.init_cache(model, enc, max_len=PREFILL + STEPS)
        logits, cache = tw.decoder_apply(model, tokens[:, :PREFILL], enc,
                                         cache=cache, cache_index=0,
                                         lora=lora)
        out = [logits]
        for i in range(PREFILL, PREFILL + STEPS):
            logits, cache = tw.decoder_apply(model, tokens[:, i:i + 1], enc,
                                             cache=cache, cache_index=i,
                                             lora=lora)
            out.append(logits)
    return torch.cat(out, dim=1).numpy()


def test_cached_decoder_with_adapters_matches_jax(setup):
    """A 4-token prefill plus 3 width-1 steps on the same encoder states,
    JAX ``decoder_apply(cache=..., lora=...)`` against the port; and the
    decoder adapters move the logits far beyond that bound, so the match
    cannot come from adapters that were dropped."""
    config, stem, params, model, feats, prompt, jlora, tlora = setup
    enc = np.asarray(jw.encoder_apply(params, feats, config, stem,
                                      lora=jlora))
    tokens = np.random.default_rng(3).integers(
        0, config.vocab_size, (3, PREFILL + STEPS)).astype(np.int32)
    ref = _cached_logits_jax(params, config, enc, tokens, jlora)
    ours = _cached_logits_port(model, torch.from_numpy(enc),
                               torch.from_numpy(tokens.astype(np.int64)),
                               tlora)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)

    enc_only = {"encoder": tlora["encoder"]}
    bare = _cached_logits_port(model, torch.from_numpy(enc),
                               torch.from_numpy(tokens.astype(np.int64)),
                               enc_only)
    assert np.abs(bare - ref).max() > 100 * (ATOL + RTOL * np.abs(ref).max())


def test_encoder_adapters_reach_the_decode_loop(setup):
    """greedy_decode with encoder adapters decodes other tokens than
    without them, and the JAX package's tokens."""
    config, stem, params, model, feats, prompt, jlora, tlora = setup
    enc_only = {"encoder": tlora["encoder"]}
    gen = tg.GenerationConfig.for_model(port(config), max_length=16)
    args = (model, torch.from_numpy(feats),
            torch.from_numpy(prompt.astype(np.int64)), gen)
    with_enc = tg.greedy_decode(*args, lora=enc_only).numpy()
    ref = np.asarray(jg.greedy_decode(
        params, feats, prompt, config, stem,
        jg.GenerationConfig.for_model(config, max_length=16),
        lora={"encoder": jlora["encoder"]}))
    np.testing.assert_array_equal(with_enc, ref)
    assert (with_enc != tg.greedy_decode(*args).numpy()).any()


MODES = {
    "greedy": dict(max_length=24),
    "beam5": dict(max_length=16, num_beams=5, repetition_penalty=5.0,
                  no_repeat_ngram_size=2),
    "spec4": dict(max_length=24, spec_gamma=4),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_tokens_with_adapters_equal_jax(setup, mode):
    """greedy_decode, beam_search and spec_greedy_decode with ``lora=``
    (through ``generate``'s dispatch, and each loop called directly)
    against the JAX package's with the same adapters."""
    config, stem, params, model, feats, prompt, jlora, tlora = setup
    kw = MODES[mode]
    jgen = jg.GenerationConfig.for_model(config, **kw)
    tgen = tg.GenerationConfig.for_model(port(config), **kw)
    args = (model, torch.from_numpy(feats),
            torch.from_numpy(prompt.astype(np.int64)), tgen)
    if mode == "greedy":
        ref = jg.greedy_decode(params, feats, prompt, config, stem, jgen,
                               lora=jlora)
        ours = tg.greedy_decode(*args, lora=tlora)
    elif mode == "beam5":
        ref, _ = jg.beam_search(params, feats, prompt, config, stem, jgen,
                                lora=jlora)
        ours, _ = tg.beam_search(*args, lora=tlora)
    else:
        ref, ref_iters = jspec.spec_greedy_decode(
            params, feats, prompt, config, stem, jgen, gamma=4, lora=jlora)
        ours, iters = tspec.spec_greedy_decode(*args, gamma=4, lora=tlora)
        assert iters == int(ref_iters)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(tg.generate(*args, lora=tlora).numpy(), ref)
    # the adapters change this mode's output: dropping them would show
    assert (tg.generate(*args).numpy() != ref).any()
