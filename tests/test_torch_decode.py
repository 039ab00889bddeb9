"""The port's greedy decoding and serving (neuspeech1_tpu_torch/decode,
neuspeech1_tpu_torch/serve.py) against the JAX package, token for token, in
f32 on the CPU with the JAX encoder through its Pallas kernel."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jax_common
from neuspeech1_tpu.config import StemConfig, tiny_config
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import logits_process as jlp
from neuspeech1_tpu.models.init import init_params as jax_init_params
from neuspeech1_tpu.serve import Transcriber as JaxTranscriber
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer
from neuspeech1_tpu_torch.cli import common as tcommon
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import logits_process as tlp
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.serve import Transcriber
from neuspeech1_tpu_torch.utils.tokenizer import ByteTokenizer as TByteTokenizer
from tests.test_torch_whisper import port

torch.set_num_threads(1)


def tiny():
    return tiny_config(d_model=128, encoder_heads=2, decoder_heads=2,
                       encoder_ffn=256, decoder_ffn=256,
                       flash_attention="on")


def scaled_params(config, stem, scale=8.0):
    """init_params weights with every weight matrix and embedding scaled to
    std 0.16, so that greedy tokens depend on the input."""
    params = jax.device_get(jax_init_params(jax.random.key(0), config, stem))

    def f(path, x):
        return x * scale if path[-1].key in ("w", "token_embed") else x

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def setup():
    config, stem = tiny(), StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    feats = np.random.default_rng(0).standard_normal(
        (3, 8, 400)).astype(np.float32)
    tok = ByteTokenizer(config)
    prompt = np.asarray([tok.prefix_tokens()] * 3, np.int32)
    return (config, stem, params,
            module_from_params(params, port(config), port(stem), device="cpu"),
            feats, prompt, tok)


@pytest.mark.parametrize("mode", ["plain", "suppress_rp_ngram", "min_new"])
def test_greedy_tokens_equal_jax(setup, mode):
    config, stem, params, model, feats, prompt, tok = setup
    kw = {"plain": {},
          "suppress_rp_ngram": dict(repetition_penalty=5.0,
                                    no_repeat_ngram_size=2),
          "min_new": dict(min_new_tokens=3, no_repeat_ngram_size=3)}[mode]
    tokenizers = ({"tokenizer": tok}, {"tokenizer": TByteTokenizer(
        port(config))}) if mode == "suppress_rp_ngram" else ({}, {})
    ref = np.asarray(jg.greedy_decode(
        params, feats, prompt, config, stem,
        jg.GenerationConfig.for_model(config, max_length=24, **kw,
                                      **tokenizers[0])))
    gen = tg.GenerationConfig.for_model(port(config), max_length=24, **kw,
                                        **tokenizers[1])
    if mode == "suppress_rp_ngram":
        assert gen.suppress_ids and gen.begin_suppress_ids
    ours = tg.generate(model, torch.from_numpy(feats),
                       torch.from_numpy(prompt.astype(np.int64)), gen)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_greedy_stops_and_pads_finished_rows(setup):
    """A row that emits eos keeps emitting pad; the loop ends once every row
    has finished, the buffer stays pad-filled to max_length."""
    config, stem, params, model, feats, prompt, tok = setup
    gen = tg.GenerationConfig.for_model(port(config), max_length=24)
    free = tg.greedy_decode(model, torch.from_numpy(feats),
                            torch.from_numpy(prompt.astype(np.int64)), gen)
    # make the first generated token of row 0 the eos token
    eos_gen = tg.GenerationConfig.for_model(
        port(config), max_length=24, eos_id=int(free[0, prompt.shape[1]]))
    out = tg.greedy_decode(model, torch.from_numpy(feats),
                           torch.from_numpy(prompt.astype(np.int64)), eos_gen)
    p = prompt.shape[1]
    assert (out[0, p + 1:] == eos_gen.pad_id).all()
    ref = np.asarray(jg.greedy_decode(
        params, feats, prompt, config, stem,
        jg.GenerationConfig.for_model(config, max_length=24,
                                      eos_id=eos_gen.eos_id)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_logits_processors_match_jax():
    rng = np.random.default_rng(4)
    b, v, length, cur = 3, 50, 12, 9
    logits = rng.standard_normal((b, v)).astype(np.float32)
    tokens = rng.integers(0, 6, (b, length)).astype(np.int32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jc = jnp.asarray(cur, jnp.int32)  # a traced scalar in the JAX loop
    tt = torch.from_numpy(tokens.astype(np.int64))
    checks = [
        (jlp.suppress_tokens(jl, (1, 7, 49)), tlp.suppress_tokens(tl, (1, 7, 49))),
        (jlp.suppress_tokens_at_begin(jl, jc, cur, (2, 3)),
         tlp.suppress_tokens_at_begin(tl, cur, cur, (2, 3))),
        (jlp.suppress_tokens_at_begin(jl, jc, cur - 1, (2, 3)),
         tlp.suppress_tokens_at_begin(tl, cur, cur - 1, (2, 3))),
        (jlp.apply_min_new_tokens(jl, jc, 5, 6, 4),
         tlp.apply_min_new_tokens(tl, cur, 5, 6, 4)),
        (jlp.apply_min_new_tokens(jl, jc, 5, 4, 4),
         tlp.apply_min_new_tokens(tl, cur, 5, 4, 4)),
        (jlp.repetition_penalty(jl, tokens, jc, 5.0),
         tlp.repetition_penalty_from_seen(
             tl, tlp.seen_from_tokens(tt, cur, v), 5.0)),
    ]
    for n in (1, 2, 3):
        checks.append((jlp.no_repeat_ngram(jl, tokens, jc, n),
                       tlp.no_repeat_ngram(tl, tt, cur, n)))
    for ref, ours in checks:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    seen = tlp.seen_from_tokens(tt, cur, v)
    np.testing.assert_array_equal(
        seen.numpy(), np.asarray(jlp.seen_from_tokens(tokens, jc, v)))
    nxt = torch.tensor([5, 40, 0])
    np.testing.assert_array_equal(
        tlp.update_seen(seen.clone(), nxt).numpy(),
        np.asarray(jlp.update_seen(jlp.seen_from_tokens(tokens, jc, v),
                                   jnp.asarray(nxt.numpy()))))


@pytest.mark.parametrize("kw", [dict(num_beams=2, do_sample=True),
                                dict(do_sample=True),
                                dict(penalty_alpha=0.6, top_k=4),
                                dict(do_sample=True, top_k=5)])
def test_generate_raises_for_unported_modes(setup, kw):
    """These modes raised until they were ported: `generate` now sends each
    to its loop (beam-sample, sampling, contrastive search; the draws from
    the generator it is given), and only speculative decoding still
    refuses them."""
    config, stem, params, model, feats, prompt, tok = setup
    gen = tg.GenerationConfig.for_model(port(config), max_length=8, **kw)
    args = (model, torch.from_numpy(feats),
            torch.from_numpy(prompt.astype(np.int64)), gen)
    out = tg.generate(*args, generator=torch.Generator().manual_seed(1))
    if kw.get("num_beams", 1) > 1:
        ref = tg.beam_search(*args, generator=torch.Generator().manual_seed(
            1))[0]
    elif kw.get("penalty_alpha"):
        ref = tg.contrastive_search(*args)
    else:
        ref = tg.sample_decode(*args,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, ref) and out.shape == (3, 8)
    with pytest.raises(NotImplementedError, match="spec_gamma"):
        tg.generate(model, *args[1:3], dataclasses.replace(gen, spec_gamma=2))


@pytest.fixture(scope="module")
def model_dir(setup, tmp_path_factory):
    """A full-model directory written by the JAX package, set to compute in
    f32 with its Pallas flash kernel on."""
    config, stem, params, *_ = setup
    out = jax_common.save_full_model(
        str(tmp_path_factory.mktemp("full_model")), params, config, stem)
    with open(f"{out}/config.json") as f:
        meta = json.load(f)
    meta["config"].update(dtype="float32", flash_attention="on")
    with open(f"{out}/config.json", "w") as f:
        json.dump(meta, f)
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(repetition_penalty=5.0, no_repeat_ngram_size=2)])
def test_transcriber_texts_equal_jax(model_dir, kw):
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)
    signals[1, :, 200:] = 0.0  # a short clip: the upload crops its tail
    ref = JaxTranscriber(model_dir, batch_size=2, max_new_tokens=12,
                         **kw).transcribe(signals)
    ours = Transcriber(model_dir, batch_size=2, max_new_tokens=12,
                       device="cpu", **kw).transcribe(signals)
    assert len(ours) == 3
    assert any(ours)
    assert ours == ref


@pytest.mark.parametrize("kw", [
    dict(num_beams=5, do_sample=True), dict(int8_weights=True),
    dict(int8_weights=True, int8_kv_cache=True),
    dict(do_sample=True), dict(do_sample=True, spec_gamma=2)])
def test_transcriber_raises_for_unported_options(model_dir, kw):
    """These options raised until they were ported. Now each serves
    (beam-sample and sampling the same texts twice at one seed, int8
    weights the JAX Transcriber's texts), and only the combination the JAX
    Transcriber refuses, sampling with speculative decoding, raises its
    ``ValueError``."""
    if kw.get("spec_gamma"):
        with pytest.raises(ValueError, match="spec_gamma"):
            Transcriber(model_dir, device="cpu", **kw)
        with pytest.raises(ValueError, match="spec_gamma"):
            JaxTranscriber(model_dir, **kw)
        return
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)
    kw = dict(kw, batch_size=2, max_new_tokens=6)
    tr = Transcriber(model_dir, device="cpu", **kw)
    texts = tr.transcribe(signals)
    assert len(texts) == 3 and texts == tr.transcribe(signals)
    if not kw.get("do_sample"):
        assert texts == JaxTranscriber(model_dir, **kw).transcribe(signals)


def test_transcriber_timestamps_not_ported(model_dir):
    """Token timestamps raised until they were ported; now the JAX
    Transcriber's rows come back (tests/test_torch_timestamps.py holds them
    on more clips)."""
    t = Transcriber(model_dir, device="cpu", max_new_tokens=6)
    signals = np.random.default_rng(2).standard_normal(
        (1, 8, 400)).astype(np.float32)
    rows = t.transcribe_with_timestamps(signals)
    assert rows == JaxTranscriber(
        model_dir, max_new_tokens=6).transcribe_with_timestamps(signals)
    assert len(rows) == 1 and all(0 <= r["start"] <= r["end"]
                                  for r in rows[0])


def test_upload_features_restores_the_cropped_tail():
    feats = np.zeros((2, 3, 800), np.float32)
    feats[0, :, :150] = 1.5
    feats[1, 2, 310] = -2.0
    n = tcommon.feature_true_len(feats)
    assert n == jax_common.feature_true_len(feats) == 400
    out = tcommon.upload_features(feats, torch.bfloat16, "cpu")
    assert out.dtype == torch.bfloat16 and out.shape == feats.shape
    np.testing.assert_array_equal(out.float().numpy(), feats)
