"""The port's beam search (neuspeech1_tpu_torch/decode/generate.py::
beam_search) and beam serving against the JAX package, token for token, in
f32 on the CPU: utterances with different encoder states, the eval CLI's
settings and the other beam rules, ties, and the Transcriber."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu import config as jc
from neuspeech1_tpu.cli import common as jax_common
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.models.init import init_params as jax_init_params
from neuspeech1_tpu.serve import Transcriber as JaxTranscriber
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.serve import Transcriber
from neuspeech1_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)

TINY = dict(d_model=128, encoder_heads=2, decoder_heads=2, encoder_ffn=256,
            decoder_ffn=256, flash_attention="on")
N_NEW = 10


def scaled_params(config, stem, scale=8.0):
    """init_params weights with every weight matrix and embedding scaled to
    std 0.16, so that the tokens depend on the input."""
    params = jax.device_get(jax_init_params(jax.random.key(0), config, stem))

    def f(path, x):
        return x * scale if path[-1].key in ("w", "token_embed") else x

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def setup():
    """One config of each package from the same kwargs, the JAX weights,
    the port's model on them, and three utterances of different features."""
    jconfig, tconfig = jc.tiny_config(**TINY), tc.tiny_config(**TINY)
    assert dataclasses.asdict(jconfig) == dataclasses.asdict(tconfig)
    jstem, tstem = jc.StemConfig("base", in_channels=8), tc.StemConfig(
        "base", in_channels=8)
    params = scaled_params(jconfig, jstem)
    feats = np.random.default_rng(0).standard_normal(
        (3, 8, 400)).astype(np.float32)
    prompt = np.asarray([JaxByteTokenizer(jconfig).prefix_tokens()] * 3,
                        np.int32)
    model = module_from_params(params, tconfig, tstem, device="cpu")
    return jconfig, jstem, tconfig, params, model, feats, prompt


def _both(setup, params=None, model=None, **kw):
    """JAX beam_search and the port's on the same inputs and settings:
    (jax tokens, jax scores, port tokens, port scores)."""
    jconfig, jstem, tconfig, p0, m0, feats, prompt = setup
    params = p0 if params is None else params
    model = m0 if model is None else model
    if kw.pop("tokenizer", False):
        kw_j = dict(kw, tokenizer=JaxByteTokenizer(jconfig))
        kw_t = dict(kw, tokenizer=ByteTokenizer(tconfig))
    else:
        kw_j = kw_t = kw
    seq, scores = jg.beam_search(
        params, feats, prompt, jconfig, jstem,
        jg.GenerationConfig.for_model(jconfig, **kw_j))
    gen = tg.GenerationConfig.for_model(tconfig, **kw_t)
    ours, our_scores = tg.beam_search(
        model, torch.from_numpy(feats),
        torch.from_numpy(prompt.astype(np.int64)), gen)
    return np.asarray(seq), np.asarray(scores), ours.numpy(), \
        our_scores.numpy()


@pytest.fixture(scope="module")
def greedy_first(setup):
    """The first generated token of each row under greedy decoding: used as
    eos, it makes beams hit eos mid-loop, so the finished set fills."""
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    out = tg.greedy_decode(model, torch.from_numpy(feats),
                           torch.from_numpy(prompt.astype(np.int64)),
                           tg.GenerationConfig.for_model(
                               tconfig, max_length=prompt.shape[1] + 1))
    return out[:, prompt.shape[1]].tolist()


CASES = {
    # the eval CLI's decode: beam 5, rp 5.0, ngram 2, suppress lists on
    "cli": dict(num_beams=5, repetition_penalty=5.0, no_repeat_ngram_size=2,
                tokenizer=True),
    "cli_eos_hits": dict(num_beams=5, repetition_penalty=5.0,
                         no_repeat_ngram_size=2, tokenizer=True, eos=1),
    "lp_early_stop": dict(num_beams=3, length_penalty=0.5,
                          early_stopping=True, eos=0),
    "min_new": dict(num_beams=4, min_new_tokens=3, eos=0),
    "degenerate_budget": dict(num_beams=3, max_length=3),
    # 17 beams x 4 prompt tokens: the prefill's folded cross query has 68
    # rows, more than the cross-attention kernel holds at once
    "wide_prefill": dict(num_beams=17, eos=0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_tokens_equal_jax(setup, greedy_first, case):
    kw = dict(CASES[case])
    if "eos" in kw:
        kw["eos_id"] = greedy_first[kw.pop("eos")]
    p = setup[-1].shape[1]
    kw.setdefault("max_length", p + N_NEW)
    seq, scores, ours, our_scores = _both(setup, **kw)
    assert ours.shape == seq.shape == (3, kw["max_length"])
    np.testing.assert_array_equal(ours, seq)
    np.testing.assert_allclose(our_scores, scores, rtol=1e-5, atol=1e-6)
    if case == "degenerate_budget":
        np.testing.assert_array_equal(ours, setup[-1][:, :kw["max_length"]])
    if case == "cli":
        # the utterances decode differently, so beam rows folded into the
        # wrong utterance's cross-attention would show
        assert len({tuple(r[p:]) for r in ours}) == 3


@pytest.mark.parametrize("eos", [3, 50])
def test_beam_ties_equal_jax(setup, eos):
    """A zero token embedding makes every logit 0: every candidate of every
    beam ties, hits tie with each other, and the finished set keeps -1e9
    placeholders beside equal scores. The tie order (beam-major, then
    vocabulary id, as lax.top_k) decides every pick."""
    jconfig, jstem, tconfig, params, *_ = setup
    dec = dict(params["decoder"],
               token_embed=np.zeros_like(params["decoder"]["token_embed"]))
    params = dict(params, decoder=dec)
    model = module_from_params(params, tconfig,
                               tc.StemConfig("base", in_channels=8),
                               device="cpu")
    p = setup[-1].shape[1]
    seq, scores, ours, our_scores = _both(
        setup, params=params, model=model, num_beams=5,
        repetition_penalty=5.0, no_repeat_ngram_size=2, eos_id=eos,
        max_length=p + 6)
    np.testing.assert_array_equal(ours, seq)
    np.testing.assert_allclose(our_scores, scores, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def model_dir(setup, tmp_path_factory):
    """A full-model directory written by the JAX package, set to compute in
    f32 with its Pallas flash kernel on."""
    jconfig, jstem, _, params, *_ = setup
    out = jax_common.save_full_model(
        str(tmp_path_factory.mktemp("full_model")), params, jconfig, jstem)
    with open(f"{out}/config.json") as f:
        meta = json.load(f)
    meta["config"].update(dtype="float32", flash_attention="on")
    with open(f"{out}/config.json", "w") as f:
        json.dump(meta, f)
    return out


def test_beam_transcriber_texts_equal_jax(model_dir):
    """The eval CLI's decode settings through both Transcribers, with a
    short clip and a last chunk padded to the batch."""
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)
    signals[1, :, 200:] = 0.0
    kw = dict(num_beams=5, repetition_penalty=5.0, no_repeat_ngram_size=2,
              batch_size=2, max_new_tokens=N_NEW)
    ref = JaxTranscriber(model_dir, **kw).transcribe(signals)
    ours = Transcriber(model_dir, device="cpu", **kw).transcribe(signals)
    assert len(ours) == 3 and any(ours)
    assert ours == ref
