"""The port's timestamp decoding (neuspeech1_tpu_torch/decode/timestamps.py)
against the JAX package's, in f32 on the CPU: the grammar processor on
each state of the grammar, the median filter and DTW, the cross-attention
maps (within the bound the JAX package holds against HF torch), token
timestamps and ``Transcriber.transcribe_with_timestamps`` (equal lists:
the times come from the same DTW path), and greedy, beam search and the
other modes under the grammar (equal tokens)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jax_common
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import timestamps as jts
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.serve import Transcriber as JaxTranscriber
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import timestamps as tts
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.serve import Transcriber
from tests.test_torch_sampling import N_NEW, _gens, _port_inputs, setup  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4


def _prefix(c):
    return [c.sot_id, c.first_language_id, c.transcribe_id]


def _states(c):
    """Rows of tokens in each grammar state (tests/test_timestamps.py's
    four), plus a row past a closed pair and the max-initial clamp's row,
    each with its prompt length 3."""
    ts = c.timestamp_begin
    p = _prefix(c)
    return {
        "first_position": [p],
        "after_single_timestamp": [p + [ts + 2, 5, 7]],
        "after_timestamp_pair": [p + [ts + 2, 5, ts + 9, ts + 9]],
        "text_then_close": [p + [ts + 2, 5, 6, ts + 8]],
        "mixed_rows": [p + [ts + 2, 5, 6, ts + 8], p + [ts + 3, 9, 9, 9],
                       p + [ts + 1, ts + 1, 4, 4]],
    }


@pytest.mark.parametrize("state", ["first_position", "after_single_timestamp",
                                   "after_timestamp_pair", "text_then_close",
                                   "mixed_rows"])
@pytest.mark.parametrize("max_initial", [50, None])
def test_timestamp_rules_equal_jax(setup, state, max_initial):
    c = setup[2]
    rows = np.asarray(_states(c)[state], np.int32)
    cur_len = rows.shape[1]
    buf = np.concatenate([rows, np.full((rows.shape[0], 4), c.eot_id,
                                        np.int32)], axis=1)
    logits = np.random.default_rng(cur_len).standard_normal(
        (rows.shape[0], c.vocab_size)).astype(np.float32)
    # a peak on the timestamps, so the mass rule fires in some rows
    logits[0, c.timestamp_begin:c.timestamp_begin + 40] += 3.0
    ref = np.asarray(jts.timestamp_rules(
        jnp.asarray(logits), jnp.asarray(buf), jnp.asarray(cur_len), setup[0],
        3, max_initial))
    ours = tts.timestamp_rules(torch.from_numpy(logits),
                               torch.from_numpy(buf.astype(np.int64)),
                               cur_len, c, 3, max_initial)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ours.numpy() < -1e8).any(axis=1).all()


def test_median_filter_and_dtw_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 40))
    for width in (1, 3, 7):
        np.testing.assert_array_equal(tts.median_filter(x, width),
                                      jts.median_filter(x, width))
    # integer costs: ties at every turn, where the move order decides
    for cost in (rng.standard_normal((6, 30)),
                 rng.integers(0, 3, (7, 20)).astype(np.float64),
                 np.ones((4, 4))):
        for a, b in zip(tts.dtw_path(cost), jts.dtw_path(cost)):
            np.testing.assert_array_equal(a, b)


def test_cross_attention_maps_within_bound(setup):
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    toks = np.asarray([_prefix(tconfig) + [40, 41, 300, 42, 256]] * 2,
                      np.int32)
    enc_j = jw.encoder_apply(params, feats[:2], jconfig, jstem)
    ref = np.asarray(jts.cross_attention_maps(params, jnp.asarray(toks), enc_j,
                                              jconfig))
    with torch.no_grad():
        enc_t = tw.encoder_apply(model, torch.from_numpy(feats[:2]))
    ours = tts.cross_attention_maps(model, torch.from_numpy(
        toks.astype(np.int64)), enc_t)
    assert ours.dtype == torch.float32
    assert ours.shape == (jconfig.decoder_layers, 2, jconfig.decoder_heads,
                          toks.shape[1], jconfig.max_source_positions)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("row", [0, 1, 2])
def test_word_timestamps_equal_jax(setup, row):
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    ids = _prefix(tconfig) + [40, 41, 300, 42, 90, 77, 256]
    ref = jts.word_timestamps(params, jnp.asarray(feats[row:row + 1]), ids,
                              jconfig, jstem)
    ours = tts.word_timestamps(model, torch.from_numpy(feats[row:row + 1]),
                               ids)
    assert ours == ref
    assert [r["token"] for r in ours] == [40, 41, 42, 90, 77]
    assert all(0.0 <= r["start"] <= r["end"] for r in ours)


MODES = {
    "greedy": dict(),
    "beam": dict(num_beams=3),
    "beam_cli": dict(num_beams=5, repetition_penalty=5.0,
                     no_repeat_ngram_size=2),
    "contrastive": dict(penalty_alpha=1.0, top_k=3),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_under_the_grammar_equals_jax(setup, mode):
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    p = prompt.shape[1]
    jgen, tgen = _gens(setup, max_length=p + N_NEW, timestamps=True,
                       **MODES[mode])
    ref = np.asarray(jg.generate(params, feats, prompt, jconfig, jstem, jgen))
    ours = tg.generate(model, *_port_inputs(setup), tgen).numpy()
    np.testing.assert_array_equal(ours, ref)
    # the first generated token is a timestamp: the grammar ran
    assert (ours[:, p] >= tconfig.timestamp_begin).all()
    assert tgen.timestamp_begin == tconfig.timestamp_begin
    assert tgen.notimestamps_id == tconfig.notimestamps_id


def test_spec_refuses_the_grammar(setup):
    from neuspeech1_tpu_torch.decode.spec import spec_greedy_decode

    _, tgen = _gens(setup, max_length=setup[-1].shape[1] + 4,
                    timestamps=True)
    with pytest.raises(NotImplementedError, match="timestamps"):
        spec_greedy_decode(setup[4], *_port_inputs(setup), tgen, gamma=2)


@pytest.fixture(scope="module")
def model_dir(setup, tmp_path_factory):
    """A full-model directory written by the JAX package, computing in f32
    with its Pallas flash kernel on."""
    jconfig, jstem, _, params, *_ = setup
    out = jax_common.save_full_model(
        str(tmp_path_factory.mktemp("full_model")), params, jconfig, jstem)
    with open(f"{out}/config.json") as f:
        meta = json.load(f)
    meta["config"].update(dtype="float32", flash_attention="on")
    with open(f"{out}/config.json", "w") as f:
        json.dump(meta, f)
    return out


def test_transcribe_with_timestamps_equals_jax(model_dir):
    signals = np.random.default_rng(5).standard_normal(
        (2, 8, 400)).astype(np.float32)
    signals[1, :, 200:] = 0.0
    kw = dict(max_new_tokens=N_NEW, repetition_penalty=5.0,
              no_repeat_ngram_size=2)
    ref = JaxTranscriber(model_dir, **kw).transcribe_with_timestamps(signals)
    ours = Transcriber(model_dir, device="cpu",
                       **kw).transcribe_with_timestamps(signals)
    assert ours == ref
    assert len(ours) == 2 and all(ours)
