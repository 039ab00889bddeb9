"""The port's int8 decode cross cache (neuspeech1_tpu_torch/models/
whisper.py::init_cache(int8_cross=True), models/quantize.py) against the
JAX package, in f32 on the CPU: the quantized cache exactly, then greedy,
beam-5 and speculative tokens under it exactly, and the Transcriber's
``int8_kv_cache`` option."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import spec as jspec
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.quantize import quantize_int8 as jax_quantize_int8
from neuspeech1_tpu.serve import Transcriber as JaxTranscriber
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import spec as tspec
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.models.quantize import quantize_int8
from neuspeech1_tpu_torch.serve import Transcriber
from neuspeech1_tpu_torch.utils.tokenizer import ByteTokenizer as TByteTokenizer
# the tiny model of the greedy tests, its inputs and its model directory
from tests.test_torch_decode import model_dir, setup  # noqa: F401
from tests.test_torch_whisper import port

torch.set_num_threads(1)

N_NEW = 10


def test_quantize_int8_equals_jax():
    """Half-way values round to even in both; an all-zero column gets
    scale 1."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 40, 8)).astype(np.float32)
    x[0, 0, :, 1] = 0.0
    # a column whose max maps to 127 exactly, with values at k + 0.5 steps
    x[1, 2, :, 3] = (np.arange(40) - 20 + 0.5) * (127.0 / 19.5) / 127.0
    q, s = quantize_int8(torch.from_numpy(x))
    qj, sj = jax_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (2, 3, 1, 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert s[0, 0, 0, 1] == 1.0


def test_int8_cross_cache_equals_jax(setup):
    """The cross K/V projections on a grid of exact binary fractions (so
    that every sum is exact in f32 in any order), then quantized: k_qt,
    k_s, v_qt and v_s equal the JAX package's. The self cache takes the
    speculative layout beside it."""
    config, stem, params, _, _, _, _ = setup
    rng = np.random.default_rng(1)
    ca = dict(params["decoder"]["layers"]["cross_attn"])
    ca["k"] = {"w": rng.integers(-8, 9, ca["k"]["w"].shape) / 16.0}
    ca["v"] = {"w": rng.integers(-8, 9, ca["v"]["w"].shape) / 16.0,
               "b": rng.integers(-8, 9, ca["v"]["b"].shape) / 16.0}
    ca = {k: {n: np.asarray(a, np.float32) for n, a in v.items()}
          for k, v in ca.items()}
    layers = dict(params["decoder"]["layers"], cross_attn=ca)
    params = dict(params, decoder=dict(params["decoder"], layers=layers))
    model = module_from_params(params, port(config), port(stem), device="cpu")
    enc = (rng.integers(-4, 5, (2, config.max_source_positions,
                                config.d_model)) / 4.0).astype(np.float32)
    ref = jw.init_cache(params, jnp.asarray(enc), config, max_len=12,
                        int8_cross=True, self_t_major=True)
    ours = tw.init_cache(model, torch.from_numpy(enc), max_len=12,
                         int8_cross=True, self_t_major=True)
    h, dh = config.decoder_heads, config.d_model // config.decoder_heads
    for r, o in zip(ref["cross"], ours["cross"]):
        assert set(o) == {"k_qt", "k_s", "v_qt", "v_s"}
        assert o["k_qt"].shape == (2, h, dh, config.max_source_positions)
        assert o["k_qt"].dtype == torch.int8 and o["k_s"].shape == (2, h, 1, dh)
        for name in o:
            np.testing.assert_array_equal(o[name].numpy(), np.asarray(r[name]),
                                          err_msg=name)
        # the quantization is not degenerate: the values use the int8 range
        assert o["k_qt"].abs().max() == 127
    for r, o in zip(ref["self"], ours["self"]):
        assert set(o) == set(r) == {"k_tu", "v_tu"}
        assert o["k_tu"].shape == r["k_tu"].shape == (2, h, dh, 12)


def _gen(config, tokenizer, **kw):
    kw.setdefault("max_length", 4 + N_NEW)
    return (jg.GenerationConfig.for_model(config, int8_kv_cache=True,
                                          tokenizer=tokenizer[0], **kw),
            tg.GenerationConfig.for_model(port(config), int8_kv_cache=True,
                                          tokenizer=tokenizer[1], **kw))


@pytest.mark.parametrize("mode", ["greedy", "beam_cli", "spec"])
def test_int8_tokens_equal_jax(setup, mode):
    """Greedy, the eval CLI's beam-5 decode (the int8 branch after the beam
    fold) and speculative decoding at gamma 2 under the int8 cache."""
    config, stem, params, model, feats, prompt, tok = setup
    kw = dict(num_beams=5, repetition_penalty=5.0,
              no_repeat_ngram_size=2) if mode == "beam_cli" else {}
    # the suppress lists keep eos off the first position
    jgen, tgen = _gen(config, (tok, TByteTokenizer(port(config))), **kw)
    args = (torch.from_numpy(feats), torch.from_numpy(prompt.astype(np.int64)))
    if mode == "greedy":
        ref = jg.greedy_decode(params, feats, prompt, config, stem, jgen)
        ours = tg.greedy_decode(model, *args, tgen)
    elif mode == "beam_cli":
        ref, _ = jg.beam_search(params, feats, prompt, config, stem, jgen)
        ours, _ = tg.beam_search(model, *args, tgen)
    else:
        ref, ref_iters = jspec.spec_greedy_decode(params, feats, prompt,
                                                  config, stem, jgen, gamma=2)
        ours, iters = tspec.spec_greedy_decode(model, *args, tgen, gamma=2)
        assert iters == int(ref_iters)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the rows decode past their first token
    assert (ours[:, prompt.shape[1]:] != tgen.eos_id).sum() > N_NEW


@pytest.mark.parametrize("gamma,max_length", [(2, 14), (4, 20)])
def test_spec_equals_greedy_under_int8(setup, gamma, max_length):
    """Spec matches greedy under the same quantized cache (both quantize
    identically): tests/test_spec_decode.py's check, on the port."""
    config, _, _, model, feats, prompt, _ = setup
    gen = tg.GenerationConfig.for_model(port(config), max_length=max_length,
                                        int8_kv_cache=True)
    args = (model, torch.from_numpy(feats),
            torch.from_numpy(prompt.astype(np.int64)))
    gold = tg.greedy_decode(*args, gen)
    ours, iters = tspec.spec_greedy_decode(*args, gen, gamma=gamma)
    np.testing.assert_array_equal(ours.numpy(), gold.numpy())
    assert iters <= max_length - prompt.shape[1]


@pytest.mark.parametrize("kw", [dict(), dict(num_beams=5,
                                             repetition_penalty=5.0,
                                             no_repeat_ngram_size=2)])
def test_int8_transcriber_texts_equal_jax(model_dir, kw):  # noqa: F811
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)
    signals[1, :, 200:] = 0.0
    kw = dict(kw, batch_size=2, max_new_tokens=12, int8_kv_cache=True)
    ref = JaxTranscriber(model_dir, **kw).transcribe(signals)
    ours = Transcriber(model_dir, device="cpu", **kw).transcribe(signals)
    assert len(ours) == 3 and any(ours)
    assert ours == ref
