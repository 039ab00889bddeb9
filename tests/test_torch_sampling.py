"""The port's sampling (neuspeech1_tpu_torch/decode/generate.py::
sample_decode), beam-sample (``beam_search`` with ``do_sample``) and the
warpers (decode/logits_process.py) against the JAX package, in f32 on the
CPU.

A ``torch.Generator`` cannot reproduce ``jax.random``'s draws, so the draws
are handed to the port: for sampling, the JAX function's own Gumbel noise
(``jax.random.categorical`` is the argmax of the scores plus
``jax.random.gumbel`` of the step's folded key); for beam-sample, one noise
tensor given to both packages. Tokens must be equal, scores within f32
rounding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu import config as jc
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import logits_process as jlp
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import logits_process as tlp
from neuspeech1_tpu_torch.models.convert import module_from_params
from tests.test_torch_beam import TINY, scaled_params

torch.set_num_threads(1)

N_NEW = 10


@pytest.fixture(scope="module")
def setup():
    """One config of each package from the same kwargs, the JAX weights,
    the port's model on them, three utterances and their prompts."""
    jconfig, tconfig = jc.tiny_config(**TINY), tc.tiny_config(**TINY)
    assert dataclasses.asdict(jconfig) == dataclasses.asdict(tconfig)
    jstem = jc.StemConfig("base", in_channels=8)
    params = scaled_params(jconfig, jstem)
    feats = np.random.default_rng(0).standard_normal(
        (3, 8, 400)).astype(np.float32)
    prompt = np.asarray([JaxByteTokenizer(jconfig).prefix_tokens()] * 3,
                        np.int32)
    model = module_from_params(params, tconfig,
                               tc.StemConfig("base", in_channels=8),
                               device="cpu")
    return jconfig, jstem, tconfig, params, model, feats, prompt


def _port_inputs(setup):
    *_, feats, prompt = setup
    return torch.from_numpy(feats), torch.from_numpy(prompt.astype(np.int64))


def _gens(setup, **kw):
    jconfig, _, tconfig, *_ = setup
    return (jg.GenerationConfig.for_model(jconfig, **kw),
            tg.GenerationConfig.for_model(tconfig, **kw))


# --------------------------------------------------------------------------
# the warpers
# --------------------------------------------------------------------------

def _rows_with_ties(vocab: int):
    """Random rows with runs of equal scores (around the top-k and top-p
    thresholds too) and banned entries."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, vocab)).astype(np.float32)
    x[:, 10:20] = x[:, 10:11]
    top = np.argsort(x, axis=1)[:, -6:]
    x[np.arange(5)[:, None], top[:, :3]] = x[np.arange(5), top[:, 3]][:, None]
    x[1, :] = 0.5                        # a row of ties only
    x[2, 100:] = -1e9                    # a processor's bans
    x[3] *= 8.0                          # a peaked row: top-p keeps few
    return x


WARPS = {
    "temperature": ("temperature_warp", (1.3,), {}),
    "temperature_low": ("temperature_warp", (0.7,), {}),
    "top_k": ("top_k_warp", (5,), {}),
    "top_k_1_keep_2": ("top_k_warp", (1,), {"min_tokens_to_keep": 2}),
    "top_k_off": ("top_k_warp", (0,), {}),
    "top_p": ("top_p_warp", (0.9,), {}),
    "top_p_small_keep_2": ("top_p_warp", (0.05,), {"min_tokens_to_keep": 2}),
    "top_p_off": ("top_p_warp", (1.0,), {}),
}


@pytest.mark.parametrize("case", list(WARPS))
def test_warpers_equal_jax(setup, case):
    name, args, kw = WARPS[case]
    x = _rows_with_ties(setup[0].vocab_size)
    ref = np.asarray(getattr(jlp, name)(jnp.asarray(x), *args, **kw))
    ours = getattr(tlp, name)(torch.from_numpy(x), *args, **kw).numpy()
    np.testing.assert_array_equal(ours, ref)
    if case in ("top_k", "top_p_small_keep_2"):
        assert (ours[0] < -1e8).any() and (ours[0] > -1e8).sum() >= 2


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def jax_step_noise(key, shape, length):
    """The Gumbel noise JAX's ``sample_decode`` draws at each write position
    (``jax.random.categorical`` on the step's folded key): [length,
    *shape]."""
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, c), shape, jnp.float32))
        for c in range(length)])


SAMPLE_CASES = {
    "plain": dict(),
    "rp_ngram": dict(repetition_penalty=5.0, no_repeat_ngram_size=2),
    "warpers": dict(temperature=1.3, top_k=20, top_p=0.9,
                    repetition_penalty=5.0, no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_decode_equals_jax(setup, case):
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    length = prompt.shape[1] + N_NEW
    jgen, tgen = _gens(setup, max_length=length, do_sample=True,
                       **SAMPLE_CASES[case])
    key = jax.random.key(3)
    ref = np.asarray(jg.sample_decode(params, feats, prompt, key, jconfig,
                                      jstem, jgen))
    noise = jax_step_noise(key, (3, jconfig.vocab_size), length)
    ours = tg.sample_decode(model, *_port_inputs(setup), tgen,
                            sample_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the draws matter: greedy decodes otherwise
    greedy = tg.greedy_decode(model, *_port_inputs(setup),
                              dataclasses.replace(tgen, do_sample=False))
    assert not torch.equal(ours, greedy)


def test_sample_seed_is_deterministic(setup):
    """One seed, one draw sequence: the same tokens twice; another seed
    draws others. A generator's draws and the same draws handed in as a
    noise source give the same tokens (one code path)."""
    _, _, _, _, model, *_ = setup
    length = setup[-1].shape[1] + N_NEW
    _, tgen = _gens(setup, max_length=length, do_sample=True, top_k=50)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tg.sample_decode(model, *_port_inputs(setup), tgen,
                                generator=g, **kw)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    source = tg.gumbel_noise(torch.Generator().manual_seed(0))
    d = tg.sample_decode(model, *_port_inputs(setup), tgen,
                         sample_noise=source)
    assert torch.equal(a, d)
    e = tg.generate(model, *_port_inputs(setup), tgen,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, e)


# --------------------------------------------------------------------------
# beam-sample
# --------------------------------------------------------------------------

BEAM_SAMPLE_CASES = {
    "plain": dict(num_beams=3),
    "warpers_cli": dict(num_beams=3, temperature=1.3, top_k=20, top_p=0.9,
                        repetition_penalty=5.0, no_repeat_ngram_size=2),
    "top_k_1": dict(num_beams=4, top_k=1),
}


@pytest.mark.parametrize("case", list(BEAM_SAMPLE_CASES))
def test_beam_sample_equals_jax(setup, case):
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    kw = BEAM_SAMPLE_CASES[case]
    length = prompt.shape[1] + N_NEW
    jgen, tgen = _gens(setup, max_length=length, do_sample=True, **kw)
    k = kw["num_beams"]
    noise = np.random.default_rng(7).gumbel(
        size=(length, 3, k * jconfig.vocab_size)).astype(np.float32)
    seq, scores = jg.beam_search(params, feats, prompt, jconfig, jstem, jgen,
                                 sample_noise=jnp.asarray(noise))
    ours, our_scores = tg.beam_search(model, *_port_inputs(setup), tgen,
                                      sample_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(seq))
    np.testing.assert_allclose(our_scores.numpy(), np.asarray(scores),
                               rtol=1e-5, atol=1e-6)
    plain, _ = tg.beam_search(model, *_port_inputs(setup),
                              dataclasses.replace(tgen, do_sample=False))
    assert not torch.equal(ours, plain)


def test_beam_sample_without_noise_is_beam_search(setup):
    """Zero noise and identity warpers: the candidates are beam search's, in
    its order, so are the tokens and scores (the eval CLI's settings)."""
    length = setup[-1].shape[1] + N_NEW
    k = 5
    _, tgen = _gens(setup, max_length=length, num_beams=k,
                    repetition_penalty=5.0, no_repeat_ngram_size=2)
    model = setup[4]
    ref, ref_scores = tg.beam_search(model, *_port_inputs(setup), tgen)
    zeros = torch.zeros((length, 3, k * setup[0].vocab_size))
    ours, scores = tg.beam_search(
        model, *_port_inputs(setup), dataclasses.replace(tgen, do_sample=True),
        sample_noise=zeros)
    assert torch.equal(ours, ref) and torch.equal(scores, ref_scores)


def test_beam_sample_seed_is_deterministic(setup):
    length = setup[-1].shape[1] + N_NEW
    _, tgen = _gens(setup, max_length=length, num_beams=3, do_sample=True,
                    temperature=1.3)

    def run(seed):
        return tg.generate(setup[4], *_port_inputs(setup), tgen,
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
