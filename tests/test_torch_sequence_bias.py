"""The port's sequence bias (neuspeech1_tpu_torch/decode/sequence_bias.py,
yake.py and logits_process.py::sequence_bias) against the JAX package's, in
f32 on the CPU: the same specs from a training manifest, the same biased
scores bit for bit at greedy and beam shapes, the same greedy and beam
tokens under a bias, and speculative decoding refusing one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu import config as jc
from neuspeech1_tpu.data.synthetic import _WORDS, make_synthetic_corpus
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import logits_process as jlp
from neuspeech1_tpu.decode import sequence_bias as jsb
from neuspeech1_tpu.decode import yake as jyake
from neuspeech1_tpu.models.init import init_params as jax_init_params
from neuspeech1_tpu.utils.tokenizer import make_tokenizer as jtok
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import logits_process as tlp
from neuspeech1_tpu_torch.decode import sequence_bias as tsb
from neuspeech1_tpu_torch.decode import yake as tyake
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer as ttok

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bias"))
    make_synthetic_corpus(root, n_clips=14, n_channels=4, seed=3,
                          with_audio=False)
    vocab = f"{root}/vocab.txt"
    with open(vocab, "w") as f:
        f.write("\n".join(_WORDS) + "\n")
    return root, vocab


def _tokenizers(vocab, spec):
    if spec == "byte":
        return jtok("byte", jc.tiny_config()), ttok("byte", tc.tiny_config())
    return jtok(f"word:{vocab}"), ttok(f"word:{vocab}")


def _spec_arrays(spec):
    return tuple(np.asarray(x) for x in (spec.seqs, spec.lengths,
                                         spec.biases))


@pytest.mark.parametrize("tok", ["byte", "word"])
@pytest.mark.parametrize("kind", ["word", "phrase", "phrase_word"])
def test_build_sequence_bias_specs_equal(corpus, tok, kind):
    root, vocab = corpus
    tj, tt = _tokenizers(vocab, tok)
    sj = jsb.build_sequence_bias(f"{root}/train.jsonl", tj, bias=-0.7,
                                 extract_type=kind)
    st = tsb.build_sequence_bias(f"{root}/train.jsonl", tt, bias=-0.7,
                                 extract_type=kind)
    for a, b in zip(_spec_arrays(sj), _spec_arrays(st)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_yake_keywords_equal():
    texts = ["The quick brown fox jumps over the lazy dog. The dog sleeps.",
             "Brain signals decode speech; MEG signals in the Brain.",
             "tiny birds sing softly in green trees near clear water",
             "", "a a a", "NASA and the ESA launch 3 rockets, 2 satellites!"]
    for n, top, dedup in ((3, 20, 0.9), (2, 5, 0.5), (1, 3, 1.0)):
        ej = jyake.YakeExtractor(max_ngram=n, top=top, dedup_lim=dedup)
        et = tyake.YakeExtractor(max_ngram=n, top=top, dedup_lim=dedup)
        for t in texts:
            assert et.extract_keywords(t) == ej.extract_keywords(t)
    assert tsb.extract_phrases(texts, cannot_be_single_word=True) == \
        jsb.extract_phrases(texts, cannot_be_single_word=True)


def _bias_map(rng, n_entries, vocab, max_len, weights):
    """Entries of lengths 1..max_len over a small id range (so prefixes
    match), many sharing a last token, with the given bias values."""
    out = {}
    while len(out) < n_entries:
        n = int(rng.integers(1, max_len + 1))
        out[tuple(int(x) for x in rng.integers(0, vocab, n))] = float(
            rng.choice(weights))
    return out


SHAPES = {"greedy": 3, "beam": 3 * 5}
WEIGHTS = {"cli": [-1.0], "dyadic": [-1.0, 0.5, 2.0],
           "rounding": [0.1, -0.3, 0.7, 1.3]}
# up to 32 entries XLA sums them in order; past that in windows of 32
ENTRIES = (20, 60)


@pytest.mark.parametrize("entries", ENTRIES)
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sequence_bias_scores_equal_jax(shape, weights, entries):
    rng = np.random.default_rng(
        [sorted(SHAPES).index(shape), sorted(WEIGHTS).index(weights),
         entries])
    rows, vocab, length = SHAPES[shape], 40, 24
    bias_map = _bias_map(rng, entries, 6, 4, WEIGHTS[weights])
    bias_map[(7,)] = 0.25          # length 1: applies at every position
    # needs a 3-token prefix; its bias keeps the set's kind of sums
    bias_map[(3, 3, 3, 9)] = -0.9 if weights == "rounding" else -0.5
    sj = jlp.SequenceBiasSpec.build(bias_map)
    st = tlp.SequenceBiasSpec.build(bias_map)
    # sums exact in any order take the single index_add_, others the
    # ordered plan
    assert (st.tables("cpu")[-1] is None) == (weights != "rounding")
    logits = rng.standard_normal((rows, vocab)).astype(np.float32)
    tokens = rng.integers(0, 6, (rows, length)).astype(np.int32)
    tokens[0, :5] = 3
    moved = 0
    for cur_len in (0, 1, 2, 3, 5, 11, length - 1):
        ref = np.asarray(jlp.sequence_bias(jnp.asarray(logits),
                                           jnp.asarray(tokens), cur_len, sj))
        ours = tlp.sequence_bias(torch.from_numpy(logits),
                                 torch.from_numpy(tokens.astype(np.int64)),
                                 cur_len, st).numpy()
        assert ours.dtype == ref.dtype
        assert ours.tobytes() == ref.tobytes(), cur_len
        moved += int((ours != logits).sum())
    assert moved > 0


@pytest.mark.parametrize("biases, exact", [
    ([-1.0] * 1100, True),
    ([-1.0, 0.5, 2.0, 0.25], True),
    ([2.0 ** 24], True),
    ([2.0 ** 24, 1.0], False),     # 2^24 + 1 is not an f32 number
    ([0.1], True),                 # one term: no sum rounds
    ([0.1, -0.3], False),
    ([-1.0, float("inf")], False),
])
def test_sums_exactly(biases, exact):
    biases = torch.tensor(biases, dtype=torch.float32).tolist()
    assert tlp._sums_exactly(biases) is exact


def test_sequence_bias_two_window_levels_equal_jax():
    """1100 entries: XLA sums 35 windows of 32, then two windows of those
    windows, then the two; the port follows the same tree."""
    rng = np.random.default_rng(11)
    bias_map = _bias_map(rng, 1100, 12, 3, WEIGHTS["rounding"])
    logits = rng.standard_normal((15, 30)).astype(np.float32)
    tokens = rng.integers(0, 12, (15, 10)).astype(np.int32)
    ref = np.asarray(jlp.sequence_bias(
        jnp.asarray(logits), jnp.asarray(tokens), 6,
        jlp.SequenceBiasSpec.build(bias_map)))
    ours = tlp.sequence_bias(torch.from_numpy(logits),
                             torch.from_numpy(tokens.astype(np.int64)), 6,
                             tlp.SequenceBiasSpec.build(bias_map)).numpy()
    assert ours.tobytes() == ref.tobytes()
    # 1100 padded to 1120 (10 before, 10 after), then 35 windows to 64
    # (14 before, 15 after)
    tree = tlp._xla_sum_tree(1100)
    assert [len(g) for g in tree] == [18, 17]
    assert tree[0][0] == list(range(22))
    assert tree[0][1] == list(range(22, 54))
    assert tree[-1][-1] == list(range(1078, 1100))


def test_sequence_bias_only_length_one():
    sj = jlp.SequenceBiasSpec.build({(1,): -1.0, (4,): 0.3, (2,): 0.5})
    st = tlp.SequenceBiasSpec.build({(1,): -1.0, (4,): 0.3, (2,): 0.5})
    logits = np.random.default_rng(1).standard_normal((4, 10)).astype(
        np.float32)
    tokens = np.zeros((4, 6), np.int32)
    for cur_len in (0, 4):
        ref = np.asarray(jlp.sequence_bias(jnp.asarray(logits),
                                           jnp.asarray(tokens), cur_len, sj))
        ours = tlp.sequence_bias(torch.from_numpy(logits),
                                 torch.from_numpy(tokens.astype(np.int64)),
                                 cur_len, st).numpy()
        assert ours.tobytes() == ref.tobytes()


TINY = dict(d_model=128, encoder_heads=2, decoder_heads=2, encoder_ffn=256,
            decoder_ffn=256)


@pytest.fixture(scope="module")
def model_setup():
    """One config of each package, scaled JAX weights (so tokens depend on
    the input), the port's model on them, and three utterances."""
    jconfig, tconfig = jc.tiny_config(**TINY), tc.tiny_config(**TINY)
    assert dataclasses.asdict(jconfig) == dataclasses.asdict(tconfig)
    jstem = jc.StemConfig("base", in_channels=8)
    tstem = tc.StemConfig("base", in_channels=8)
    params = jax.device_get(jax_init_params(jax.random.key(0), jconfig, jstem))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 8.0 if p[-1].key in ("w", "token_embed") else x,
        params)
    feats = np.random.default_rng(0).standard_normal((3, 8, 400)).astype(
        np.float32)
    prompt = np.asarray([jtok("byte", jconfig).prefix_tokens()] * 3, np.int32)
    model = module_from_params(params, tconfig, tstem, device="cpu")
    return jconfig, jstem, tconfig, params, model, feats, prompt


def _decode_bias_map(setup, n_new):
    """A bias map built from the unbiased greedy output: a strong negative
    bias on its first tokens and a positive one on continuations of
    multi-token entries, so that the bias changes the decode."""
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    p = prompt.shape[1]
    out = tg.greedy_decode(model, torch.from_numpy(feats),
                           torch.from_numpy(prompt.astype(np.int64)),
                           tg.GenerationConfig.for_model(
                               tconfig, max_length=p + n_new)).numpy()
    bias = {}
    for row in out:
        gen = [int(t) for t in row[p:]]
        bias[(gen[0],)] = -3.0
        bias[tuple(gen[1:3])] = 1.7
        bias[(gen[1], 65)] = 2.3
        bias[(65, 66, 67)] = 0.9
    return bias


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_biased_decode_tokens_equal_jax(model_setup, mode):
    jconfig, jstem, tconfig, params, model, feats, prompt = model_setup
    n_new = 10
    bias_map = _decode_bias_map(model_setup, n_new)
    kw = dict(max_length=prompt.shape[1] + n_new)
    if mode == "beam":
        kw.update(num_beams=5, repetition_penalty=5.0, no_repeat_ngram_size=2)
    jgen = jg.GenerationConfig.for_model(jconfig, **kw)
    tgen = tg.GenerationConfig.for_model(tconfig, **kw)
    ref = np.asarray(jg.generate(params, feats, prompt, jconfig, jstem, jgen,
                                 bias_spec=jlp.SequenceBiasSpec.build(
                                     bias_map)))
    ours = tg.generate(model, torch.from_numpy(feats),
                       torch.from_numpy(prompt.astype(np.int64)), tgen,
                       bias_spec=tlp.SequenceBiasSpec.build(bias_map)).numpy()
    np.testing.assert_array_equal(ours, ref)
    plain = tg.generate(model, torch.from_numpy(feats),
                        torch.from_numpy(prompt.astype(np.int64)),
                        tgen).numpy()
    assert not np.array_equal(ours, plain), "the bias changed nothing"


def test_spec_refuses_bias(model_setup):
    jconfig, jstem, tconfig, params, model, feats, prompt = model_setup
    kw = dict(max_length=prompt.shape[1] + 4, spec_gamma=4)
    bias_map = {(5,): -1.0}
    with pytest.raises(NotImplementedError, match="sequence bias"):
        jg.generate(params, feats, prompt, jconfig, jstem,
                    jg.GenerationConfig.for_model(jconfig, **kw),
                    bias_spec=jlp.SequenceBiasSpec.build(bias_map))
    with pytest.raises(NotImplementedError, match="sequence bias"):
        tg.generate(model, torch.from_numpy(feats),
                    torch.from_numpy(prompt.astype(np.int64)),
                    tg.GenerationConfig.for_model(tconfig, **kw),
                    bias_spec=tlp.SequenceBiasSpec.build(bias_map))
