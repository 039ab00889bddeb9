"""The port's metric battery and text post-processing
(neuspeech1_tpu_torch/metrics/, utils/text.py) against the JAX package's,
on hypothesis-drawn strings: every result exactly equal. METEOR runs twice,
with nltk's stemmer (and the wordnet stage where its corpus is installed)
and with both stages off in both packages, the path of a machine without
nltk."""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from neuspeech1_tpu.metrics import battery as jb
from neuspeech1_tpu.metrics import bleu as jbleu
from neuspeech1_tpu.metrics import edit as jedit
from neuspeech1_tpu.metrics import meteor as jmeteor
from neuspeech1_tpu.metrics import rouge as jrouge
from neuspeech1_tpu.utils import text as jtext
from neuspeech1_tpu_torch.metrics import battery as tb
from neuspeech1_tpu_torch.metrics import bleu as tbleu
from neuspeech1_tpu_torch.metrics import edit as tedit
from neuspeech1_tpu_torch.metrics import meteor as tmeteor
from neuspeech1_tpu_torch.metrics import rouge as trouge
from neuspeech1_tpu_torch.utils import text as ttext

# repeated words, punctuation (ascii and CJK), case, stems and CJK text
WORDS = ["the", "The", "cat", "cats", "sat", "sitting", "on", "mat", "dog",
         "dogs", "ran", "running", "fast", "a", "A", "brain", "signals",
         "decode", "speech", "hello,", "world.", "ok!", "why?", "一", "個",
         "們", "說話", "大腦", "信號", "。", "，", "！", "　"]
SENTENCE = st.lists(st.sampled_from(WORDS), max_size=9).map(" ".join)
PAIRS = st.lists(st.tuples(SENTENCE, SENTENCE), min_size=1, max_size=5)
CJK = st.text(alphabet="萬與專業東兩嚴個為麗樂書買亂雲們價會體傳兒內寫軍"
              "農決況幾鳳別動勞勢一二三 abc,.!?。，", max_size=20)
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow,
                                           HealthCheck.function_scoped_fixture])


def _split(pairs):
    return [p for p, _ in pairs], [r for _, r in pairs]


@SETTINGS
@given(PAIRS)
def test_edit_and_word_measures(pairs):
    preds, refs = _split(pairs)
    for p, r in pairs:
        assert tedit.edit_counts(r.split(), p.split()) == \
            jedit.edit_counts(r.split(), p.split())
        assert tedit.edit_counts(list(r), list(p)) == \
            jedit.edit_counts(list(r), list(p))
    assert tedit.word_measures(preds, refs) == jedit.word_measures(preds, refs)
    assert tedit.wer(preds, refs) == jedit.wer(preds, refs)
    assert tedit.cer(preds, refs) == jedit.cer(preds, refs)


@SETTINGS
@given(PAIRS)
def test_bleu_and_rouge(pairs):
    preds, refs = _split(pairs)
    assert tbleu.bleu_battery(preds, refs) == jbleu.bleu_battery(preds, refs)
    refs_list = [[r, p] for p, r in pairs]
    assert tbleu.corpus_bleu(preds, refs_list) == \
        jbleu.corpus_bleu(preds, refs_list)
    for p, r in pairs:
        assert trouge.rouge_pair(p, r) == jrouge.rouge_pair(p, r)
    # newlines split rougeLsum's sentences
    nl = [(p.replace(" a ", "\n"), r.replace(" the ", "\n")) for p, r in pairs]
    assert trouge.rouge_battery(*_split(nl)) == jrouge.rouge_battery(*_split(nl))


@pytest.fixture(params=["nltk", "no_nltk"])
def meteor_path(request, monkeypatch):
    """METEOR with the stages this process has (nltk's stemmer; wordnet
    where its corpus is installed), or with both off in both packages."""
    if request.param == "no_nltk":
        for mod in (jmeteor, tmeteor):
            monkeypatch.setattr(mod, "_STEMMER", None)
            monkeypatch.setattr(mod, "_HAS_WORDNET", False)
    else:
        assert tmeteor._STEMMER is not None and jmeteor._STEMMER is not None
    return request.param


@SETTINGS
@given(pairs=PAIRS)
def test_meteor(meteor_path, pairs):
    preds, refs = _split(pairs)
    for p, r in pairs:
        assert tmeteor.single_meteor_score(r.split(), p.split()) == \
            jmeteor.single_meteor_score(r.split(), p.split())
    assert tmeteor.meteor_battery(preds, refs) == \
        jmeteor.meteor_battery(preds, refs)
    assert tmeteor.stages() == {"exact": True,
                                "stem": tmeteor._STEMMER is not None,
                                "wordnet": tmeteor._HAS_WORDNET}


@SETTINGS
@given(pairs=PAIRS)
def test_battery_rows_and_char_split(meteor_path, pairs):
    preds, refs = _split(pairs)
    assert tb.compute_battery(preds, refs) == jb.compute_battery(preds, refs)
    assert tb.per_sentence_metrics(preds, refs) == \
        jb.per_sentence_metrics(preds, refs)
    assert tb.char_split_battery(preds, refs) == \
        jb.char_split_battery(preds, refs)


@SETTINGS
@given(st.lists(SENTENCE, max_size=12), st.integers(0, 5))
def test_random_choice_baseline(refs, seed):
    assert tb.random_choice_baseline(refs, seed) == \
        jb.random_choice_baseline(refs, seed)


@SETTINGS
@given(st.lists(CJK, max_size=6), st.lists(SENTENCE, max_size=6))
def test_text_post_processing(cjk, texts):
    both = cjk + texts
    assert ttext.filter_ascii_list(both) == jtext.filter_ascii_list(both)
    assert ttext.convert_lower_text(both) == jtext.convert_lower_text(both)
    assert ttext.remove_punctuation(both) == jtext.remove_punctuation(both)
    assert ttext.to_simple(both) == jtext.to_simple(both)
    for t in both:
        assert ttext.to_simple(t) == jtext.to_simple(t)
        assert ttext.remove_punctuation(t) == jtext.remove_punctuation(t)


def test_write_results_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    preds = [" ".join(rng.choice(WORDS, 5)) for _ in range(6)]
    refs = [" ".join(rng.choice(WORDS, 4)) for _ in range(6)]
    metrics = jb.compute_battery(preds, refs)
    fj = jb.write_results(str(tmp_path / "j" / "x"), preds, refs, metrics)
    ft = tb.write_results(str(tmp_path / "t" / "x"), preds, refs,
                          tb.compute_battery(preds, refs))
    assert fj.keys() == ft.keys()
    for k in fj:
        assert open(fj[k], "rb").read() == open(ft[k], "rb").read(), k
    assert json.load(open(ft["json"])) == metrics


def test_local_model_metrics_equal(tmp_path):
    """BERTScore and perplexity from tiny random local HF models (the JAX
    package's gated-metric fixtures): the two packages' batteries are
    equal."""
    torch = pytest.importorskip("torch")
    transformers = pytest.importorskip("transformers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat",
             "sat", "on", "mat", "dog", "ran", "fast"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    tok = transformers.BertTokenizer(str(tmp_path / "vocab.txt"))
    torch.manual_seed(0)
    enc = tmp_path / "bert"
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64)).save_pretrained(enc)
    tok.save_pretrained(enc)
    lm = tmp_path / "gpt2"
    transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=len(vocab), n_embd=16, n_layer=2, n_head=2,
        n_positions=64)).save_pretrained(lm)
    tok.save_pretrained(lm)
    preds = ["the cat sat on mat", "dog ran fast", "the dog"]
    refs = ["the cat sat", "the dog ran fast", "cat on mat"]
    kw = dict(bertscore_model=str(enc), perplexity_model=str(lm))
    ours = tb.compute_battery(preds, refs, **kw)
    assert ours == jb.compute_battery(preds, refs, **kw)
    assert {"bert_score_f1", "ppl_pred", "ppl_label"} <= set(ours)
