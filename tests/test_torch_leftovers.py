"""The port's counterparts of the JAX package's last functions without one,
each against the JAX function on the same inputs, on the CPU:

- ``decode/logits_process.py::force_tokens`` (scores equal bit for bit);
- ``data/collate.py::get_part_of_dataset``;
- ``utils/text.py::generate_random_string`` (the same string from the same
  ``random`` state);
- ``data/device_cache.py::DeviceCache.make_sampler`` (rows drawn with
  replacement from a ``torch.Generator``: the batch dict of the JAX
  sampler, rows that belong to the cache);
- ``metrics/bertscore.py``'s ``read_baseline_tsv``, ``bert_score``'s
  ``rescale_baseline`` and ``baseline_path`` and ``plot_example``, on a
  random local BERT and a local TSV (scores equal, the plots' pixels
  equal)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.data import collate as jcol
from neuspeech1_tpu.data import device_cache as jdc
from neuspeech1_tpu.decode import logits_process as jlp
from neuspeech1_tpu.metrics import bertscore as jbs
from neuspeech1_tpu.utils import text as jtext
from neuspeech1_tpu_torch.data import collate as tcol
from neuspeech1_tpu_torch.data import device_cache as tdc
from neuspeech1_tpu_torch.decode import logits_process as tlp
from neuspeech1_tpu_torch.metrics import bertscore as tbs
from neuspeech1_tpu_torch.utils import text as ttext

torch.set_num_threads(1)


@pytest.mark.parametrize("cur_len", [0, 1, 2, 3, 5])
def test_force_tokens_equals_jax(cur_len):
    logits = np.random.default_rng(cur_len).standard_normal(
        (3, 17)).astype(np.float32)
    positions, ids = (1, 2, 3), (7, 4, 11)
    ref = np.asarray(jlp.force_tokens(jnp.asarray(logits), cur_len,
                                      positions, ids))
    got = tlp.force_tokens(torch.from_numpy(logits), cur_len, positions, ids)
    np.testing.assert_array_equal(got.numpy(), ref)
    t = torch.from_numpy(logits)
    assert tlp.force_tokens(t, cur_len, (), ()) is t


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 0.99, 1.0])
def test_get_part_of_dataset_equals_jax(ratio):
    rows = [{"i": i} for i in range(13)]
    assert tcol.get_part_of_dataset(rows, ratio) == \
        jcol.get_part_of_dataset(rows, ratio)


def test_generate_random_string_equals_jax():
    random.seed(11)
    ref = [jtext.generate_random_string(), jtext.generate_random_string(5)]
    random.seed(11)
    got = [ttext.generate_random_string(), ttext.generate_random_string(5)]
    assert got == ref and len(got[0]) == 24 and got[0].isalnum()


def test_make_sampler_draws_the_jax_batch_with_replacement():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((5, 3, 8)).astype(np.float32)
    labels = rng.integers(0, 9, (5, 4)).astype(np.int32)
    dec = rng.integers(0, 9, (5, 4)).astype(np.int32)
    jbatch = jdc.DeviceCache(jnp.asarray(feats), jnp.asarray(labels),
                             jnp.asarray(dec)).make_sampler(16)(
        jax.random.key(0))
    cache = tdc.DeviceCache(torch.from_numpy(feats),
                            torch.from_numpy(labels).long(),
                            torch.from_numpy(dec).long())
    sample = cache.make_sampler(16)
    batch = sample(torch.Generator().manual_seed(0))
    assert set(batch) == set(jbatch)
    for k, v in batch.items():
        assert tuple(v.shape) == tuple(jbatch[k].shape), k
    # every row is one of the cache's, the three fields of one row together
    rows = [int(np.flatnonzero((feats == f).all(axis=(1, 2)))[0])
            for f in batch["input_features"].numpy()]
    np.testing.assert_array_equal(batch["labels"].numpy(), labels[rows])
    np.testing.assert_array_equal(batch["decoder_input_ids"].numpy(),
                                  dec[rows])
    assert len(set(rows)) < len(rows)  # 16 draws of 5 rows repeat
    again = sample(torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], v) for k, v in batch.items())


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """A random local BERT (tests/test_torch_metrics.py's) and a
    bert_score-format baseline TSV."""
    transformers = pytest.importorskip("transformers")
    tmp = tmp_path_factory.mktemp("bert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat",
             "sat", "on", "mat", "dog", "ran", "fast"]
    (tmp / "vocab.txt").write_text("\n".join(vocab))
    tok = transformers.BertTokenizer(str(tmp / "vocab.txt"))
    torch.manual_seed(0)
    enc = tmp / "model"
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64)).save_pretrained(enc)
    tok.save_pretrained(enc)
    tsv = tmp / "baseline.tsv"
    tsv.write_text("LAYER,P,R,F\n0,0.31,0.32,0.33\n1,0.41,0.42,0.43\n"
                   "2,0.51,0.52,0.53\n")
    return str(enc), str(tsv)


PREDS = ["the cat sat on mat", "dog ran fast", "the dog"]
REFS = ["the cat sat", "the dog ran fast", "cat on mat"]


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_read_baseline_tsv_equals_jax(bert, layer):
    _, tsv = bert
    assert tbs.read_baseline_tsv(tsv, layer) == \
        jbs.read_baseline_tsv(tsv, layer)


@pytest.mark.parametrize("kw", [
    {}, {"rescale_baseline": (0.2, 0.3, 0.25)}, {"baseline": True},
    {"baseline": True, "num_layers": 1}],
    ids=["plain", "explicit", "tsv_last_layer", "tsv_layer1"])
def test_bert_score_rescaling_equals_jax(bert, kw):
    model, tsv = bert
    kw = dict(kw)
    if kw.pop("baseline", False):
        kw["baseline_path"] = tsv
    got = tbs.bert_score(PREDS, REFS, model, **kw)
    assert got == jbs.bert_score(PREDS, REFS, model, **kw)
    if kw:
        assert got != tbs.bert_score(PREDS, REFS, model)
    with pytest.raises(ValueError, match="one baseline"):
        tbs.bert_score(PREDS, REFS, model, rescale_baseline=(0, 0, 0),
                       baseline_path=tsv)


@pytest.mark.parametrize("baseline", [False, True])
def test_plot_example_equals_jax(bert, tmp_path, baseline):
    import matplotlib.image as mpimg

    model, tsv = bert
    kw = {"baseline_path": tsv} if baseline else {}
    ref = jbs.plot_example(PREDS[0], REFS[0], model,
                           str(tmp_path / "jax.png"), **kw)
    got = tbs.plot_example(PREDS[0], REFS[0], model,
                           str(tmp_path / "port.png"), **kw)
    assert got == str(tmp_path / "port.png")
    np.testing.assert_array_equal(mpimg.imread(got), mpimg.imread(ref))
