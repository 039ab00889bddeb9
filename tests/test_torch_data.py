"""The port's data pipeline (neuspeech1_tpu_torch/data/) against the JAX
package's: the synthetic corpora are the same files, manifests filter and
split alike, `EEGDataset` items and `Collator` batches are bit-equal, the
`DataLoader` gives the same batches in the same order with threads, the
port's native clip loader is byte-exact against the Python path, and
train-time augmentation (not ported yet) raises."""

import json
import os

import numpy as np
import pytest

from neuspeech1_tpu import config as jc
from neuspeech1_tpu.data import collate as jcol
from neuspeech1_tpu.data import dataset as jds
from neuspeech1_tpu.data import loader as jld
from neuspeech1_tpu.data import manifest as jmf
from neuspeech1_tpu.data import synthetic as jsyn
from neuspeech1_tpu.utils.tokenizer import make_tokenizer as jtok
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.data import collate as tcol
from neuspeech1_tpu_torch.data import dataset as tds
from neuspeech1_tpu_torch.data import loader as tld
from neuspeech1_tpu_torch.data import manifest as tmf
from neuspeech1_tpu_torch.data import native_loader as tnl
from neuspeech1_tpu_torch.data import synthetic as tsyn
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer as ttok

CORPORA = {
    "defaults": dict(),
    "wide_long": dict(n_clips=7, n_channels=6, seed=3, max_dur=2.2),
    "no_audio_dutch": dict(n_clips=9, n_channels=5, seed=1,
                           language="Dutch", with_audio=False),
    "one_clip": dict(n_clips=1, n_channels=4, seed=4, min_dur=0.5,
                     max_dur=0.6),
}


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            data = open(path, "rb").read()
            # manifests hold absolute paths: compare them relative to root
            out[os.path.relpath(path, root)] = data.replace(
                root.encode(), b"ROOT")
    return out


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_synthetic_corpus_same_files(tmp_path, case):
    kw = CORPORA[case]
    rows_j = jsyn.make_synthetic_corpus(str(tmp_path / "j"), **kw)
    rows_t = tsyn.make_synthetic_corpus(str(tmp_path / "t"), **kw)
    assert len(rows_j) == len(rows_t) == kw.get("n_clips", 16)
    tj, tt = _tree(str(tmp_path / "j")), _tree(str(tmp_path / "t"))
    assert sorted(tj) == sorted(tt)
    for name in tj:
        assert tj[name] == tt[name], name


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus with 6 channels, one clip longer than the 2 s window, rows
    of two subjects and sentence types, and a language on some rows."""
    root = str(tmp_path_factory.mktemp("data"))
    rows = jsyn.make_synthetic_corpus(root, n_clips=10, n_channels=6, seed=7,
                                      min_dur=0.6, max_dur=2.6,
                                      with_audio=False)
    for i, r in enumerate(rows):
        r["sent_type"] = "ZINNEN" if i % 2 else "WOORDEN"
        if i % 3 == 0:
            r["language"] = "Chinese"
    rows[4]["sentences"] = []  # a clip without transcript
    jmf.write_jsonlines(os.path.join(root, "mixed.jsonl"), rows)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(jsyn._WORDS) + "\n")
    return root, vocab


def test_manifest_functions(corpus, tmp_path):
    root, _ = corpus
    path = os.path.join(root, "mixed.jsonl")
    rows_j, rows_t = jmf.read_jsonlines(path), tmf.read_jsonlines(path)
    assert rows_j == rows_t
    assert tmf.filter_schoffelen_sentences(rows_t) == \
        jmf.filter_schoffelen_sentences(rows_j)
    assert tmf.filter_subject(rows_t, 1) == jmf.filter_subject(rows_j, 1)
    assert tmf.filter_duration(rows_t, 1.0, 2.0) == \
        jmf.filter_duration(rows_j, 1.0, 2.0)
    assert tmf.add_language([dict(r) for r in rows_t], "Chinese") == \
        jmf.add_language([dict(r) for r in rows_j], "Chinese")
    for seed in (0, 3):
        assert tmf.split_train_val_test(rows_t, seed=seed) == \
            jmf.split_train_val_test(rows_j, seed=seed)
    srcs = [path, os.path.join(root, "train.jsonl")]
    n_j = jmf.combine_manifests(srcs, str(tmp_path / "j.jsonl"), seed=5)
    n_t = tmf.combine_manifests(srcs, str(tmp_path / "t.jsonl"), seed=5)
    assert n_j == n_t
    assert (tmp_path / "j.jsonl").read_bytes() == \
        (tmp_path / "t.jsonl").read_bytes()
    tmf.write_jsonlines(str(tmp_path / "w.jsonl"), rows_t)
    jmf.write_jsonlines(str(tmp_path / "wj.jsonl"), rows_j)
    assert (tmp_path / "w.jsonl").read_bytes() == \
        (tmp_path / "wj.jsonl").read_bytes()


def _tokenizers(vocab, spec):
    if spec == "byte":
        return (jtok("byte", jc.tiny_config()), ttok("byte", tc.tiny_config()))
    return jtok(f"word:{vocab}"), ttok(f"word:{vocab}")


DATASET_CASES = {
    "test_defaults": dict(mode="test", modal_ch=6),
    "pad_channels": dict(mode="test", modal_ch=9),
    "slice_tuple": dict(mode="test", modal_ch=3, channel_slice=(2, 5)),
    "slice_preset": dict(mode="test", modal_ch=208,
                         channel_slice="gwilliams"),
    "filter_subj_window": dict(mode="test", modal_ch=6, filter_dataset=True,
                               subj=1, max_duration=2.0, min_duration=0.5),
    "language_task": dict(mode="test", modal_ch=6, language="Chinese",
                          task="translate"),
    "timestamps": dict(mode="test", modal_ch=6, timestamps=True),
    "train_combine": dict(mode="train", modal_ch=6, combine_sentences=True,
                          seed=2, max_duration=6.0),
    "train_split": dict(mode="train", modal_ch=6, split_sentences=True,
                        seed=4),
}


@pytest.mark.parametrize("spec", ["byte", "word"])
@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_eeg_dataset_items_equal(corpus, case, spec):
    root, vocab = corpus
    tj, tt = _tokenizers(vocab, spec)
    kw = DATASET_CASES[case]
    path = os.path.join(root, "mixed.jsonl")
    dj = jds.EEGDataset(path, tj, **kw)
    dt = tds.EEGDataset(path, tt, **kw)
    assert len(dj) == len(dt) > 0
    assert dj.n_samples == dt.n_samples
    assert dj.supports_native_signals() == dt.supports_native_signals()
    for i in range(len(dj)):
        a, b = dj[i], dt[i]
        assert a["input_features"].dtype == b["input_features"].dtype
        assert np.array_equal(a["input_features"], b["input_features"])
        assert list(a["labels"]) == list(b["labels"])
        assert dj.text(i) == dt.text(i)
        assert dj.signal_path(i) == dt.signal_path(i)
        if kw["mode"] == "test":
            assert list(dj.get_labels(i)) == list(dt.get_labels(i))


def test_train_augmentation_raises(corpus):
    root, vocab = corpus
    _, tt = _tokenizers(vocab, "byte")
    cfg = {"shift": {"prob": 1.0}}
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        tds.EEGDataset(os.path.join(root, "mixed.jsonl"), tt, mode="train",
                       modal_ch=6, augment_config=cfg)
    # outside train mode the JAX package ignores the config too
    tds.EEGDataset(os.path.join(root, "mixed.jsonl"), tt, mode="test",
                   modal_ch=6, augment_config=cfg)


COLLATOR_CASES = {
    "bucket": dict(),
    "fixed_len": dict(max_label_len=12),
    "truncate": dict(max_label_len=6),
    "multiple_16": dict(pad_to_multiple=16),
    "keep_sot": dict(strip_sot=False, max_label_len=40),
    "no_eot_id": dict(max_label_len=5, eot_id=None),
}


@pytest.mark.parametrize("case", sorted(COLLATOR_CASES))
def test_collator_batches_equal(corpus, case):
    root, vocab = corpus
    tj, tt = _tokenizers(vocab, "byte")
    ds = jds.EEGDataset(os.path.join(root, "mixed.jsonl"), tj, mode="test",
                        modal_ch=6)
    samples = [ds[i] for i in range(len(ds))]
    kw = dict(pad_id=tj.pad_id, decoder_start_id=tj.config.sot_id,
              eot_id=tj.config.eot_id)
    kw.update(COLLATOR_CASES[case])
    cj, ct = jcol.Collator(**kw), tcol.Collator(**kw)
    bj, bt = cj(samples), ct(samples)
    assert sorted(bj) == sorted(bt)
    for k in bj:
        assert bj[k].dtype == bt[k].dtype, k
        assert np.array_equal(bj[k].view(np.uint8), bt[k].view(np.uint8)), k
    assert cj.n_truncated == ct.n_truncated


LOADER_CASES = {
    "eval_order": dict(shuffle=False, drop_last=False, num_threads=3,
                       prefetch=2),
    "shuffled": dict(shuffle=True, seed=4, drop_last=True, num_threads=2,
                     prefetch=1),
    "no_prefetch": dict(shuffle=True, seed=1, drop_last=False, prefetch=0),
    "deep_prefetch": dict(shuffle=True, seed=2, drop_last=False,
                          num_threads=2, prefetch=4),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_and_order(corpus, case):
    root, vocab = corpus
    tj, tt = _tokenizers(vocab, "byte")
    path = os.path.join(root, "mixed.jsonl")
    kw = LOADER_CASES[case]
    mk = dict(mode="test", modal_ch=6)
    lj = jld.DataLoader(jds.EEGDataset(path, tj, **mk),
                        jcol.Collator(tj.pad_id, tj.config.sot_id), 4, **kw)
    lt = tld.DataLoader(tds.EEGDataset(path, tt, **mk),
                        tcol.Collator(tt.pad_id, tt.config.sot_id), 4, **kw)
    assert len(lj) == len(lt)
    # two epochs through `epochs`: the shuffle is reseeded per epoch
    ej = list(jld.epochs(lj, 2))
    et = list(tld.epochs(lt, 2))
    assert len(ej) == len(et) > 0
    for bj, bt in zip(ej, et):
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert np.array_equal(bj[k], bt[k]), k


def test_native_loader_byte_exact(corpus, tmp_path):
    """The port's C++ clip loader (built into its own build directory)
    against the Python path: f4 and f8 clips, channel pad and slice, time
    clip and pad; the loader's batches through `native_signals`."""
    if not tnl.native_available():
        pytest.skip("no C++ toolchain (g++) to build the native loader")
    assert tnl.library_path().parent.name == "_build"
    assert tnl.library_path().exists()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 50)).astype(np.float32)
    b = rng.standard_normal((7, 80)).astype(np.float64)
    pa, pb = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    np.save(pa, a)
    np.save(pb, b)
    loader = tnl.NativeClipLoader(num_threads=2)
    try:
        out = loader.load_batch([pa, pb], modal_ch=6, n_samples=60)
        ref = np.zeros((2, 6, 60), np.float32)
        ref[0, :4, :50] = a
        ref[1, :, :60] = b[:6, :60].astype(np.float32)
        assert out.tobytes() == ref.tobytes()
        out = loader.load_batch([pb], modal_ch=3, n_samples=90,
                                channel_slice=(2, 5))
        ref = np.zeros((1, 3, 90), np.float32)
        ref[0, :, :80] = b[2:5].astype(np.float32)
        assert out.tobytes() == ref.tobytes()
        with pytest.raises(IOError, match="missing"):
            loader.load_batch([str(tmp_path / "missing.npy")], 4, 10)
    finally:
        loader.close()

    root, vocab = corpus
    _, tt = _tokenizers(vocab, "word")
    for kw in (dict(modal_ch=6), dict(modal_ch=8),
               dict(modal_ch=3, channel_slice=(1, 4), max_duration=1.0)):
        ds = tds.EEGDataset(os.path.join(root, "mixed.jsonl"), tt,
                            mode="test", **kw)
        col = tcol.Collator(tt.pad_id, tt.config.sot_id)
        py = list(tld.DataLoader(ds, col, 4, shuffle=False, drop_last=False))
        nat = list(tld.DataLoader(ds, col, 4, shuffle=False, drop_last=False,
                                  native_signals=True))
        assert len(py) == len(nat)
        for x, y in zip(py, nat):
            for k in x:
                assert x[k].tobytes() == y[k].tobytes(), k


def test_native_refused_for_train_transforms(corpus):
    root, vocab = corpus
    _, tt = _tokenizers(vocab, "byte")
    ds = tds.EEGDataset(os.path.join(root, "mixed.jsonl"), tt, mode="train",
                        modal_ch=6, combine_sentences=True)
    with pytest.raises(ValueError, match="native"):
        tld.DataLoader(ds, tcol.Collator(tt.pad_id, tt.config.sot_id), 4,
                       native_signals=True)


def test_manifest_rows_json_roundtrip(corpus):
    root, _ = corpus
    line = open(os.path.join(root, "mixed.jsonl"), encoding="utf-8").readline()
    assert tmf.read_jsonlines(os.path.join(root, "mixed.jsonl"))[0] == \
        json.loads(line)
