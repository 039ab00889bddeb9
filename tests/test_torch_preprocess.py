"""The port's offline data preparation (neuspeech1_tpu_torch/ops/signal.py's
filters, data/preprocess.py, cli/prepare_data.py, cli/manifest_tools.py and
data/synthetic.py's corpora) against the JAX package's on the same inputs:
arrays bit for bit, the written files byte for byte (manifest rows equal
once each run's own output directory is named alike)."""

import os
import sys

import numpy as np
import pytest

from neuspeech1_tpu.cli import manifest_tools as jtools
from neuspeech1_tpu.cli import prepare_data as jprep
from neuspeech1_tpu.data import preprocess as jpp
from neuspeech1_tpu.data import synthetic as jsyn
from neuspeech1_tpu.ops import signal as jsig
from neuspeech1_tpu_torch.cli import manifest_tools as ttools
from neuspeech1_tpu_torch.cli import prepare_data as tprep
from neuspeech1_tpu_torch.data import preprocess as tpp
from neuspeech1_tpu_torch.data import synthetic as tsyn
from neuspeech1_tpu_torch.ops import signal as tsig


# --------------------------------------------------------------------------
# fixtures: copies of tests/test_preprocess.py's BIDS-style writers
# --------------------------------------------------------------------------

def _write_gwilliams_events(path, n_sent=3, words_per=4):
    rows = ["onset\tduration\ttrial_type"]
    t = 1.0
    for s in range(n_sent):
        for w in range(words_per):
            tt = {
                "kind": "word", "word": f"w{s}{w}", "sequence_id": s,
                "story": "story_a", "story_uid": 1, "sound_id": 7,
                "speech_rate": 1.0, "voice": "x", "sound": "AUDIO/a.wav",
                "start": t,
            }
            rows.append(f"{t}\t0.3\t{tt!r}")
            t += 0.4
        t += 1.0
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _write_schoffelen_events(path):
    rows = [
        "sample\ttype\tvalue",
        "0\tTrigger\tZINNEN",
        "1200\tSound\tEQ_Ramp_Int2_Int1LPF012.wav",
        "3600\tNothing\tEnd of file x",
        "4000\tTrigger\tWOORDEN",
        "4800\tSound\tEQ_Ramp_Int2_Int1LPF034.wav",
        "7200\tNothing\tEnd of file y",
    ]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _write_visual_events(path):
    rows = [
        "sample\ttype\tvalue",
        "0\tTrigger\tZINNEN",
        "100\tPicture\t12",
        "150\tWord\tde",
        "200\tBlank\tx",
        "300\tPicture\t34",
        "350\tWord\twoord",
        "420\tBlank\ty",
        "500\tTrigger\tWOORDEN",
    ]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


STIMULI = {"12": "de kat zat op de mat", "34": "woord lijst hier"}


def _tone(seconds, sr, freq):
    t = np.arange(int(seconds * sr)) / sr
    return 0.3 * np.sin(2 * np.pi * freq * t)


def _files(root):
    """Every file under ``root`` by its relative path: bytes, with text
    files' occurrences of ``root`` named alike."""
    out = {}
    for r, _, names in os.walk(root):
        for name in names:
            path = os.path.join(r, name)
            data = open(path, "rb").read()
            if name.endswith((".jsonl", ".txt", ".json")):
                data = data.replace(os.path.abspath(root).encode(), b"<root>")
            out[os.path.relpath(path, root)] = data
    return out


def _same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    return fa


# --------------------------------------------------------------------------
# ops/signal.py
# --------------------------------------------------------------------------

def _signal(seed=0, ch=6, n=1200):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 400.0
    return (np.sin(2 * np.pi * 7 * t)[None] * rng.uniform(0.5, 2, (ch, 1))
            + np.sin(2 * np.pi * 50 * t)[None]
            + 0.3 * rng.standard_normal((ch, n)))


SIGNAL_CASES = {
    "robust_scale": lambda m, x: m.robust_scale(x),
    "robust_scale_axis0": lambda m, x: m.robust_scale(x, axis=0),
    "robust_scale_zero_iqr": lambda m, x: m.robust_scale(
        np.concatenate([x, np.zeros((1, x.shape[1]))])),
    "preprocess_eeg_data": lambda m, x: m.preprocess_eeg_data(x * 20),
    "preprocess_eeg_data_threshold": lambda m, x: m.preprocess_eeg_data(
        x, threshold=1.5, baseline_samples=100),
    "lowpass_filter": lambda m, x: m.lowpass_filter(x, 30.0, 400.0),
    "lowpass_filter_axis0": lambda m, x: m.lowpass_filter(x.T, 30.0, 400.0,
                                                          axis=0),
    "bandpass_filter": lambda m, x: m.bandpass_filter(x, 1.0, 58.0, 400.0),
    "bandpass_filter_order2": lambda m, x: m.bandpass_filter(
        x, 2.0, 40.0, 400.0, order=2),
    "notch_filter": lambda m, x: m.notch_filter(x, 50.0, 400.0),
    "notch_filter_q": lambda m, x: m.notch_filter(x, 60.0, 400.0, q=10.0),
    "resample_down": lambda m, x: m.resample(x, 400, 200),
    "resample_ratio": lambda m, x: m.resample(x, 1200, 200),
    "resample_up": lambda m, x: m.resample(x, 200, 300),
    "resample_same": lambda m, x: m.resample(x, 200, 200),
}


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_signal_ops_equal_jax_package(case):
    x = _signal()
    got = SIGNAL_CASES[case](tsig, x)
    ref = SIGNAL_CASES[case](jsig, x)
    if isinstance(ref, tuple):  # preprocess_eeg_data: (data, ratio)
        assert got[1] == ref[1]
        got, ref = got[0], ref[0]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fn,args", [
    ("lowpass_filter", (30.0, 400.0)),
    ("bandpass_filter", (1.0, 58.0, 400.0)),
    ("notch_filter", (50.0, 400.0)),
    ("resample", (400, 200)),
])
def test_filters_raise_without_scipy(monkeypatch, fn, args):
    monkeypatch.setattr(tsig, "_scipy_signal", None)
    with pytest.raises(RuntimeError, match="scipy is required"):
        getattr(tsig, fn)(_signal(), *args)


# --------------------------------------------------------------------------
# data/preprocess.py
# --------------------------------------------------------------------------

def test_detect_outliers_equal_jax_package():
    ok = np.random.default_rng(0).standard_normal((4, 100))
    nan, inf, zeros = ok.copy(), ok.copy(), ok.copy()
    nan[0, 0] = np.nan
    inf[1, 2] = np.inf
    zeros[:, :30] = 0.0
    for arr in (ok, nan, inf, zeros, np.zeros((4, 100)), np.empty((4, 0))):
        assert tpp.detect_outliers(arr) == jpp.detect_outliers(arr)
    assert tpp.detect_outliers(ok) is None
    assert "NaN" in tpp.detect_outliers(nan)


@pytest.mark.parametrize("threshold,fit_samples", [(10.0, 100), (2.0, 50)])
def test_preprocess_clip_equal_jax_package(threshold, fit_samples):
    x = np.random.default_rng(1).standard_normal((6, 500)) * 3
    got = tpp.preprocess_clip(x, threshold=threshold, fit_samples=fit_samples)
    ref = jpp.preprocess_clip(x, threshold=threshold, fit_samples=fit_samples)
    assert got[1] == ref[1]
    assert got[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], ref[0])


def test_preprocess_clip_ratio_guard():
    x = np.ones((2, 200))
    x[:, 100:] = 1e6  # wild tail against a calm head: a huge clip ratio
    with pytest.raises(AssertionError, match="clip ratio"):
        tpp.preprocess_clip(x, threshold=10)


def test_load_raw_npy_equal_jax_package(tmp_path):
    path = str(tmp_path / "raw.npy")
    np.save(path, _signal(2, ch=3, n=4000))
    for notch in (50.0, None):
        got = tpp.load_raw_npy(path, 400, 1.0, 30.0, notch, 200)
        ref = jpp.load_raw_npy(path, 400, 1.0, 30.0, notch, 200)
        assert got.shape == (3, 2000)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("loader", ["load_raw_kit", "load_raw_ctf"])
def test_raw_readers_raise_without_mne(monkeypatch, loader):
    monkeypatch.setitem(sys.modules, "mne", None)  # import mne fails
    with pytest.raises(RuntimeError, match="MNE is required"):
        getattr(tpp, loader)("recording")


def test_load_audio_equal_jax_package(tmp_path):
    path = str(tmp_path / "a.wav")
    tsyn.write_wav(path, _tone(0.5, 22050, 440.0), 22050)
    got, ref = tpp.load_audio(path), jpp.load_audio(path)
    assert got[1] == ref[1] == 22050
    np.testing.assert_array_equal(got[0], ref[0])


def test_event_tables_parse_alike(tmp_path):
    gw = str(tmp_path / "sub-01_task-0_events.tsv")
    _write_gwilliams_events(gw)
    assert tpp.get_sequences(gw) == jpp.get_sequences(gw)
    sch = str(tmp_path / "sub-A2021_task-auditory_events.tsv")
    _write_schoffelen_events(sch)
    got = tpp.read_tsv_auditory(sch, STIMULI, "/audio")
    assert got == jpp.read_tsv_auditory(sch, STIMULI, "/audio")
    assert [s["type"] for s in got] == ["ZINNEN", "WOORDEN"]
    vis = str(tmp_path / "sub-A2021_task-visual_events.tsv")
    _write_visual_events(vis)
    got = tpp.read_tsv_visual(vis, STIMULI)
    assert got == jpp.read_tsv_visual(vis, STIMULI)
    assert [s["text"] for s in got] == [STIMULI["12"], STIMULI["34"]]
    stim = str(tmp_path / "stimuli.txt")
    with open(stim, "w", encoding="utf-8") as f:
        f.write("".join(f"{k} {v}\n" for k, v in STIMULI.items()) + "\n")
    assert tpp.read_stimuli_dict(stim) == jpp.read_stimuli_dict(stim) \
        == STIMULI


@pytest.mark.parametrize("with_audio", [True, False])
def test_process_gwilliams_events_writes_the_same_files(tmp_path,
                                                        with_audio):
    """The same clips (.npy) and wavs (the story's audio, cut per sentence
    and resampled from 22.05 to 16 kHz) and the same info.jsonl rows."""
    tsv = str(tmp_path / "sub-07_task-0_events.tsv")
    _write_gwilliams_events(tsv, n_sent=3, words_per=3)
    audio_root = str(tmp_path / "bids")
    if with_audio:
        os.makedirs(os.path.join(audio_root, "audio"))
        tsyn.write_wav(os.path.join(audio_root, "audio", "a.wav"),
                       _tone(20.0, 22050, 330.0), 22050)
    raw = np.random.default_rng(3).standard_normal((8, 200 * 16))
    out = {}
    for name, pp in (("jax", jpp), ("port", tpp)):
        out[name] = str(tmp_path / name)
        lines = pp.process_gwilliams_events(tsv, out[name], lambda: raw,
                                            audio_root=audio_root)
        assert len(lines) == 3
    files = _same_files(out["jax"], out["port"])
    assert sum(n.endswith(".wav") for n in files) == (3 if with_audio else 0)


def test_process_schoffelen_events_writes_the_same_files(tmp_path):
    tsv = str(tmp_path / "sub-A2021_task-auditory_events.tsv")
    _write_schoffelen_events(tsv)
    audio_dir = str(tmp_path / "stim_audio")
    os.makedirs(audio_dir)
    tsyn.write_wav(os.path.join(audio_dir, "EQ_Ramp_Int2_Int1LPF012.wav"),
                   _tone(2.0, 44100, 250.0), 44100)
    raw = np.random.default_rng(4).standard_normal((5, 200 * 10))
    out = {}
    for name, pp in (("jax", jpp), ("port", tpp)):
        out[name] = str(tmp_path / name)
        lines = pp.process_schoffelen_events(
            tsv, out[name], lambda: (raw, 1200.0), STIMULI, audio_dir)
        assert [r["sent_type"] for r in lines] == ["ZINNEN", "WOORDEN"]
        assert "speech" in lines[0] and "speech" not in lines[1]
    _same_files(out["jax"], out["port"])


# --------------------------------------------------------------------------
# cli/prepare_data.py
# --------------------------------------------------------------------------

def _bids_tree(root, dataset):
    """Three recordings' events tables (and the stimuli for Schoffelen) in
    a BIDS-like tree; the recordings themselves are never read (the raw
    readers are monkeypatched)."""
    if dataset == "gwilliams":
        for sub in ("01", "02", "03"):
            d = os.path.join(root, f"sub-{sub}", "ses-0", "meg")
            os.makedirs(d)
            _write_gwilliams_events(
                os.path.join(d, f"sub-{sub}_ses-0_task-0_events.tsv"),
                n_sent=3, words_per=3)
        os.makedirs(os.path.join(root, "audio"))
        tsyn.write_wav(os.path.join(root, "audio", "a.wav"),
                       _tone(20.0, 16000, 300.0), 16000)
        return
    for sub in ("A2001", "A2002", "A2003"):
        d = os.path.join(root, f"sub-{sub}", "meg")
        os.makedirs(d)
        _write_schoffelen_events(
            os.path.join(d, f"sub-{sub}_task-auditory_events.tsv"))
    stim = os.path.join(root, "stimuli")
    os.makedirs(os.path.join(stim, "audio_files"))
    with open(os.path.join(stim, "stimuli.txt"), "w", encoding="utf-8") as f:
        f.write("".join(f"{k} {v}\n" for k, v in STIMULI.items()))
    tsyn.write_wav(os.path.join(stim, "audio_files",
                                "EQ_Ramp_Int2_Int1LPF034.wav"),
                   _tone(1.5, 16000, 200.0), 16000)


@pytest.mark.parametrize("dataset", ["gwilliams", "schoffelen"])
def test_prepare_data_writes_the_same_corpus(monkeypatch, tmp_path, capsys,
                                             dataset):
    """Both CLIs at num_workers 1 on one tree, each raw reader replaced by
    one seeded array in both packages: the same clips, wavs, info.jsonl
    and split1/; a recording that fails is reported and skipped."""
    root = str(tmp_path / "bids")
    _bids_tree(root, dataset)
    raw = np.random.default_rng(5).standard_normal((6, 200 * 16))

    def kit(path):
        if "sub-02" in path:
            raise OSError("unreadable recording")
        return raw

    for pp in (jpp, tpp):
        monkeypatch.setattr(pp, "load_raw_kit", kit)
        monkeypatch.setattr(pp, "load_raw_ctf", lambda path: (raw, 1200.0))
    out = {}
    for name, cli in (("jax", jprep), ("port", tprep)):
        out[name] = str(tmp_path / name)
        cli.main([dataset, f"--data_root={root}", f"--out_root={out[name]}",
                  "--num_workers=1", "--seed=3"])
    log = capsys.readouterr().out
    files = _same_files(out["jax"], out["port"])
    assert {"info.jsonl", "split1/train.jsonl", "split1/val.jsonl",
            "split1/test.jsonl"} <= set(files)
    n_rows = files["info.jsonl"].count(b"\n")
    if dataset == "gwilliams":
        assert log.count("FAILED") == 2 and n_rows == 6
    else:
        assert n_rows == 6
    assert sum(files[f"split1/{s}.jsonl"].count(b"\n")
               for s in ("train", "val", "test")) == n_rows


def test_prepare_data_workers_tolerate_failures(tmp_path, capfd):
    """Two spawned workers on a tree whose recordings cannot be read (the
    raw reader needs MNE): each recording is reported and skipped, and the
    CLI writes the empty corpus its one-process run writes."""
    root = str(tmp_path / "bids")
    _bids_tree(root, "gwilliams")
    out = {}
    for workers in (1, 2):
        out[workers] = str(tmp_path / f"out{workers}")
        tprep.main(["gwilliams", f"--data_root={root}",
                    f"--out_root={out[workers]}",
                    f"--num_workers={workers}"])
    assert capfd.readouterr().out.count("FAILED") == 6
    files = _same_files(out[1], out[2])
    assert files["info.jsonl"] == b""


# --------------------------------------------------------------------------
# cli/manifest_tools.py
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("manifests"))
    rows = tsyn.make_synthetic_corpus(os.path.join(root, "a"), n_clips=10,
                                      n_channels=2, seed=1, with_audio=False)
    tsyn.make_synthetic_corpus(os.path.join(root, "b"), n_clips=6,
                               n_channels=2, seed=2, with_audio=False)
    # a Schoffelen-like manifest: sentence types and durations to filter
    from neuspeech1_tpu_torch.data.manifest import write_jsonlines

    mixed = [dict(r, sent_type=t, duration=d) for r, t, d in zip(
        rows, ["ZINNEN", "WOORDEN"] * 5, [3.0, 31.0, 12.0, 2.0, 29.9] * 2)]
    write_jsonlines(os.path.join(root, "mixed.jsonl"), mixed)
    return root


TOOL_CASES = {
    "combine": lambda r, o: ["combine", f"{r}/a/all.jsonl", f"{r}/b/all.jsonl",
                             "-o", f"{o}/out.jsonl", "--seed=4"],
    "combine_no_shuffle": lambda r, o: [
        "combine", f"{r}/a/all.jsonl", f"{r}/b/all.jsonl", "-o",
        f"{o}/out.jsonl", "--no-shuffle"],
    "filter_zinnen": lambda r, o: ["filter-zinnen", f"{r}/mixed.jsonl", "-o",
                                   f"{o}/out.jsonl"],
    "add_language": lambda r, o: ["add-language", f"{r}/a/all.jsonl",
                                  "--language", "Dutch", "-o",
                                  f"{o}/out.jsonl"],
    "split": lambda r, o: ["split", f"{r}/a/all.jsonl", "-o", f"{o}/split"],
    "split_ratios": lambda r, o: ["split", f"{r}/mixed.jsonl", "-o",
                                  f"{o}/split", "--seed=7",
                                  "--ratios=0.6,0.2,0.2"],
}


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
def test_manifest_tools_write_the_same_files(manifests, tmp_path, case):
    out = {}
    for name, cli in (("jax", jtools), ("port", ttools)):
        out[name] = str(tmp_path / name)
        os.makedirs(out[name])
        cli.main(TOOL_CASES[case](manifests, out[name]))
    files = _same_files(out["jax"], out["port"])
    assert files and all(files.values())


# --------------------------------------------------------------------------
# data/synthetic.py's corpora
# --------------------------------------------------------------------------

CORPUS_CASES = {
    "separable": ("make_separable_corpus", dict(n_clips=12, n_channels=3,
                                                seed=2)),
    "separable_freq_order": ("make_separable_corpus", dict(
        n_clips=8, n_channels=2, vocab_size=4, freq_order=[2, 0, 3, 1])),
    "confusable": ("make_confusable_corpus", dict(n_clips=12, n_channels=3,
                                                  seed=3)),
    "noisy_zipf": ("make_noisy_zipf_corpus", dict(n_clips=14, n_channels=3)),
    "synthetic_with_audio": ("make_synthetic_corpus", dict(
        n_clips=5, n_channels=2, seed=4, max_dur=1.5)),
}


@pytest.mark.parametrize("case", sorted(CORPUS_CASES))
def test_corpora_write_the_same_files(tmp_path, case):
    fn, kw = CORPUS_CASES[case]
    out = {}
    for name, mod in (("jax", jsyn), ("port", tsyn)):
        out[name] = str(tmp_path / name)
        rows = getattr(mod, fn)(out[name], **kw)
        assert len(rows) == kw["n_clips"]
    files = _same_files(out["jax"], out["port"])
    assert {"train.jsonl", "val.jsonl", "test.jsonl", "all.jsonl"} <= \
        set(files)
