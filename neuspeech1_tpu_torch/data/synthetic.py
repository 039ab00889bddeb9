"""Synthetic dataset fixtures: the port's copy of
``neuspeech1_tpu/data/synthetic.py`` (numpy only; the same seed writes the
same files): the wav writer and reader, and the synthetic, separable,
confusable and noisy Zipf corpora.

Generates tiny "MEG"+text corpora with the exact jsonl/npy/wav contract of the
real preprocessing output, so every downstream stage (dataset, collator,
training, decoding, metrics, CLIs) is testable without the 200 GB corpora.
"""

from __future__ import annotations

import os
import wave
from typing import List

import numpy as np

from neuspeech1_tpu_torch.config import AUDIO_SAMPLE_RATE, SIGNAL_SAMPLE_RATE
from neuspeech1_tpu_torch.data.manifest import write_jsonlines

_WORDS = (
    "the quick brown fox jumps over a lazy dog while tiny birds sing softly "
    "in green trees near clear water under bright morning light"
).split()


def _sentence(rng: np.random.Generator, n_words: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n_words))


def write_wav(path: str, audio: np.ndarray, sr: int = AUDIO_SAMPLE_RATE) -> None:
    """Minimal 16-bit PCM wav writer (soundfile is not available here)."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path: str):
    """Minimal wav reader -> (float32 mono array in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def make_synthetic_corpus(
    root: str,
    n_clips: int = 16,
    n_channels: int = 8,
    language: str = "English",
    min_dur: float = 1.0,
    max_dur: float = 4.0,
    seed: int = 0,
    with_audio: bool = True,
) -> List[dict]:
    """Write `{root}/clips/*.npy[,.wav]` + `{root}/train.jsonl` etc.

    Returns the manifest rows. Signals carry a per-clip sinusoid keyed to the
    clip index so models can actually fit them (overfit tests rely on this).
    """
    rng = np.random.default_rng(seed)
    clip_dir = os.path.join(root, "clips")
    os.makedirs(clip_dir, exist_ok=True)
    rows = []
    for i in range(n_clips):
        dur = float(rng.uniform(min_dur, max_dur))
        n_sig = int(round(dur * SIGNAL_SAMPLE_RATE))
        t = np.arange(n_sig) / SIGNAL_SAMPLE_RATE
        freq = 2.0 + (i % 13)
        sig = 0.5 * np.sin(2 * np.pi * freq * t)[None, :] * np.linspace(
            0.5, 1.5, n_channels
        )[:, None]
        sig = (sig + 0.05 * rng.standard_normal((n_channels, n_sig))).astype(
            np.float32
        )
        npy_path = os.path.join(clip_dir, f"clip_{i}_meg.npy")
        np.save(npy_path, sig)

        n_words = 2 + (i % 5)
        text = _sentence(np.random.default_rng(seed + i), n_words)
        words = []
        starts = np.linspace(0.0, max(dur - 0.2, 0.1), n_words)
        for w, s in zip(text.split(), starts):
            words.append(
                {"word": w, "start": round(float(s), 2), "end": round(float(s) + 0.15, 2)}
            )
        row = {
            "eeg": {"path": npy_path, "sr": SIGNAL_SAMPLE_RATE},
            "duration": round(dur, 2),
            "language": language,
            "sentence": text,
            "sentences": [
                {
                    "text": text,
                    "start": 0.0,
                    "end": round(dur, 2),
                    "duration": round(dur, 2),
                    "words": words,
                }
            ],
            "subj": i % 3,
            "story": f"story_{i % 2}",
        }
        if with_audio:
            wav_path = os.path.join(clip_dir, f"clip_{i}_audio.wav")
            n_aud = int(round(dur * AUDIO_SAMPLE_RATE))
            ta = np.arange(n_aud) / AUDIO_SAMPLE_RATE
            write_wav(wav_path, (0.3 * np.sin(2 * np.pi * 220.0 * (1 + i % 5) * ta)))
            row["speech"] = {"path": wav_path, "sr": AUDIO_SAMPLE_RATE}
        rows.append(row)

    n_train = max(1, int(n_clips * 0.8))
    n_val = max(1, (n_clips - n_train) // 2)
    write_jsonlines(os.path.join(root, "train.jsonl"), rows[:n_train])
    write_jsonlines(os.path.join(root, "val.jsonl"), rows[n_train : n_train + n_val])
    write_jsonlines(os.path.join(root, "test.jsonl"), rows[n_train + n_val :] or rows[-1:])
    write_jsonlines(os.path.join(root, "all.jsonl"), rows)
    return rows


def make_separable_corpus(
    root: str,
    n_clips: int = 300,
    n_channels: int = 8,
    vocab_size: int = 6,
    min_words: int = 2,
    max_words: int = 4,
    seg_dur: float = 0.4,
    language: str = "English",
    seed: int = 0,
    freq_order=None,
) -> List[dict]:
    """Corpus with a GENERALIZABLE signal→text mapping: each word of a small
    vocabulary is a distinct sinusoid frequency emitted over that word's
    time span. A model trained on the train split can therefore decode
    held-out clips built from the same vocabulary — this is the accuracy
    stand-in (held-out decode WER) for the reference's real-data runs
    (BASELINE.md procedure item 1; real corpora are not available offline).

    ``freq_order``: optional permutation of [0, vocab_size) assigning word
    i the frequency slot freq_order[i] — a DIFFERENT signal→word mapping
    over the same vocabulary/frequency set, i.e. a domain shift in signal
    space with the text distribution unchanged (the cross-dataset transfer
    scenario: encoder adapters + stem must re-map, the decoder's language
    modelling stays valid).

    Same jsonl/npy contract as `make_synthetic_corpus`; splits 8:1:1.
    """
    rng = np.random.default_rng(seed)
    vocab = list(_WORDS[:vocab_size])
    freqs = 3.0 + 4.0 * np.arange(vocab_size)  # 3,7,11,... Hz — well below Nyquist
    if freq_order is not None:
        assert sorted(freq_order) == list(range(vocab_size)), freq_order
        freqs = freqs[np.asarray(freq_order)]
    clip_dir = os.path.join(root, "clips")
    os.makedirs(clip_dir, exist_ok=True)
    seg_n = int(round(seg_dur * SIGNAL_SAMPLE_RATE))
    gains = np.linspace(0.5, 1.5, n_channels)[:, None]
    rows = []
    for i in range(n_clips):
        n_words = int(rng.integers(min_words, max_words + 1))
        word_ids = rng.integers(0, vocab_size, n_words)
        segs = []
        words = []
        for j, wid in enumerate(word_ids):
            t = np.arange(seg_n) / SIGNAL_SAMPLE_RATE
            seg = 0.5 * np.sin(2 * np.pi * freqs[wid] * t)[None, :] * gains
            segs.append(seg)
            words.append({
                "word": vocab[wid],
                "start": round(j * seg_dur, 2),
                "end": round((j + 1) * seg_dur, 2),
            })
        sig = np.concatenate(segs, axis=1)
        sig = (sig + 0.05 * rng.standard_normal(sig.shape)).astype(np.float32)
        dur = n_words * seg_dur
        npy_path = os.path.join(clip_dir, f"sep_{i}_meg.npy")
        np.save(npy_path, sig)
        text = " ".join(vocab[w] for w in word_ids)
        rows.append({
            "eeg": {"path": npy_path, "sr": SIGNAL_SAMPLE_RATE},
            "duration": round(dur, 2),
            "language": language,
            "sentence": text,
            "sentences": [{"text": text, "start": 0.0, "end": round(dur, 2),
                           "duration": round(dur, 2), "words": words}],
            "subj": i % 3,
            "story": f"story_{i % 2}",
        })

    n_train = max(1, int(n_clips * 0.8))
    n_val = max(1, (n_clips - n_train) // 2)
    write_jsonlines(os.path.join(root, "train.jsonl"), rows[:n_train])
    write_jsonlines(os.path.join(root, "val.jsonl"),
                    rows[n_train: n_train + n_val])
    write_jsonlines(os.path.join(root, "test.jsonl"),
                    rows[n_train + n_val:] or rows[-1:])
    write_jsonlines(os.path.join(root, "all.jsonl"), rows)
    return rows


def make_confusable_corpus(
    root: str,
    n_clips: int = 300,
    n_channels: int = 8,
    n_groups: int = 4,
    confuser_lo: float = 0.5,
    confuser_hi: float = 1.1,
    noise: float = 0.25,
    seg_dur: float = 0.4,
    language: str = "English",
    seed: int = 0,
) -> List[dict]:
    """Corpus engineered so JOINT decoding (the reference's beam-5 eval
    config, `evaluation.py:369-386`) beats greedy:

    * vocabulary = ``n_groups`` pairs of words; the two members of a pair
      sit 2 Hz apart (acoustically confusable under noise), groups are far
      apart;
    * a sentence takes one word from each group IN ORDER, and every word
      uses the SAME pair member ("parity") — the parity is a global,
      linguistically-learnable constraint;
    * each word's signal mixes its own frequency (gain 1) with its pair
      partner's at gain ~U(confuser_lo, confuser_hi): single words are
      sometimes locally misleading (gain > 1), but the evidence summed over
      the sentence identifies the true parity.

    A greedy decoder commits to word 1's locally-loudest member and the
    learned parity constraint then propagates the error across the whole
    sentence; beam search carries both parity hypotheses and scores total
    evidence. Words never repeat inside a sentence, so repetition-penalty
    5.0 / ngram-2 (word-level tokens — see `WordTokenizer`) are not harmed.

    Writes the usual jsonl/npy contract plus ``vocab.txt`` (one word per
    line) for ``make_tokenizer("word:<root>/vocab.txt")``. Splits 8:1:1.
    """
    rng = np.random.default_rng(seed)
    vocab = list(_WORDS[: 2 * n_groups])
    base = 5.0 + 8.0 * np.arange(n_groups)
    freqs = np.stack([base - 1.0, base + 1.0], axis=1)  # [group, member]
    clip_dir = os.path.join(root, "clips")
    os.makedirs(clip_dir, exist_ok=True)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    seg_n = int(round(seg_dur * SIGNAL_SAMPLE_RATE))
    gains = np.linspace(0.5, 1.5, n_channels)[:, None]
    t = np.arange(seg_n) / SIGNAL_SAMPLE_RATE
    rows = []
    for i in range(n_clips):
        parity = int(rng.integers(0, 2))
        segs, words, text_words = [], [], []
        for g in range(n_groups):
            own = freqs[g, parity]
            other = freqs[g, 1 - parity]
            conf = rng.uniform(confuser_lo, confuser_hi)
            phase1, phase2 = rng.uniform(0, 2 * np.pi, 2)
            seg = (
                0.5 * np.sin(2 * np.pi * own * t + phase1)
                + 0.5 * conf * np.sin(2 * np.pi * other * t + phase2)
            )[None, :] * gains
            segs.append(seg)
            w = vocab[2 * g + parity]
            text_words.append(w)
            words.append({"word": w, "start": round(g * seg_dur, 2),
                          "end": round((g + 1) * seg_dur, 2)})
        sig = np.concatenate(segs, axis=1)
        sig = (sig + noise * rng.standard_normal(sig.shape)).astype(np.float32)
        dur = n_groups * seg_dur
        npy_path = os.path.join(clip_dir, f"conf_{i}_meg.npy")
        np.save(npy_path, sig)
        text = " ".join(text_words)
        rows.append({
            "eeg": {"path": npy_path, "sr": SIGNAL_SAMPLE_RATE},
            "duration": round(dur, 2),
            "language": language,
            "sentence": text,
            "sentences": [{"text": text, "start": 0.0, "end": round(dur, 2),
                           "duration": round(dur, 2), "words": words}],
            "subj": i % 3,
            "story": f"story_{i % 2}",
        })

    n_train = max(1, int(n_clips * 0.8))
    n_val = max(1, (n_clips - n_train) // 2)
    write_jsonlines(os.path.join(root, "train.jsonl"), rows[:n_train])
    write_jsonlines(os.path.join(root, "val.jsonl"),
                    rows[n_train: n_train + n_val])
    write_jsonlines(os.path.join(root, "test.jsonl"),
                    rows[n_train + n_val:] or rows[-1:])
    write_jsonlines(os.path.join(root, "all.jsonl"), rows)
    return rows


def make_noisy_zipf_corpus(
    root: str,
    n_clips: int = 260,
    n_channels: int = 8,
    noise: float = 0.7,
    zipf: float = 1.2,
    min_words: int = 5,
    max_words: int = 8,
    seg_dur: float = 0.3,
    n_vocab: int = 12,
    language: str = "English",
    seed: int = 1,
) -> List[dict]:
    """Noisy Zipf-distributed corpus where the reference's beam-5 /
    rep-penalty-5.0 / ngram-2 eval config (`evaluation.py:369-386`) beats
    plain greedy decoding on held-out WER.

    Mechanism (measured, round 3): word = sinusoid frequency, heavy
    additive noise, Zipfian word frequencies — an underfit model's greedy
    decode collapses into repeating the most frequent word ("the the
    the..."), the classic failure mode repetition penalty 5.0 exists for.
    Words are drawn WITHOUT replacement per sentence, so references never
    repeat a word and the penalty is purely corrective (word-level tokens —
    pair with `make_tokenizer("word:<root>/vocab.txt")`; under a byte vocab
    rp would punish repeated letters instead).

    Splits 85:15 train/test (plus val == test for loader symmetry).
    """
    rng = np.random.default_rng(seed)
    vocab = list(_WORDS[:n_vocab])
    p = 1.0 / (np.arange(n_vocab) + 1) ** zipf
    p /= p.sum()
    freqs = 3.0 + 3.5 * np.arange(n_vocab)
    clip_dir = os.path.join(root, "clips")
    os.makedirs(clip_dir, exist_ok=True)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    seg_n = int(round(seg_dur * SIGNAL_SAMPLE_RATE))
    gains = np.linspace(0.5, 1.5, n_channels)[:, None]
    t = np.arange(seg_n) / SIGNAL_SAMPLE_RATE
    rows = []
    for i in range(n_clips):
        nw = int(rng.integers(min_words, max_words + 1))
        wids = rng.choice(n_vocab, nw, p=p, replace=False)
        segs, words = [], []
        for j, wid in enumerate(wids):
            ph = rng.uniform(0, 2 * np.pi)
            segs.append(
                (0.5 * np.sin(2 * np.pi * freqs[wid] * t + ph))[None, :] * gains
            )
            words.append({"word": vocab[wid], "start": round(j * seg_dur, 2),
                          "end": round((j + 1) * seg_dur, 2)})
        sig = np.concatenate(segs, axis=1)
        sig = (sig + noise * rng.standard_normal(sig.shape)).astype(np.float32)
        path = os.path.join(clip_dir, f"zipf_{i}_meg.npy")
        np.save(path, sig)
        text = " ".join(vocab[w] for w in wids)
        dur = round(nw * seg_dur, 2)
        rows.append({
            "eeg": {"path": path, "sr": SIGNAL_SAMPLE_RATE},
            "duration": dur, "language": language, "sentence": text,
            "sentences": [{"text": text, "start": 0.0, "end": dur,
                           "duration": dur, "words": words}],
            "subj": i % 3, "story": f"story_{i % 2}",
        })
    n_train = max(1, int(n_clips * 0.85))
    write_jsonlines(os.path.join(root, "train.jsonl"), rows[:n_train])
    write_jsonlines(os.path.join(root, "val.jsonl"), rows[n_train:])
    write_jsonlines(os.path.join(root, "test.jsonl"), rows[n_train:])
    write_jsonlines(os.path.join(root, "all.jsonl"), rows)
    return rows
