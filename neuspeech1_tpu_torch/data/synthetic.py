"""Synthetic dataset fixtures: the port's copy of
``make_synthetic_corpus`` from ``neuspeech1_tpu/data/synthetic.py`` (numpy
only; the same seed writes the same files).

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
