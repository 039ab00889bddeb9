"""Offline corpus preprocessing: raw MEG recordings -> sentence clips.
The port's copy of ``neuspeech1_tpu/data/preprocess.py`` (numpy, scipy;
pandas and MNE imported lazily where a function needs them).

Counterpart of `process_dataset/gwilliams2023_process.py` (MEG KIT .con,
English) and `process_dataset/schoffelen_process.py` (CTF .ds, Dutch):
parse BIDS events, assemble sentences, slice MEG + audio, robust-scale, and
write `.npy` + `.wav` + jsonl manifests with the §2 data contract.

Raw-file readers are injectable. The default resolver uses MNE for real
.con/.ds recordings (gated import — MNE is an optional dependency) and a
numpy+scipy path for `.npy` raw arrays, which makes the whole pipeline
testable offline; the DSP chain (bandpass, notch, resample) is
`ops/signal.py` either way.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from neuspeech1_tpu_torch.config import AUDIO_SAMPLE_RATE, SIGNAL_SAMPLE_RATE
from neuspeech1_tpu_torch.data.manifest import write_jsonlines
from neuspeech1_tpu_torch.ops.signal import (
    bandpass_filter,
    notch_filter,
    resample,
    robust_scale,
)


# ----------------------------------------------------------------------
# shared numerical pieces
# ----------------------------------------------------------------------

def detect_outliers(arr: np.ndarray) -> Optional[str]:
    """None == clean; else a reason string (reference
    `gwilliams2023_process.py:23-42`)."""
    if arr.shape[-1] == 0:
        return "empty clip"
    zero_frac = np.count_nonzero(arr == 0) / arr.size
    if zero_frac > 0.2:
        return f"{zero_frac * 100:.1f}% zeros"
    if np.isnan(arr).any():
        return "NaN values"
    if np.isinf(arr).any():
        return "inf values"
    return None


def preprocess_clip(
    data: np.ndarray, threshold: float = 10.0, fit_samples: int = 100,
    max_clip_ratio: float = 0.2,
) -> Tuple[np.ndarray, float]:
    """Per-clip robust scaling, gwilliams/schoffelen variant: scaler fit on
    the first `fit_samples` TIME samples only, then clip to ±threshold and
    normalize (reference `gwilliams2023_process.py:88-106`)."""
    data = np.asarray(data, dtype=np.float64)
    head = data[:, :fit_samples]
    med = np.median(head, axis=1, keepdims=True)
    q1 = np.percentile(head, 25.0, axis=1, keepdims=True)
    q3 = np.percentile(head, 75.0, axis=1, keepdims=True)
    iqr = np.where(q3 - q1 == 0, 1.0, q3 - q1)
    data = (data - med) / iqr
    clipped = np.abs(data) > threshold
    ratio = float(clipped.sum()) / data.size
    assert ratio < max_clip_ratio, (
        f"clip ratio {ratio:.3f} >= {max_clip_ratio} — bad recording?"
    )
    data = np.clip(data, -threshold, threshold) / threshold
    return data.astype(np.float32), ratio


# ----------------------------------------------------------------------
# raw readers (injectable)
# ----------------------------------------------------------------------

def load_raw_npy(path: str, orig_sr: int, l_freq: float, h_freq: float,
                 notch_hz: Optional[float], target_sr: int) -> np.ndarray:
    """Test/offline path: [ch, T] .npy raw + scipy DSP chain."""
    data = np.load(path).astype(np.float64)
    if notch_hz:
        data = notch_filter(data, notch_hz, orig_sr)
    data = bandpass_filter(data, l_freq, h_freq, orig_sr)
    return resample(data, orig_sr, target_sr)


def load_raw_kit(path: str, l_freq: float = 1.0, h_freq: float = 58.0,
                 target_sr: int = SIGNAL_SAMPLE_RATE) -> np.ndarray:
    """Gwilliams KIT .con reader: meg+ref picks (224 ch), 1-58 Hz, 200 Hz
    (reference `gwilliams2023_process.py:139-147`). Requires MNE."""
    try:
        import mne
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "MNE is required to read .con recordings; install the "
            "'preprocess' extra or preprocess on a machine with MNE"
        ) from e
    raw = mne.io.read_raw_kit(path, preload=True, verbose=False)
    picks = mne.pick_types(raw.info, meg=True, ref_meg=True, eeg=False,
                           stim=False, eog=False, ecg=False)
    raw.pick(picks, verbose=False)
    raw.filter(l_freq=l_freq, h_freq=h_freq, verbose=False)
    raw.resample(target_sr)
    data = raw.get_data()
    assert data.shape[0] == 224, f"expected 224 channels, got {data.shape}"
    return data


def load_raw_ctf(path: str, l_freq: float = 1.0, h_freq: float = 60.0,
                 notch_hz: float = 50.0,
                 target_sr: int = SIGNAL_SAMPLE_RATE) -> Tuple[np.ndarray, float]:
    """Schoffelen CTF .ds reader: picks [:28+273], 50 Hz notch, 1-60 Hz,
    200 Hz (reference `schoffelen_process.py:150-157`). Requires MNE.
    Returns (data, original_sfreq)."""
    try:
        import mne
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("MNE is required to read .ds recordings") from e
    raw = mne.io.read_raw_ctf(path, preload=True, verbose=False)
    raw.pick(raw.ch_names[: 28 + 273], verbose=False)
    orig_sr = raw.info["sfreq"]
    raw.notch_filter(notch_hz, verbose=False)
    raw.filter(l_freq=l_freq, h_freq=h_freq, verbose=False)
    raw.resample(target_sr)
    return raw.get_data(), orig_sr


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """wav reader (mono float32) — replaces soundfile."""
    from neuspeech1_tpu_torch.data.synthetic import read_wav

    return read_wav(path)


# ----------------------------------------------------------------------
# Gwilliams 2023 (English, MEG-MASC)
# ----------------------------------------------------------------------

def get_sequences(tsv_path: str) -> List[dict]:
    """Assemble sentences from an events.tsv: consecutive word events with
    the same sequence_id form one sentence (reference
    `gwilliams2023_process.py:43-85`)."""
    import ast

    import pandas as pd

    text = pd.read_csv(tsv_path, delimiter="\t")
    words = []
    for i in range(len(text)):
        # BIDS trial_type cells are python-dict literals; literal_eval
        # cannot execute code (the reference uses bare eval,
        # `gwilliams2023_process.py:49`)
        tti = ast.literal_eval(text["trial_type"][i])
        if tti.get("kind") == "word":
            words.append({
                "onset": float(text.iloc[i]["onset"]),
                "duration": float(text.iloc[i]["duration"]),
                **tti,
            })
    sentences: List[dict] = []
    old_seq = None
    for w in words:
        seq_id = int(w["sequence_id"])
        if seq_id != old_seq:
            sentences.append({"words": []})
        sentences[-1]["words"].append(w)
        old_seq = seq_id
    for s in sentences:
        w0, wN = s["words"][0], s["words"][-1]
        s["story"] = w0.get("story")
        s["story_id"] = w0.get("story_uid")
        s["sound_id"] = w0.get("sound_id")
        s["seq_id"] = w0.get("sequence_id")
        s["speech_rate"] = w0.get("speech_rate")
        s["voice"] = w0.get("voice")
        s["audio_path"] = w0.get("sound")
        s["start"] = w0["onset"]
        s["end"] = wN["onset"] + wN["duration"]
        s["audio_start"] = w0.get("start", w0["onset"])
        s["audio_end"] = wN.get("start", wN["onset"]) + wN["duration"]
        s["duration"] = s["audio_end"] - s["audio_start"]
        s["text"] = " ".join(w["word"] for w in s["words"])
    return sentences


def process_gwilliams_events(
    tsv_path: str,
    out_dir: str,
    raw_loader: Callable[[], np.ndarray],
    audio_root: str = "",
    target_meg_sr: int = SIGNAL_SAMPLE_RATE,
    target_speech_sr: int = AUDIO_SAMPLE_RATE,
    subj: Optional[int] = None,
) -> List[dict]:
    """Slice one recording into per-sentence clips + manifest rows.

    `raw_loader()` -> [ch, T] array already filtered/resampled to
    `target_meg_sr` (inject `load_raw_kit` or a test loader).
    """
    from neuspeech1_tpu_torch.data.synthetic import write_wav

    sentences = get_sequences(tsv_path)
    data = raw_loader()
    os.makedirs(out_dir, exist_ok=True)
    if subj is None:
        base = os.path.basename(tsv_path)
        subj = int(base[4:6]) if base[:4] == "sub-" else 0

    lines: List[dict] = []
    audio_cache: Dict[str, Tuple[np.ndarray, int]] = {}
    for i, sent in enumerate(sentences):
        a = int(sent["start"] * target_meg_sr)
        b = int(sent["end"] * target_meg_sr)
        seg = data[:, a:b]
        if detect_outliers(seg) is not None:
            break
        try:
            seg, _ = preprocess_clip(seg, threshold=10.0)
        except AssertionError:
            break
        audio_rel = sent.get("audio_path")
        wav_out = None
        if audio_rel:
            ap = os.path.join(audio_root, str(audio_rel).lower())
            if os.path.exists(ap):
                if ap not in audio_cache:
                    audio_cache[ap] = load_audio(ap)
                speech, sr = audio_cache[ap]
                sa = int(sent["audio_start"] * sr)
                sb = int(sent["audio_end"] * sr)
                seg_audio = resample(speech[sa:sb], sr, target_speech_sr)
                wav_out = os.path.join(out_dir, f"senid_{i}_audio.wav")
                write_wav(wav_out, seg_audio, target_speech_sr)
        npy_out = os.path.join(out_dir, f"senid_{i}_meg.npy")
        np.save(npy_out, seg)
        line = {
            "eeg": {"path": os.path.abspath(npy_out), "sr": target_meg_sr},
            "duration": round(float(sent["duration"]), 4),
            "language": "English",
            "sentence": sent["text"],
            "sentences": [{
                "text": sent["text"], "start": 0.0,
                "end": round(float(sent["duration"]), 4),
                "duration": round(float(sent["duration"]), 4),
                "words": [
                    {"word": w["word"],
                     "start": round(w["onset"] - sent["audio_start"], 4),
                     "end": round(w["onset"] + w["duration"] - sent["audio_start"], 4)}
                    for w in sent["words"]
                ],
            }],
            "subj": subj,
            "story": sent.get("story"),
            "story_id": sent.get("story_id"),
            "seq_id": sent.get("seq_id"),
            "sound_id": sent.get("sound_id"),
            "speech_rate": sent.get("speech_rate"),
            "voice": sent.get("voice"),
        }
        if wav_out:
            line["speech"] = {"path": os.path.abspath(wav_out),
                              "sr": target_speech_sr}
        lines.append(line)
    write_jsonlines(os.path.join(out_dir, "info.jsonl"), lines)
    return lines


# ----------------------------------------------------------------------
# Schoffelen 2019 (Dutch, MOUS)
# ----------------------------------------------------------------------

def read_stimuli_dict(path: str) -> Dict[str, str]:
    """stimuli.txt: '<id> <sentence>' per line (reference
    `schoffelen_process.py:28-38`)."""
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, value = line.split(" ", 1)
            out[key] = value
    return out


def read_tsv_auditory(
    tsv_path: str, stimuli: Dict[str, str], audio_dir: str
) -> List[dict]:
    """Parse ZINNEN (sentences) vs WOORDEN (word lists) audio events
    (reference `schoffelen_process.py:61-103`)."""
    import pandas as pd

    df = pd.read_csv(tsv_path, delimiter="\t")
    result: List[dict] = []
    prev_type = None
    for _, row in df.iterrows():
        val = str(row["value"])
        if val == "ZINNEN":
            prev_type = "ZINNEN"
        elif val == "WOORDEN":
            prev_type = "WOORDEN"
        if str(row["type"]) == "Sound" and val.endswith(".wav"):
            speech = val[-7:-4]
            result.append({
                "audio_path": os.path.join(
                    audio_dir, f"EQ_Ramp_Int2_Int1LPF{speech}.wav"
                ),
                "text": stimuli.get(str(int(speech)), ""),
                "onset": int(row["sample"]),
                "type": prev_type or "unknown",
                "stimuli_type": "audio",
            })
        if str(row["type"]) == "Nothing" and "End of file" in val and result:
            result[-1]["offset"] = int(row["sample"])
    return [r for r in result if "offset" in r]


def read_tsv_visual(tsv_path: str, stimuli: Dict[str, str]) -> List[dict]:
    """Visual-stimuli variant: word-by-word visual presentation blocks
    (reference `schoffelen_process.py:216-310`, largely commented out of the
    reference's main; implemented here for capability completeness).

    Emits one event per visual sentence: onset of the first word,
    offset of the last word/blank in the block.
    """
    import pandas as pd

    df = pd.read_csv(tsv_path, delimiter="\t")
    result: List[dict] = []
    prev_type = None
    current: Optional[dict] = None
    for _, row in df.iterrows():
        val = str(row["value"])
        typ = str(row["type"])
        if val == "ZINNEN":
            prev_type = "ZINNEN"
        elif val == "WOORDEN":
            prev_type = "WOORDEN"
        if typ == "Picture" and val.isdigit():
            # stimulus id picture starts a sentence block
            sid = str(int(val))
            if current is not None:
                result.append(current)
            current = {
                "text": stimuli.get(sid, ""),
                "onset": int(row["sample"]),
                "offset": int(row["sample"]),
                "type": prev_type or "unknown",
                "stimuli_type": "visual",
                "sentence_id": sid,
            }
        elif current is not None and typ in ("Word", "Blank", "Picture"):
            current["offset"] = int(row["sample"])
    if current is not None:
        result.append(current)
    return [r for r in result if r["offset"] > r["onset"]]


def process_schoffelen_events(
    tsv_path: str,
    out_dir: str,
    raw_loader: Callable[[], Tuple[np.ndarray, float]],
    stimuli: Dict[str, str],
    audio_dir: str,
    target_meg_sr: int = SIGNAL_SAMPLE_RATE,
    target_speech_sr: int = AUDIO_SAMPLE_RATE,
    subj: Optional[str] = None,
) -> List[dict]:
    """`raw_loader()` -> (data [ch, T@200Hz], original_sfreq)."""
    from neuspeech1_tpu_torch.data.synthetic import write_wav

    sentences = read_tsv_auditory(tsv_path, stimuli, audio_dir)
    data, orig_sr = raw_loader()
    os.makedirs(out_dir, exist_ok=True)
    if subj is None:
        base = os.path.basename(tsv_path)
        subj = base[5:9] if base.startswith("sub-") else "0"

    lines: List[dict] = []
    for i, sent in enumerate(sentences):
        a = int(sent["onset"] / orig_sr * target_meg_sr)
        b = int(sent["offset"] / orig_sr * target_meg_sr)
        seg = data[:, a:b]
        duration = (b - a) / target_meg_sr
        if detect_outliers(seg) is not None:
            break
        try:
            seg, _ = preprocess_clip(seg, threshold=10.0)
        except AssertionError:
            break
        npy_out = os.path.join(out_dir, f"senid_{i}_meg.npy")
        np.save(npy_out, seg)
        wav_out = None
        if os.path.exists(sent["audio_path"]):
            speech, sr = load_audio(sent["audio_path"])
            seg_audio = resample(speech, sr, target_speech_sr)
            wav_out = os.path.join(out_dir, f"senid_{i}_audio.wav")
            write_wav(wav_out, seg_audio, target_speech_sr)
        line = {
            "eeg": {"path": os.path.abspath(npy_out), "sr": target_meg_sr},
            "duration": round(float(duration), 4),
            "language": "Dutch",
            "sentence_id": os.path.basename(sent["audio_path"])[-7:-4],
            "sentence": sent["text"],
            "sentences": [{
                "text": sent["text"], "start": 0.0,
                "end": round(float(duration), 4),
                "duration": round(float(duration), 4),
            }],
            "subj": subj,
            "stimuli_type": "audio",
            "sent_type": sent["type"],
        }
        if wav_out:
            line["speech"] = {"path": os.path.abspath(wav_out),
                              "sr": target_speech_sr}
        lines.append(line)
    write_jsonlines(os.path.join(out_dir, "info.jsonl"), lines)
    return lines
