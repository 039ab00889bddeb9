"""Manifest-backed dataset for the eeg modality: the port's copy of
``EEGDataset`` from ``neuspeech1_tpu/data/dataset.py``.

Capability parity with reference `utils/reader.py`: `EEGDataset` ≙
`CustomDataset` (`utils/reader.py:128-661`). Pure numpy on the host;
batches reach the device through the collator, the loader and the caller's
upload. Divergence noted in SURVEY §7: train mode does NOT require an
augment config (the reference unconditionally dereferences
`augment_configs['shift']`, `utils/reader.py:457`).

Train-time augmentation (``augment_config``: the shift, noise, mask and
taylor transforms of ``neuspeech1_tpu/ops/augment.py``) is not ported yet
and raises (ROADMAP.md queue 1 item 4). ``SpeechDataset`` waits for the speech modality (queue 1 item 7).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np

from neuspeech1_tpu_torch.config import (
    DATASET_CHANNEL_SLICES,
    MAX_DURATION_S,
    MIN_DURATION_S,
    SIGNAL_SAMPLE_RATE,
)
from neuspeech1_tpu_torch.data import manifest as mf
from neuspeech1_tpu_torch.utils.tokenizer import Tokenizer

_AUGMENT_UNPORTED = (
    "train-time augmentation (augment_config: shift/noise/mask/taylor, "
    "neuspeech1_tpu/ops/augment.py) is not ported yet: ROADMAP.md queue 1 "
    "item 4")


class EEGDataset:
    """Returns dicts {"input_features": [ch, 6000] f32, "labels": List[int]}.

    Args mirror the reference's `CustomDataset` ctor flags
    (`utils/reader.py:129-147`); `channel_slice` replaces the reference's
    path-sniffing channel selection (`utils/reader.py:269-277`) with an
    explicit argument — pass a named preset ('gwilliams'/'schoffelen'),
    a (start, stop) tuple, or None for `[:modal_ch]`.
    """

    def __init__(
        self,
        data_list_path: str,
        tokenizer: Tokenizer,
        mode: str = "train",
        modal_ch: int = 208,
        channel_slice=None,
        level: str = "sentences",
        language: Optional[str] = None,
        task: str = "transcribe",
        filter_dataset: bool = False,
        timestamps: bool = False,
        sample_rate: int = SIGNAL_SAMPLE_RATE,
        min_duration: float = MIN_DURATION_S,
        max_duration: float = MAX_DURATION_S,
        combine_sentences: bool = False,
        split_sentences: bool = False,
        subj=None,
        augment_config: Optional[dict] = None,
        seed: int = 0,
    ):
        assert min_duration >= 0.5, f"min_duration must be >= 0.5, got {min_duration}"
        assert max_duration <= 30, f"max_duration must be <= 30, got {max_duration}"
        self.tokenizer = tokenizer
        self.mode = mode
        self.level = level
        self.modal_ch = modal_ch
        self.language = language
        # label-prefix task token (reference finetune.py:51 --task
        # transcribe|translate, threaded into the processor's prefix)
        self.task = task
        self.timestamps = timestamps
        self.sample_rate = sample_rate
        self.min_duration = min_duration
        self.max_duration = max_duration
        self.combine_sentences = combine_sentences
        self.split_sentences = split_sentences
        if mode == "train" and augment_config:
            raise NotImplementedError(_AUGMENT_UNPORTED)
        self.rng = np.random.default_rng(seed)
        if isinstance(channel_slice, str):
            channel_slice = DATASET_CHANNEL_SLICES[channel_slice]
        self.channel_slice = channel_slice

        rows = mf.read_jsonlines(data_list_path)
        if filter_dataset:
            rows = mf.filter_schoffelen_sentences(rows)
        if subj is not None:
            rows = mf.filter_subject(rows, subj)
        self.rows: List[dict] = rows

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def n_samples(self) -> int:
        return int(self.max_duration * self.sample_rate)

    # -- signal loading ----------------------------------------------------
    def _load_signal(self, row: dict) -> np.ndarray:
        sig = np.load(row["eeg"]["path"]).astype(np.float32)
        if self.channel_slice is not None:
            sig = sig[self.channel_slice[0] : self.channel_slice[1]]
        else:
            sig = sig[: self.modal_ch]
        return self._pad_channels(sig)

    def _pad_channels(self, sig: np.ndarray) -> np.ndarray:
        """Zero-pad missing channels at the end (`utils/reader.py:508-516`);
        used for cross-dataset joint training with differing channel counts."""
        if sig.shape[0] == self.modal_ch:
            return sig
        assert sig.shape[0] < self.modal_ch, (
            f"clip has {sig.shape[0]} channels > modal_ch={self.modal_ch}"
        )
        return np.pad(sig, ((0, self.modal_ch - sig.shape[0]), (0, 0)))

    def _pad_time(self, sig: np.ndarray) -> np.ndarray:
        """Clip/zero-pad to [ch, 6000] (`utils/reader.py:496-506`)."""
        n = self.n_samples
        sig = sig[:, :n]
        return np.pad(sig, ((0, 0), (0, n - sig.shape[-1])))

    # -- sample assembly ---------------------------------------------------
    def _get_row_data(self, idx: int) -> Tuple[np.ndarray, list, Optional[str]]:
        row = copy.deepcopy(self.rows[idx])
        sig = self._load_signal(row)
        transcript = row.get("sentences") or []
        language = row.get("language") or self.language
        return sig, transcript, language

    def _combine_random(self, idx: int):
        """Randomly append up to 3 more sentences with 0-1 s gaps
        (`utils/reader.py:321-342`)."""
        sig, transcript, language = self._get_row_data(idx)
        total = sig.shape[1] / self.sample_rate
        n_extra = int(self.rng.integers(0, 4))
        for _ in range(n_extra):
            j = int(self.rng.integers(0, len(self.rows)))
            sig2, tr2, _ = self._get_row_data(j)
            gap = float(self.rng.uniform(0.0, 1.0))
            new_total = total + gap + sig2.shape[1] / self.sample_rate
            if new_total >= self.max_duration - 0.5:
                break
            gap_samples = int(gap * self.sample_rate)
            sig = np.concatenate(
                [sig, np.zeros((sig.shape[0], gap_samples), sig.dtype), sig2], axis=1
            )
            offset = total + gap
            for t in tr2:
                t = copy.deepcopy(t)
                t["start"] += offset
                t["end"] += offset
                for w in t.get("words", []):
                    w["start"] += offset
                    w["end"] += offset
                transcript.append(t)
            total = new_total
        return sig, transcript, language

    def _split_random(self, idx: int):
        """Random prefix/suffix crop of signal + word-proportional transcript
        (`utils/reader.py:305-319`). Only meaningful without timestamps."""
        sig, transcript, language = self._get_row_data(idx)
        text = " ".join(t["text"] for t in transcript)
        words = text.split()
        ratio = float(self.rng.random()) * 0.8 + 0.2
        seg_len = int(sig.shape[1] * ratio)
        seg_words = max(int(len(words) * ratio), 1)
        if self.rng.random() > 0.5:
            sig = sig[:, -seg_len:]
            words = words[-seg_words:]
        else:
            sig = sig[:, :seg_len]
            words = words[:seg_words]
        new_text = " ".join(words)
        dur = sig.shape[1] / self.sample_rate
        transcript = [{"text": new_text, "start": 0.0, "end": dur, "words": []}]
        return sig, transcript, language

    def __getitem__(self, idx: int) -> dict:
        if self.combine_sentences and self.mode == "train":
            sig, transcript, language = self._combine_random(idx)
        elif self.split_sentences and self.mode == "train":
            sig, transcript, language = self._split_random(idx)
        else:
            sig, transcript, language = self._get_row_data(idx)

        sig = self._pad_time(sig)

        if transcript:
            if self.timestamps:
                labels = self.tokenizer.build_timestamp_labels(
                    transcript, language=language, task=self.task,
                    level=self.level,
                )
            else:
                text = " ".join(t["text"] for t in transcript)
                labels = self.tokenizer.build_labels(
                    text, language=language, task=self.task)
        else:
            c = self.tokenizer.config
            labels = [c.sot_id, c.nocaptions_id, c.eot_id]

        return {"input_features": sig.astype(np.float32), "labels": labels}

    def text(self, idx: int) -> str:
        """Gold transcript text for metric computation."""
        return self.rows[idx].get("sentence", "")

    # -- native fast path ---------------------------------------------
    def supports_native_signals(self) -> bool:
        """The C++ batch loader handles slice/pad but not the train-time
        sentence combining and splitting."""
        return not (self.mode == "train"
                    and (self.combine_sentences or self.split_sentences))

    def signal_path(self, idx: int) -> str:
        return self.rows[idx]["eeg"]["path"]

    def get_labels(self, idx: int):
        """Labels only (no signal IO) — pairs with the native signal path."""
        row = self.rows[idx]
        transcript = row.get("sentences") or []
        language = row.get("language") or self.language
        if transcript:
            if self.timestamps:
                return self.tokenizer.build_timestamp_labels(
                    transcript, language=language, task=self.task,
                    level=self.level,
                )
            text = " ".join(t["text"] for t in transcript)
            return self.tokenizer.build_labels(
                text, language=language, task=self.task)
        c = self.tokenizer.config
        return [c.sot_id, c.nocaptions_id, c.eot_id]
