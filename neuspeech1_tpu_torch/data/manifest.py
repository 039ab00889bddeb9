"""jsonl manifest IO — the de-facto IR of the pipeline: the port's copy of
``neuspeech1_tpu/data/manifest.py``.

Line schema (produced by the preprocessing CLIs, consumed by the dataset;
reference `process_dataset/gwilliams2023_process.py:188-201` /
`utils/reader.py:253-303`):

    {"speech": {"path": ".../x_audio.wav", "sr": 16000},
     "eeg":    {"path": ".../x_meg.npy",  "sr": 200},
     "duration": 3.2, "language": "English",
     "sentence": "the full text",
     "sentences": [{"text": ..., "start": 0.0, "end": 3.2, "duration": 3.2,
                    "words": [{"word": ..., "start": ..., "end": ...}, ...]}],
     "subj": 1, "story": "...", "sent_type": "ZINNEN"}
"""

from __future__ import annotations

import json
import random
from typing import Iterable, List


def read_jsonlines(path: str) -> List[dict]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_jsonlines(path: str, rows: Iterable[dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def filter_schoffelen_sentences(rows: List[dict]) -> List[dict]:
    """Keep only ZINNEN (sentence-block) clips under 30 s.

    Reference `utils/reader.py:198-210` and
    `process_dataset/filter_schoffelen_jsonl.py:41-46`.
    """
    return [r for r in rows if r.get("sent_type") == "ZINNEN" and r["duration"] < 30]


def filter_subject(rows: List[dict], subj) -> List[dict]:
    """Reference `utils/reader.py:212-224`."""
    return [r for r in rows if r.get("subj") == subj]


def filter_duration(
    rows: List[dict], min_s: float = 0.5, max_s: float = 30.0
) -> List[dict]:
    return [r for r in rows if min_s <= r["duration"] <= max_s]


def combine_manifests(
    paths: List[str], out_path: str, shuffle: bool = True, seed: int = 0
) -> int:
    """Concatenate + shuffle jsonls for joint multilingual training.

    Reference `process_dataset/combine_jsonls.py:36-50`.
    """
    rows: List[dict] = []
    for p in paths:
        rows.extend(read_jsonlines(p))
    if shuffle:
        random.Random(seed).shuffle(rows)
    write_jsonlines(out_path, rows)
    return len(rows)


def add_language(rows: List[dict], language: str) -> List[dict]:
    """Stamp a language onto every row (the reference's `combine_jsonls.sh`
    references a missing `add_language.py`; this is its working equivalent)."""
    for r in rows:
        r["language"] = language
    return rows


def split_train_val_test(
    rows: List[dict],
    ratios=(0.8, 0.1, 0.1),
    seed: int = 0,
):
    """Random 8:1:1 split over clips (reference
    `process_dataset/gwilliams2023_process.py:260-283`)."""
    rows = list(rows)
    random.Random(seed).shuffle(rows)
    n = len(rows)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    return (
        rows[:n_train],
        rows[n_train : n_train + n_val],
        rows[n_train + n_val :],
    )
