"""Text post-processing: the port's copy of ``neuspeech1_tpu/utils/text.py``
(reference `utils/process_str.py`, `utils/data_utils.py:110-137`)."""

from __future__ import annotations

import re
from typing import List

_PUNCT = "!,.;:?、！，。；：？"


def filter_ascii_text(text: str) -> str:
    """Keep printable-ascii chars only (reference
    `utils/process_str.py:24-35`, used when --post_processing)."""
    return "".join(ch for ch in text if 32 <= ord(ch) < 127)


def filter_ascii_list(texts: List[str]) -> List[str]:
    return [filter_ascii_text(t) for t in texts]


def convert_lower_text(texts: List[str]) -> List[str]:
    """Reference `utils/process_str.py:38-47`."""
    return [t.lower() for t in texts]


def remove_punctuation(texts) -> List[str]:
    """Strip CJK + ascii punctuation (reference
    `utils/data_utils.py:110-122`)."""
    if isinstance(texts, str):
        texts = [texts]
    out = []
    for t in texts:
        out.append(re.sub(rf"[{re.escape(_PUNCT)}]", "", t).strip())
    return out


def to_simple(texts) -> List[str]:
    """Traditional->simplified Chinese (reference uses zhconv,
    `utils/data_utils.py:126-137`). Uses zhconv when installed; otherwise
    the vendored high-frequency character table (`utils/zh_t2s.py`) —
    characters outside the table pass through unchanged."""
    if isinstance(texts, str):
        texts = [texts]
    try:
        from zhconv import convert  # pragma: no cover

        return [convert(t, "zh-cn") for t in texts]
    except ImportError:
        from neuspeech1_tpu_torch.utils.zh_t2s import convert_t2s

        return [convert_t2s(t) for t in texts]
