"""jsonl manifest reading: the port's copy of ``read_jsonlines`` from
``neuspeech1_tpu/data/manifest.py``. One JSON object per line (blank lines
skipped); the serving path reads the ``sentence`` field of a training
manifest to build the speculative decoder's draft table
(``serve.Transcriber(spec_draft_from=...)``)."""

from __future__ import annotations

import json
from typing import List


def read_jsonlines(path: str) -> List[dict]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
