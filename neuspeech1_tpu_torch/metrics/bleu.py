"""Corpus BLEU with uniform n-gram weights. The port's copy of
``neuspeech1_tpu/metrics/bleu.py``.

Replacement for the reference's torchmetrics BLEUScore loop producing
bleu-1..4 (`metrics/bleu.py:6-12`): bleu-n uses uniform weights 1/n over
1..n-grams, whitespace tokenization, no smoothing, standard brevity penalty
(== nltk corpus_bleu / Papineni et al.).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    preds: List[str], refs_list: List[List[str]], max_n: int = 4
) -> float:
    """refs_list[i] = list of reference strings for preds[i]."""
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(preds, refs_list):
        p = pred.split()
        rs = [r.split() for r in refs]
        pred_len += len(p)
        # closest reference length (ties -> shorter), per standard BLEU
        ref_len += min((abs(len(r) - len(p)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            pc = _ngrams(p, n)
            if not pc:
                continue
            max_ref = Counter()
            for r in rs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            totals[n - 1] += sum(pc.values())
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in pc.items())
    if min(totals) == 0 or min(clipped) == 0:
        return 0.0
    log_prec = sum(
        math.log(clipped[i] / totals[i]) for i in range(max_n)
    ) / max_n
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return bp * math.exp(log_prec)


def bleu_battery(preds: List[str], refs: List[str]) -> Dict[str, float]:
    """bleu-1..4 over single references (reference `metrics/bleu.py`)."""
    refs_list = [[r] for r in refs]
    return {
        f"bleu-{n}": corpus_bleu(preds, refs_list, max_n=n) for n in range(1, 5)
    }
