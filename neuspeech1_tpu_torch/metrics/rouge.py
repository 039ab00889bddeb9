"""ROUGE-1/2/L/Lsum precision/recall/fmeasure. The port's copy of
``neuspeech1_tpu/metrics/rouge.py``.

Replacement for the reference's per-pair torchmetrics rouge loop
(`metrics/my_rouge.py:6-16`): compute per pair, mean over the corpus, x100,
with torchmetrics-style keys (rouge1_fmeasure, ...). Tokenization follows
rouge_score/torchmetrics: lowercase, split on non-alphanumeric.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def _prf(match: int, pred_n: int, ref_n: int) -> Dict[str, float]:
    p = match / pred_n if pred_n else 0.0
    r = match / ref_n if ref_n else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return {"precision": p, "recall": r, "fmeasure": f}


def _ngram_scores(pred: List[str], ref: List[str], n: int) -> Dict[str, float]:
    pc = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
    rc = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    overlap = sum(min(c, rc[g]) for g, c in pc.items())
    return _prf(overlap, sum(pc.values()), sum(rc.values()))


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def _lcs_scores(pred: List[str], ref: List[str]) -> Dict[str, float]:
    return _prf(_lcs_len(pred, ref), len(pred), len(ref))


def _sentences(text: str) -> List[str]:
    # newline-based splitting, matching rouge_score/torchmetrics defaults
    # (their nltk-based splitter is opt-in and needs downloaded data)
    return [s for s in text.split("\n") if s.strip()]


def _lcs_sum_scores(pred: str, ref: str) -> Dict[str, float]:
    """rougeLsum: union-LCS over sentence splits (rouge_score semantics)."""
    pred_sents = [_tokenize(s) for s in _sentences(pred)]
    ref_sents = [_tokenize(s) for s in _sentences(ref)]
    pred_n = sum(len(s) for s in pred_sents)
    ref_n = sum(len(s) for s in ref_sents)
    # union LCS: for each ref sentence, union of LCS token hits vs each pred
    hits = 0
    for r in ref_sents:
        token_hits = Counter()
        for p in pred_sents:
            # count LCS tokens (multiset union across pred sentences)
            lcs = _lcs_tokens(r, p)
            for t in lcs:
                token_hits[t] = max(token_hits[t], lcs.count(t))
        # clip by counts in the ref sentence
        rc = Counter(r)
        hits += sum(min(c, rc[t]) for t, c in token_hits.items())
    return _prf(hits, pred_n, ref_n)


def _lcs_tokens(a: List[str], b: List[str]) -> List[str]:
    """One LCS (tokens) via backtrack."""
    la, lb = len(a), len(b)
    dp = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            dp[i][j] = (
                dp[i - 1][j - 1] + 1
                if a[i - 1] == b[j - 1]
                else max(dp[i - 1][j], dp[i][j - 1])
            )
    out = []
    i, j = la, lb
    while i and j:
        if a[i - 1] == b[j - 1]:
            out.append(a[i - 1])
            i -= 1
            j -= 1
        elif dp[i - 1][j] >= dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return out[::-1]


def rouge_pair(pred: str, ref: str) -> Dict[str, float]:
    p, r = _tokenize(pred), _tokenize(ref)
    out = {}
    for n, name in ((1, "rouge1"), (2, "rouge2")):
        for k, v in _ngram_scores(p, r, n).items():
            out[f"{name}_{k}"] = v
    for k, v in _lcs_scores(p, r).items():
        out[f"rougeL_{k}"] = v
    for k, v in _lcs_sum_scores(pred, ref).items():
        out[f"rougeLsum_{k}"] = v
    return out


def rouge_battery(preds: List[str], refs: List[str]) -> Dict[str, float]:
    """Mean over pairs x 100 (reference `metrics/my_rouge.py:6-16`)."""
    acc: Dict[str, float] = {}
    for pred, ref in zip(preds, refs):
        for k, v in rouge_pair(pred, ref).items():
            acc[k] = acc.get(k, 0.0) + v
    n = max(len(preds), 1)
    return {k: v / n * 100.0 for k, v in acc.items()}
