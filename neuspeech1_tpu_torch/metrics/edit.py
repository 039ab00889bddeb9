"""Edit-distance core + word/char error measures. The port's copy of
``neuspeech1_tpu/metrics/edit.py``.

One Levenshtein alignment backs WER / MER / WIL / WIP / CER, replacing the
reference's torchmetrics/jiwer stack (`metrics/wer.py`, `metrics/mer.py`,
`metrics/word_info_lost.py`, `metrics/word_info_preserved.py`,
`metrics/cer.py`). All are corpus-level: counts are summed over pairs before
the final ratio (torchmetrics semantics).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def edit_counts(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """(hits, substitutions, deletions, insertions) of aligning hyp to ref."""
    n, m = len(ref), len(hyp)
    # dp over (cost, hits) — standard Levenshtein; hits recovered via
    # backtrace-free parallel tracking (cost primary, hits secondary max)
    INF = 1 << 30
    prev = [(j, 0) for j in range(m + 1)]  # (cost, hits) for i=0
    for i in range(1, n + 1):
        cur = [(i, 0)] + [(INF, 0)] * m
        r = ref[i - 1]
        for j in range(1, m + 1):
            same = r == hyp[j - 1]
            # substitution / match
            c, h = prev[j - 1]
            best = (c + (0 if same else 1), h + (1 if same else 0))
            # deletion (ref word dropped)
            c, h = prev[j]
            cand = (c + 1, h)
            if cand[0] < best[0] or (cand[0] == best[0] and cand[1] > best[1]):
                best = cand
            # insertion (extra hyp word)
            c, h = cur[j - 1]
            cand = (c + 1, h)
            if cand[0] < best[0] or (cand[0] == best[0] and cand[1] > best[1]):
                best = cand
            cur[j] = best
        prev = cur
    cost, hits = prev[m]
    # recover S, D, I from cost & hits:
    #   n = hits + S + D ;  m = hits + S + I ;  cost = S + D + I
    s = (n + m - 2 * hits - cost) // 2 + cost - (n - hits) - (m - hits) + 0
    # solve directly: S + D = n - hits ; S + I = m - hits ; S + D + I = cost
    s = (n - hits) + (m - hits) - cost
    d = (n - hits) - s
    i = (m - hits) - s
    return hits, s, d, i


def _agg(pairs, tokenize) -> Dict[str, float]:
    H = S = D = I = N_ref = N_hyp = 0
    for hyp, ref in pairs:
        r, h = tokenize(ref), tokenize(hyp)
        hh, s, d, i = edit_counts(r, h)
        H += hh
        S += s
        D += d
        I += i
        N_ref += len(r)
        N_hyp += len(h)
    return dict(H=H, S=S, D=D, I=I, N_ref=N_ref, N_hyp=N_hyp)


def word_measures(preds: List[str], refs: List[str]) -> Dict[str, float]:
    """Corpus WER / MER / WIL / WIP (jiwer definitions)."""
    c = _agg(zip(preds, refs), str.split)
    H, S, D, I = c["H"], c["S"], c["D"], c["I"]
    n_ref, n_hyp = max(c["N_ref"], 1), max(c["N_hyp"], 1)
    wer = (S + D + I) / n_ref
    mer = (S + D + I) / max(H + S + D + I, 1)
    wip = (H / n_ref) * (H / n_hyp) if H else 0.0
    return {"wer": wer, "mer": mer, "wil": 1.0 - wip, "wip": wip}


def wer(preds: List[str], refs: List[str]) -> float:
    return word_measures(preds, refs)["wer"]


def cer(preds: List[str], refs: List[str]) -> float:
    """Corpus character error rate (whitespace kept, per jiwer/HF cer which
    the reference vendors in `metrics/cer.py`)."""
    c = _agg(zip(preds, refs), list)
    return (c["S"] + c["D"] + c["I"]) / max(c["N_ref"], 1)
