"""METEOR (nltk-compatible single_meteor_score). The port's copy of
``neuspeech1_tpu/metrics/meteor.py``.

The reference averages `nltk single_meteor_score` over pairs
(`metrics/meteor.py:7-11`). This is the same algorithm (exact -> porter-stem
-> wordnet-synonym alignment stages; F-mean alpha=0.9, penalty
gamma=0.5 * frag^3). The wordnet stage is used when the nltk wordnet corpus
is installed and silently skipped otherwise (zero-egress images have no
corpus downloads; exact+stem dominates the score in practice).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

try:
    from nltk.stem.porter import PorterStemmer

    _STEMMER = PorterStemmer()
except Exception:  # pragma: no cover
    _STEMMER = None

try:
    from nltk.corpus import wordnet as _wn

    _wn.synsets("dog")  # force the LookupError early if data is missing
    _HAS_WORDNET = True
except Exception:  # pragma: no cover
    _wn = None
    _HAS_WORDNET = False


def _match_stage(hyp, ref, key):
    """nltk `_match_enums` semantics: iterate hypothesis words in REVERSE
    and match each to the LATEST still-unused reference position with an
    equal key (the original nltk nested reverse j-scan). The pairing order
    matters for the chunk count whenever surface forms repeat.

    hyp/ref: list of (enum_index, word) still unmatched. Returns matches as
    (hyp_idx, ref_idx) pairs plus the remaining lists (original order).
    """
    ref_positions: Dict[str, List[int]] = {}
    for j, (_, rw) in enumerate(ref):
        ref_positions.setdefault(key(rw), []).append(j)
    matches = []
    matched_h = set()
    matched_r = set()
    for i in range(len(hyp) - 1, -1, -1):
        positions = ref_positions.get(key(hyp[i][1]))
        if positions:
            j = positions.pop()
            matched_h.add(i)
            matched_r.add(j)
            matches.append((hyp[i][0], ref[j][0]))
    rem_hyp = [p for i, p in enumerate(hyp) if i not in matched_h]
    rem_ref = [p for j, p in enumerate(ref) if j not in matched_r]
    return matches, rem_hyp, rem_ref


def _wordnet_match(hyp, ref, wordnet=None):
    """Synonym-stage matching. ``wordnet`` is injectable (same duck type as
    nltk's: ``synsets(word)`` -> objects with ``lemmas()`` -> ``name()``),
    mirroring nltk `single_meteor_score(..., wordnet=...)` so the stage is
    testable without the wordnet corpus download."""
    wn = wordnet if wordnet is not None else _wn
    ref_positions: Dict[str, List[int]] = {}
    for j, (_, rw) in enumerate(ref):
        ref_positions.setdefault(rw, []).append(j)
    matches = []
    matched_h = set()
    matched_r = set()
    # nltk iterates hypothesis in reverse and, among all synonyms present in
    # the leftover reference, takes the HIGHEST still-available position
    for i in range(len(hyp) - 1, -1, -1):
        hw = hyp[i][1]
        syns_h = {
            lemma.name()
            for ss in wn.synsets(hw)
            for lemma in ss.lemmas()
            if lemma.name().find("_") < 0
        } | {hw}
        best_j = -1
        best_word = None
        for syn in syns_h:
            positions = ref_positions.get(syn)
            if positions and positions[-1] > best_j:
                best_j = positions[-1]
                best_word = syn
        if best_word is not None:
            ref_positions[best_word].pop()
            matched_h.add(i)
            matched_r.add(best_j)
            matches.append((hyp[i][0], ref[best_j][0]))
    rem_hyp = [p for i, p in enumerate(hyp) if i not in matched_h]
    rem_ref = [p for j, p in enumerate(ref) if j not in matched_r]
    return matches, rem_hyp, rem_ref


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    matches = sorted(matches)
    chunks = 0
    prev = None
    for h, r in matches:
        if prev is None or h != prev[0] + 1 or r != prev[1] + 1:
            chunks += 1
        prev = (h, r)
    return chunks


def single_meteor_score(
    reference: List[str],
    hypothesis: List[str],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    wordnet=None,
) -> float:
    """nltk argument order: (reference_tokens, hypothesis_tokens).

    ``wordnet``: optional synonym backend (nltk corpus duck type); defaults
    to the nltk wordnet corpus when installed, else the stage is skipped."""
    ref = [(i, w.lower()) for i, w in enumerate(reference)]
    hyp = [(i, w.lower()) for i, w in enumerate(hypothesis)]
    len_h, len_r = len(hyp), len(ref)
    m_exact, hyp, ref = _match_stage(hyp, ref, lambda w: w)
    if _STEMMER is not None:
        # nltk quirk kept for parity: `_enum_stem_match` stems the lists and
        # returns the STEMMED leftovers, so the wordnet stage downstream
        # looks synonyms up on porter stems, not original surface forms
        hyp = [(i, _STEMMER.stem(w)) for i, w in hyp]
        ref = [(i, _STEMMER.stem(w)) for i, w in ref]
        m_stem, hyp, ref = _match_stage(hyp, ref, lambda w: w)
    else:
        m_stem = []
    if wordnet is not None or _HAS_WORDNET:
        m_wn, hyp, ref = _wordnet_match(hyp, ref, wordnet=wordnet)
    else:
        m_wn = []
    matches = m_exact + m_stem + m_wn
    m = len(matches)
    if m == 0 or len_h == 0 or len_r == 0:
        return 0.0
    precision = m / len_h
    recall = m / len_r
    fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
    chunks = _count_chunks(matches)
    frag = chunks / m
    penalty = gamma * frag**beta
    return fmean * (1.0 - penalty)


def meteor_battery(preds: List[str], refs: List[str]) -> Dict[str, float]:
    """Mean single_meteor_score (reference `metrics/meteor.py`)."""
    import numpy as np

    scores = [
        single_meteor_score(ref.split(), pred.split())
        for pred, ref in zip(preds, refs)
    ]
    return {"meteor": float(np.mean(scores)) if scores else 0.0}


def stages() -> Dict[str, bool]:
    """The alignment stages this process runs: exact matches always, porter
    stems where nltk imports, wordnet synonyms where its corpus is
    installed."""
    return {"exact": True, "stem": _STEMMER is not None,
            "wordnet": _HAS_WORDNET}
