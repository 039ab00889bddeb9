"""Native YAKE keyword extraction (Campos et al. 2020, Information Sciences).
The port's copy of ``neuspeech1_tpu/decode/yake.py``.

The reference biases decoding toward train-set keywords extracted with the
`yake` package (`utils/generation_helper.py:18-73`: lan='en', n=3,
dedupLim=0.9, top=20, per-sentence extraction). That package is not in this
image, so the algorithm is implemented natively here — the full statistical
pipeline, not a frequency fallback:

  term features   WCase, WPos, WFreq, WRel, WSpread  ->  S(t)
  candidate score S(kw) = prod / ((sum + 1) * TF(kw)), with interior
                  stopwords handled through bigram co-occurrence
                  probabilities (the published implementation's treatment)
  dedup           Levenshtein-similarity threshold on selected keywords

Scores are "lower is better" exactly like the package.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

# Compact English stopword list (union of common IR lists; the package ships
# ~575 entries — candidates may differ slightly at the margin for rare
# function words, which only affects which n-grams are *eligible*).
STOPWORDS_EN = frozenset(
    """a about above after again against all almost alone along already also
    although always am among an and another any anybody anyone anything are
    aren't around as at back be became because become becomes been before
    behind being below between both but by came can can't cannot could
    couldn't did didn't do does doesn't doing don't down during each either
    else enough even ever every everybody everyone everything far few find
    for from further get gets give go goes going got had hadn't has hasn't
    have haven't having he he'd he'll he's her here here's hers herself him
    himself his how how's however i i'd i'll i'm i've if in into is isn't it
    it's its itself just keep kind knew know last least less let let's like
    likely long made make many may me might mine more most much must mustn't
    my myself near need never new next no nobody none nor not nothing now of
    off often on once one only onto or other others ought our ours ourselves
    out over own part per perhaps put quite rather really said same saw say
    see seem seemed seeming seems several shall shan't she she'd she'll she's
    should shouldn't since so some somebody someone something sometimes
    somewhere still such take than that that's the their theirs them
    themselves then there there's these they they'd they'll they're they've
    thing things this those though through thus to too took toward under
    until up upon us use used uses very want wants was wasn't way we we'd
    we'll we're we've well went were weren't what what's when when's where
    where's whether which while who who's whom why why's will with within
    won't would wouldn't yes yet you you'd you'll you're you've your yours
    yourself yourselves""".split()
)

_TOKEN_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)*", re.UNICODE)
_SENT_SPLIT_RE = re.compile(r"[\n.!?;]+")


@dataclass
class _Term:
    """Per-unique-term statistics (lowercased surface form)."""

    tf: float = 0.0
    tf_upper: float = 0.0  # uppercase-initial occurrences, not sentence-first
    tf_acronym: float = 0.0
    sentences: Set[int] = field(default_factory=set)
    positions: List[int] = field(default_factory=list)  # sentence indices
    left: Counter = field(default_factory=Counter)  # co-occurring terms
    right: Counter = field(default_factory=Counter)
    stop: bool = False
    score: float = 0.0


def _tokenize_sentences(text: str) -> List[List[str]]:
    sents = []
    for chunk in _SENT_SPLIT_RE.split(text):
        toks = _TOKEN_RE.findall(chunk)
        if toks:
            sents.append(toks)
    return sents


class YakeExtractor:
    """YAKE with the package's defaults: n<=3, top 20, dedup 0.9."""

    def __init__(
        self,
        max_ngram: int = 3,
        top: int = 20,
        dedup_lim: float = 0.9,
        window: int = 1,
        stopwords: Optional[frozenset] = None,
    ):
        self.max_ngram = max_ngram
        self.top = top
        self.dedup_lim = dedup_lim
        self.window = window
        self.stopwords = STOPWORDS_EN if stopwords is None else stopwords

    # ------------------------------------------------------------------
    def extract_keywords(self, text: str) -> List[Tuple[str, float]]:
        """Returns [(keyword, score)] sorted ascending (lower = better)."""
        sents = _tokenize_sentences(text)
        if not sents:
            return []
        terms = self._build_terms(sents)
        self._score_terms(terms, n_sentences=len(sents))
        candidates = self._candidates(sents, terms)
        if not candidates:
            return []
        scored = sorted(candidates.items(), key=lambda kv: kv[1])
        return self._dedup(scored)

    # ------------------------------------------------------------------
    def _build_terms(self, sents: List[List[str]]) -> Dict[str, _Term]:
        terms: Dict[str, _Term] = defaultdict(_Term)
        for si, sent in enumerate(sents):
            for wi, tok in enumerate(sent):
                low = tok.lower()
                t = terms[low]
                t.tf += 1
                t.sentences.add(si)
                t.positions.append(si)
                t.stop = low in self.stopwords or len(low) < 2
                if tok.isupper() and len(tok) > 1:
                    t.tf_acronym += 1
                elif tok[0].isupper() and wi > 0:
                    t.tf_upper += 1
                # co-occurrence window over non-stopword neighbours
                for off in range(1, self.window + 1):
                    j = wi - off
                    if j >= 0:
                        prev = sent[j].lower()
                        t.left[prev] += 1
                        terms[prev].right[low] += 1
        return terms

    def _score_terms(self, terms: Dict[str, _Term], n_sentences: int) -> None:
        content_tfs = [t.tf for k, t in terms.items() if not t.stop]
        if not content_tfs:
            content_tfs = [t.tf for t in terms.values()]
        mean_tf = sum(content_tfs) / len(content_tfs)
        var = sum((x - mean_tf) ** 2 for x in content_tfs) / len(content_tfs)
        std_tf = math.sqrt(var)
        max_tf = max(t.tf for t in terms.values())

        for t in terms.values():
            w_case = max(t.tf_upper, t.tf_acronym) / (1.0 + math.log(t.tf))
            median_sent = sorted(t.positions)[len(t.positions) // 2]
            w_pos = math.log(math.log(3.0 + median_sent))
            w_freq = t.tf / (mean_tf + std_tf + 1e-12)
            dl = (len(t.left) / sum(t.left.values())) if t.left else 0.0
            dr = (len(t.right) / sum(t.right.values())) if t.right else 0.0
            w_rel = 1.0 + (dl + dr) * (t.tf / max_tf)
            w_spread = len(t.sentences) / n_sentences
            t.score = (w_rel * w_pos) / (
                w_case + (w_freq / w_rel) + (w_spread / w_rel)
            )

    def _candidates(
        self, sents: List[List[str]], terms: Dict[str, _Term]
    ) -> Dict[str, float]:
        """Enumerate n-grams (no start/end stopword, no digits), score with
        the package's prod/sum formula; interior stopwords contribute via
        bigram co-occurrence probability."""
        freqs: Counter = Counter()
        surface: Dict[str, Tuple[str, ...]] = {}
        for sent in sents:
            lows = [w.lower() for w in sent]
            for n in range(1, self.max_ngram + 1):
                for i in range(len(lows) - n + 1):
                    gram = tuple(lows[i : i + n])
                    if any(w.replace(",", "").isdigit() for w in gram):
                        continue
                    if terms[gram[0]].stop or terms[gram[-1]].stop:
                        continue
                    key = " ".join(gram)
                    freqs[key] += 1
                    surface[key] = gram

        out: Dict[str, float] = {}
        for key, tf_kw in freqs.items():
            gram = surface[key]
            prod, ssum = 1.0, 0.0
            for j, w in enumerate(gram):
                t = terms[w]
                if t.stop:
                    # interior stopword: bigram probability treatment
                    prev, nxt = gram[j - 1], gram[j + 1]
                    p1 = terms[prev].right.get(w, 0) / max(terms[prev].tf, 1)
                    p2 = t.right.get(nxt, 0) / max(t.tf, 1)
                    prob = p1 * p2
                    prod *= 1.0 + (1.0 - prob)
                    ssum -= 1.0 - prob
                else:
                    prod *= t.score
                    ssum += t.score
            out[key] = prod / (tf_kw * (1.0 + ssum))
        return out

    def _dedup(self, scored: List[Tuple[str, float]]) -> List[Tuple[str, float]]:
        from neuspeech1_tpu_torch.metrics.edit import edit_counts

        selected: List[Tuple[str, float]] = []
        for key, score in scored:
            dup = False
            for prev, _ in selected:
                _, s, d, i = edit_counts(list(prev), list(key))
                dist = s + d + i
                ratio = 1.0 - dist / max(len(key), len(prev), 1)
                if ratio >= self.dedup_lim:
                    dup = True
                    break
            if not dup:
                selected.append((key, score))
            if len(selected) >= self.top:
                break
        return selected
