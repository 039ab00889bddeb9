"""Train-set sequence-bias construction for decoding. The port's copy of
``neuspeech1_tpu/decode/sequence_bias.py``.

Reference `utils/generation_helper.py:18-73` (GetSequenceBias): per unique
training sentence, extract YAKE keywords (lan=en, n<=3, dedupLim=0.9,
top=20) and/or all whitespace words, then bias each token sequence during
decoding (used at `evaluation.py:339-343,362-367` with bias=-1.0).

Keyword scoring is the native YAKE implementation in `decode/yake.py`
(full statistical pipeline — not a frequency heuristic).

extract_type semantics mirror the reference exactly:
  'word'        only single whitespace words
  'phrase'      only multi-word YAKE keywords (>=2 words)
  'phrase_word' YAKE keywords of any length + nothing else
(the reference's GetSequenceBias.get_bias_for_sentences)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from neuspeech1_tpu_torch.data.manifest import read_jsonlines
from neuspeech1_tpu_torch.decode.logits_process import SequenceBiasSpec
from neuspeech1_tpu_torch.decode.yake import YakeExtractor


def extract_phrases(
    sentences: List[str],
    cannot_be_single_word: bool = False,
    top: int = 20,
    max_ngram: int = 3,
    dedup_lim: float = 0.9,
) -> List[str]:
    """Per-sentence YAKE keywords over the unique sentences (reference
    `get_phrases_from_sentences`: iterates set(sentences), extracts top-20
    per sentence)."""
    extractor = YakeExtractor(max_ngram=max_ngram, top=top, dedup_lim=dedup_lim)
    phrases: List[str] = []
    for sentence in dict.fromkeys(sentences):  # unique, order-stable
        for kw, _score in extractor.extract_keywords(sentence):
            if cannot_be_single_word and len(kw.split()) == 1:
                continue
            phrases.append(kw)
    return phrases


def build_sequence_bias(
    manifest_path: str,
    tokenizer,
    bias: float = -1.0,
    extract_type: str = "phrase_word",
    top_keywords: int = 20,
    max_ngram: int = 3,
) -> Optional[SequenceBiasSpec]:
    """Returns a SequenceBiasSpec for `generate(..., bias_spec=...)`."""
    rows = read_jsonlines(manifest_path)
    sentences = [r.get("sentence", "") for r in rows if r.get("sentence")]

    phrases: List[str] = []
    if extract_type == "word":
        phrases = sorted({w for s in sentences for w in s.split()})
    elif extract_type == "phrase":
        phrases = extract_phrases(
            sentences, cannot_be_single_word=True,
            top=top_keywords, max_ngram=max_ngram,
        )
    elif extract_type == "phrase_word":
        phrases = extract_phrases(
            sentences, cannot_be_single_word=False,
            top=top_keywords, max_ngram=max_ngram,
        )
    else:
        raise NotImplementedError(extract_type)

    bias_map: Dict[Tuple[int, ...], float] = {}
    for phrase in dict.fromkeys(phrases):
        # the reference tokenizes with add_prefix_space=True; both surface
        # variants are biased so mid-sequence and sequence-initial matches
        # behave identically
        for variant in (phrase, " " + phrase):
            ids = tuple(tokenizer.encode(variant))
            if ids:
                bias_map[ids] = bias
    if not bias_map:
        return None
    return SequenceBiasSpec.build(bias_map)
