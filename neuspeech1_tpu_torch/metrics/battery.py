"""The combined metric battery + result-file formats. The port's copy of
``neuspeech1_tpu/metrics/battery.py``.

The reference loads eight `evaluate` metric scripts and merges their dicts
(`evaluation.py:130-139,443-458`), writing `.txt` pred/label dumps, `.jsonl`
pairs and a `.json` metrics dict. `compute_battery` reproduces the merged
dict; `write_results` reproduces the files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from neuspeech1_tpu_torch.metrics.bleu import bleu_battery
from neuspeech1_tpu_torch.metrics.edit import cer, word_measures
from neuspeech1_tpu_torch.metrics.meteor import meteor_battery, single_meteor_score
from neuspeech1_tpu_torch.metrics.rouge import rouge_battery, rouge_pair
from neuspeech1_tpu_torch.metrics.bleu import corpus_bleu


def compute_battery(
    preds: List[str],
    refs: List[str],
    include_cer: bool = True,
    bertscore_model: Optional[str] = None,
    perplexity_model: Optional[str] = None,
) -> Dict[str, float]:
    """WER/MER/WIL/WIP + BLEU-1..4 + ROUGE + METEOR (+CER, +BERTScore/ppl
    when local models are provided) — the reference's default battery
    (`evaluation.py:132-134`)."""
    out: Dict[str, float] = {}
    out.update(word_measures(preds, refs))
    out.update(bleu_battery(preds, refs))
    out.update(rouge_battery(preds, refs))
    out.update(meteor_battery(preds, refs))
    if include_cer:
        out["cer"] = cer(preds, refs)
    if bertscore_model:
        from neuspeech1_tpu_torch.metrics.bertscore import bert_score

        out.update(bert_score(preds, refs, bertscore_model))
    if perplexity_model:
        from neuspeech1_tpu_torch.metrics.perplexity import perplexity_battery

        out.update(perplexity_battery(preds, refs, perplexity_model))
    return out


def per_sentence_metrics(preds: List[str], refs: List[str]) -> List[Dict[str, float]]:
    """Per-pair metric rows (reference `metrics/each_sentence_metrics.py`)."""
    rows = []
    for pred, ref in zip(preds, refs):
        row = {}
        row.update(word_measures([pred], [ref]))
        row["cer"] = cer([pred], [ref])
        row["bleu-1"] = corpus_bleu([pred], [[ref]], max_n=1)
        row["meteor"] = single_meteor_score(ref.split(), pred.split())
        row["rouge1_fmeasure"] = rouge_pair(pred, ref)["rouge1_fmeasure"]
        rows.append(row)
    return rows


def char_split_battery(preds: List[str], refs: List[str]) -> Dict[str, float]:
    """Character-split battery for CJK (reference `metrics/fulleval.py:63-116`
    space-joins characters before scoring)."""
    sp = [" ".join(p.replace(" ", "")) for p in preds]
    sr = [" ".join(r.replace(" ", "")) for r in refs]
    return compute_battery(sp, sr)


def write_results(
    out_prefix: str,
    preds: List[str],
    refs: List[str],
    metrics: Dict[str, float],
) -> Dict[str, str]:
    """Reference file outputs (`evaluation.py:337,440-458`):
    {prefix}.txt  — alternating label/pred dump
    {prefix}.jsonl — {"pred":..., "label":...} rows
    {prefix}.json — the metric dict."""
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    txt = out_prefix + ".txt"
    jsonl = out_prefix + ".jsonl"
    jsn = out_prefix + ".json"
    with open(txt, "w", encoding="utf-8") as f:
        for pred, ref in zip(preds, refs):
            f.write(f"start################################\n")
            f.write(f"label: {ref}\n")
            f.write(f"pred : {pred}\n")
    with open(jsonl, "w", encoding="utf-8") as f:
        for pred, ref in zip(preds, refs):
            f.write(json.dumps({"pred": pred, "label": ref}, ensure_ascii=False) + "\n")
    with open(jsn, "w", encoding="utf-8") as f:
        json.dump(
            {k: float(v) for k, v in metrics.items()}, f, ensure_ascii=False, indent=2
        )
    return {"txt": txt, "jsonl": jsonl, "json": jsn}


def random_choice_baseline(refs: List[str], seed: int = 0) -> List[str]:
    """Random-label control: each prediction is ANOTHER sample's reference
    (reference `evaluation.py:461-476` uses random.choice over other
    indices). A random shift of a random permutation guarantees pred[i] is
    never refs[i] itself."""
    n = len(refs)
    if n < 2:
        return list(refs)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shift = int(rng.integers(1, n))
    inv = np.empty(n, dtype=int)
    inv[perm] = np.arange(n)
    out_idx = perm[(inv + shift) % n]  # derangement of the identity
    return [refs[i] for i in out_idx]
