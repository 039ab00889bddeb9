"""BERTScore from a local encoder checkpoint. The port's copy of
``bert_score`` from ``neuspeech1_tpu/metrics/bertscore.py``, as the metric
battery calls it (last hidden layer, no baseline rescaling).

The reference calls the `bert_score` package with lang='en' (downloads
roberta-large; `metrics/bert_score.py:8-15`). Zero-egress equivalent: greedy
cosine matching over contextual embeddings of ANY local HF encoder
directory (idf off), reported x100 like the reference. Needs `transformers`
(imported at the call), which the card's machine lacks: it runs on the CPU.
"""

from __future__ import annotations

from typing import Dict, List


def bert_score(preds: List[str], refs: List[str], model_dir: str,
               batch_size: int = 16, device: str = "cpu") -> Dict[str, float]:
    import numpy as np
    import torch
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    model = AutoModel.from_pretrained(model_dir, local_files_only=True)
    model.eval().to(device)

    def embed(texts):
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = texts[i : i + batch_size]
            enc = tok(
                chunk, return_tensors="pt", padding=True, truncation=True,
                max_length=512,
            ).to(device)
            with torch.no_grad():
                hs = model(**enc).last_hidden_state
            hs = torch.nn.functional.normalize(hs, dim=-1)
            for j in range(len(chunk)):
                mask = enc["attention_mask"][j].bool()
                out.append(hs[j][mask])
        return out

    ps, rs, fs = [], [], []
    for ep, er in zip(embed(preds), embed(refs)):
        sim = ep @ er.T  # [Tp, Tr]
        p = sim.max(dim=1).values.mean().item()
        r = sim.max(dim=0).values.mean().item()
        ps.append(p)
        rs.append(r)
        fs.append(2 * p * r / (p + r) if p + r else 0.0)
    return {
        "bert_score_precision": float(np.mean(ps)) * 100.0,
        "bert_score_recall": float(np.mean(rs)) * 100.0,
        "bert_score_f1": float(np.mean(fs)) * 100.0,
    }
