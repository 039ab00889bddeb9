"""LM perplexity of predictions AND labels from a local causal LM. The
port's copy of ``neuspeech1_tpu/metrics/perplexity.py``.

The reference scores both streams with lmppl/GPT-2
(`metrics/perplexity.py:8-15`). Zero-egress equivalent: any local HF causal
LM directory. Gated with a clear error when absent.
"""

from __future__ import annotations

from typing import Dict, List


def lm_perplexity(texts: List[str], model_dir: str, device: str = "cpu") -> float:
    import math

    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(model_dir, local_files_only=True)
    model.eval().to(device)
    losses = []
    for t in texts:
        if not t.strip():
            continue
        ids = tok(t, return_tensors="pt").input_ids.to(device)
        if ids.shape[1] < 2:
            continue
        with torch.no_grad():
            out = model(ids, labels=ids)
        losses.append(float(out.loss))
    if not losses:
        return float("nan")
    import numpy as np

    return float(np.exp(np.mean(losses)))


def perplexity_battery(
    preds: List[str], refs: List[str], model_dir: str
) -> Dict[str, float]:
    return {
        "ppl_pred": lm_perplexity(preds, model_dir),
        "ppl_label": lm_perplexity(refs, model_dir),
    }
