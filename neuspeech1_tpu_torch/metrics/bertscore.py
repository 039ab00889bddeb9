"""BERTScore from a local encoder checkpoint: the port's copy of
``neuspeech1_tpu/metrics/bertscore.py``.

The reference calls the `bert_score` package with lang='en' (downloads
roberta-large; `metrics/bert_score.py:8-15`) and vendors a Chinese fork
(`metrics/chinese_bert_score.py`). Zero-egress equivalent: greedy cosine
matching over contextual embeddings of ANY local HF encoder directory
(idf off), reported x100 like the reference. Baseline rescaling is the
fork's opt-in (`chinese_bert_score.py:325-342`): ``(s - b) / (1 - b)``
from a per-layer baseline TSV (`read_baseline_tsv`) or explicit values;
the metric battery leaves it off, as the reference's live path does.
`plot_example` is the fork's token-level similarity heatmap
(`chinese_bert_score.py:377-470`). Needs `transformers` (and matplotlib
for the plot), imported at the call, which the card's machine lacks: it
runs on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def read_baseline_tsv(path: str, num_layers: int
                      ) -> Tuple[float, float, float]:
    """(P, R, F) baselines for ``num_layers`` from a bert_score-format TSV
    (header ``LAYER,P,R,F``; row index = layer: the fork reads it with
    ``pd.read_csv(...).iloc[num_layers]``, `chinese_bert_score.py:330-334`)."""
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    vals = rows[1 + num_layers]  # the header, then layers from 0
    return float(vals[1]), float(vals[2]), float(vals[3])


def _rescale(x: float, b: float) -> float:
    return (x - b) / (1.0 - b)


def _load(model_dir: str, device: str):
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    model = AutoModel.from_pretrained(model_dir, local_files_only=True)
    return tok, model.eval().to(device)


def _baseline(model, num_layers: Optional[int],
              rescale_baseline: Optional[Sequence[float]],
              baseline_path: Optional[str]):
    """The (P, R, F) baseline triple: ``rescale_baseline``, or the TSV's
    row of the layer the embeddings come from (``num_layers``, else the
    model's last: its ``last_hidden_state`` is that layer's output, not
    row 0's embedding layer)."""
    if baseline_path is None:
        return rescale_baseline
    if rescale_baseline is not None:
        raise ValueError("pass one baseline source")
    return read_baseline_tsv(
        baseline_path, model.config.num_hidden_layers if num_layers is None
        else num_layers)


def _hidden(model, enc, num_layers: Optional[int]):
    if num_layers is None:
        return model(**enc).last_hidden_state
    return model(**enc, output_hidden_states=True).hidden_states[num_layers]


def bert_score(
    preds: List[str],
    refs: List[str],
    model_dir: str,
    num_layers: Optional[int] = None,
    batch_size: int = 16,
    device: str = "cpu",
    rescale_baseline: Optional[Sequence[float]] = None,
    baseline_path: Optional[str] = None,
) -> Dict[str, float]:
    """Precision, recall and F1 x100. ``num_layers``: the hidden layer to
    embed with (default the last); ``rescale_baseline``: an optional (P,
    R, F) baseline triple applied per sentence as ``(s - b) / (1 - b)``
    before averaging (the fork's rescale_with_baseline); ``baseline_path``:
    the triple from a bert_score-format TSV instead (one or the other)."""
    import numpy as np
    import torch

    tok, model = _load(model_dir, device)
    rescale_baseline = _baseline(model, num_layers, rescale_baseline,
                                 baseline_path)

    def embed(texts):
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = texts[i : i + batch_size]
            enc = tok(
                chunk, return_tensors="pt", padding=True, truncation=True,
                max_length=512,
            ).to(device)
            with torch.no_grad():
                hs = _hidden(model, enc, num_layers)
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
        f = 2 * p * r / (p + r) if p + r else 0.0
        if rescale_baseline is not None:
            # the fork's order: each sentence's components rescaled with
            # their own baselines before averaging; F rescaled, not
            # recomputed
            bp, br, bf = rescale_baseline
            p, r, f = _rescale(p, bp), _rescale(r, br), _rescale(f, bf)
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return {
        "bert_score_precision": float(np.mean(ps)) * 100.0,
        "bert_score_recall": float(np.mean(rs)) * 100.0,
        "bert_score_f1": float(np.mean(fs)) * 100.0,
    }


def plot_example(
    candidate: str,
    reference: str,
    model_dir: str,
    fname: str,
    num_layers: Optional[int] = None,
    rescale_baseline: Optional[Sequence[float]] = None,
    baseline_path: Optional[str] = None,
    device: str = "cpu",
) -> str:
    """The token-level similarity heatmap of one (candidate, reference)
    pair, the fork's `plot_example` (`chinese_bert_score.py:377-470`): the
    cosine matrix over contextual embeddings with the special tokens
    left out, rescaled by F's baseline where one is given, drawn in Blues
    on [0, 1] with each cell's value. Saves it to ``fname`` and returns
    ``fname``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    tok, model = _load(model_dir, device)
    special = set(tok.all_special_ids)

    def embed_tokens(text):
        enc = tok(text, return_tensors="pt").to(device)
        with torch.no_grad():
            hs = _hidden(model, enc, num_layers)[0]
        hs = torch.nn.functional.normalize(hs, dim=-1)
        ids = enc["input_ids"][0].tolist()
        # the special tokens by id (the fork cuts the first and last row)
        keep = [i for i, t in enumerate(ids) if t not in special]
        return hs[keep], [tok.decode([ids[i]]) for i in keep]

    eh, h_tokens = embed_tokens(candidate)
    er, r_tokens = embed_tokens(reference)
    sim = (eh @ er.T).cpu().numpy()
    baseline = _baseline(model, num_layers, rescale_baseline, baseline_path)
    if baseline is not None:
        bf = float(baseline[2])  # the fork rescales the matrix by F's
        sim = (sim - bf) / (1.0 - bf)

    fig, ax = plt.subplots(
        figsize=(max(len(r_tokens), 2), max(len(h_tokens), 2)))
    im = ax.imshow(sim, cmap="Blues", vmin=0, vmax=1)
    ax.set_xticks(range(len(r_tokens)))
    ax.set_yticks(range(len(h_tokens)))
    ax.set_xticklabels(r_tokens, fontsize=10, rotation=45, ha="right")
    ax.set_yticklabels(h_tokens, fontsize=10)
    ax.set_xlabel("reference", fontsize=12)
    ax.set_ylabel("candidate", fontsize=12)
    for i in range(len(h_tokens)):
        for j in range(len(r_tokens)):
            ax.text(j, i, f"{sim[i, j]:.3f}", ha="center", va="center",
                    color="k" if sim[i, j] < 0.5 else "w", fontsize=8)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return fname
