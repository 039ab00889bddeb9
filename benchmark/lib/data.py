"""Seeded inputs: the clips and labels of a traffic mix.

Every seed gets the same multiset of clip lengths and label lengths, in an
order of its own, so that the seed changes which clip carries which length
and never the amount of work. Clips are [channels, samples] signals, N(0, 1)
for their length and zero after it (the zero tail of a clip shorter than
30 s). Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib.weights import _generator

LABEL_IGNORE_ID = -100


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def _spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over [lo, hi]."""
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def clip_lengths(traffic: dict, n: int, seed: int) -> np.ndarray:
    """Samples of each of ``n`` clips: the mix's seconds range spread
    evenly, permuted by ``seed``."""
    lo, hi = (int(round(s * traffic["sample_rate"]))
              for s in traffic["clip_seconds"])
    return rng(seed, 11).permutation(
        _spread(lo, hi, n))


def _signals(config: dict, lengths: np.ndarray, seed: int, device,
             dtype) -> torch.Tensor:
    """[n, ch, max(lengths)] N(0, 1) signals from ``seed`` on ``device``,
    zero past each clip's length."""
    n, ch = len(lengths), config["stem"]["in_channels"]
    t = int(lengths.max())
    x = torch.randn((n, ch, t), generator=_generator(seed, 3, device),
                    device=device, dtype=dtype)
    keep = (torch.arange(t, device=device)[None, :]
            < torch.as_tensor(lengths, device=device)[:, None])
    return x.mul_(keep[:, None, :])


def train_pool(config: dict, traffic: dict, seed: int, device):
    """(features bf16 [n, ch, S], labels [n, L], decoder inputs [n, L]) of
    the mix's pool on ``device``: labels are language, transcribe,
    notimestamps, text ids below eot and eot, ``real_tokens`` long, then
    -100; decoder inputs are sot followed by the labels, -100 read as eot
    (the fine-tune CLI's collator)."""
    m = config["model"]
    n, s, width = traffic["pool_clips"], config["signal_samples"], \
        traffic["label_len"]
    lengths = clip_lengths(traffic, n, seed)
    feats = torch.zeros((n, config["stem"]["in_channels"], s),
                        device=device, dtype=torch.bfloat16)
    feats[..., :int(lengths.max())] = _signals(config, lengths, seed, device,
                                               torch.bfloat16)
    draw = rng(seed, 12)
    real = draw.permutation(_spread(*traffic["real_tokens"], n))
    labels = np.full((n, width), LABEL_IGNORE_ID, dtype=np.int64)
    text = draw.integers(0, m["eot_id"], (n, width))
    for i, k in enumerate(real):
        labels[i, :k] = np.concatenate([
            [m["first_language_id"], m["transcribe_id"],
             m["notimestamps_id"]], text[i, :k - 4], [m["eot_id"]]])
    dec_in = np.full((n, width), m["eot_id"], dtype=np.int64)
    dec_in[:, 0] = m["sot_id"]
    dec_in[:, 1:] = np.where(labels[:, :-1] == LABEL_IGNORE_ID, m["eot_id"],
                             labels[:, :-1])
    return (feats, torch.as_tensor(labels, device=device),
            torch.as_tensor(dec_in, device=device))


def train_order(traffic: dict, seed: int, epoch: int, device
                ) -> torch.Tensor:
    """The pool's permutation for ``epoch``, drawn on ``device``."""
    gen = _generator(seed, 100 + epoch, device)
    return torch.randperm(traffic["pool_clips"], generator=gen, device=device)


def decode_pool(config: dict, traffic: dict, seed: int, device
                ) -> np.ndarray:
    """The mix's host pool: f32 numpy [n, ch, S] clips, drawn on
    ``device`` and copied to the host."""
    n, s = traffic["pool_clips"], config["signal_samples"]
    lengths = clip_lengths(traffic, n, seed)
    pool = np.zeros((n, config["stem"]["in_channels"], s), np.float32)
    t = int(lengths.max())
    pool[..., :t] = _signals(config, lengths, seed, device,
                             torch.float32).cpu().numpy()
    return pool


def prompt_ids(config: dict) -> list:
    """<|sot|><|en|><|transcribe|><|notimestamps|>."""
    m = config["model"]
    return [m["sot_id"], m["first_language_id"], m["transcribe_id"],
            m["notimestamps_id"]]
