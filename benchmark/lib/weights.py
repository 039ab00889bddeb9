"""Seeded weights, drawn on the device in a few large calls.

`param_tree` gives the model's weights as the parameter tree the port
loads (``models/convert.py::module_from_params``): nested dicts, per-layer
leaves stacked on a leading [L] axis, linears [d_in, d_out], convs [out, in,
k], layer norms ``{"scale", "bias"}``, the output projection tied to
``decoder.token_embed``. `adapter_tree` gives the AdaLoRA adapters in the
port's layout: ``{"encoder": {"layers": [{"self_attn": {"q": entry, ...},
"fc1": entry, "fc2": entry}, ...]}}`` with an entry ``{"A": [d_in, r], "B":
[r, d_out], "E": [r, 1], "alpha": [1, 1], "mask": [r, 1]}`` (delta = x A
diag(E) B alpha / r).

Both come from a ``torch.Generator`` on ``device`` seeded from the run's
seed, so the same seed on the same device gives the same numbers: the
reference draws them again after the program has been freed. Imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ATTN = ("q", "k", "v", "out")


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one use of the run's seed: ``stream`` keeps the
    weights, the adapters and the data apart."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """Whisper's fixed sinusoidal position table [length, channels]."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([t.sin(), t.cos()], dim=1).float().to(device)


def _normals(shapes: List[Tuple[int, ...]], std: float,
             gen: torch.Generator, device) -> List[torch.Tensor]:
    """One N(0, std^2) draw split into tensors of ``shapes``."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * std
    return [part.view(shape) for part, shape
            in zip(flat.split(sizes), shapes)]


def param_tree(config: dict, seed: int, device) -> dict:
    """The model's f32 weights from ``seed`` on ``device``."""
    m = config["model"]
    d = m["d_model"]
    ne, nd = m["encoder_layers"], m["decoder_layers"]
    ch = config["stem"]["in_channels"]
    if config["stem"]["kind"] != "base":
        raise ValueError("the benchmark draws the 'base' EEG stem only")
    std = config["init_std"]
    # every N(0, std^2) leaf, in a fixed order
    spec = {
        ("encoder", "stem", "conv_a", "w"): (d, ch, 3),
        ("encoder", "stem", "conv_b", "w"): (d, d, 3),
        ("encoder", "conv2", "w"): (d, d, 3),
    }
    for part, n, ffn, attns in (("encoder", ne, m["encoder_ffn"],
                                 ("self_attn",)),
                                ("decoder", nd, m["decoder_ffn"],
                                 ("self_attn", "cross_attn"))):
        for a in attns:
            for p in ATTN:
                spec[(part, "layers", a, p, "w")] = (n, d, d)
        spec[(part, "layers", "fc1", "w")] = (n, d, ffn)
        spec[(part, "layers", "fc2", "w")] = (n, ffn, d)
    spec[("decoder", "token_embed")] = (m["vocab_size"], d)
    spec[("decoder", "pos_embed")] = (m["max_target_positions"], d)
    drawn = _normals(list(spec.values()), std, _generator(seed, 1, device),
                     device)
    tree: dict = {}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for path, value in zip(spec, drawn):
        put(path, value)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    put(("encoder", "stem", "conv_a", "b"), zeros(d))
    put(("encoder", "stem", "conv_b", "b"), zeros(d))
    put(("encoder", "conv2", "b"), zeros(d))
    put(("encoder", "pos_embed"),
        sinusoids(m["max_source_positions"], d, device))
    put(("encoder", "ln_post"), {"scale": ones(d), "bias": zeros(d)})
    put(("decoder", "ln"), {"scale": ones(d), "bias": zeros(d)})
    for part, n, ffn, attns, lns in (
            ("encoder", ne, m["encoder_ffn"], ("self_attn",),
             ("self_attn_ln", "final_ln")),
            ("decoder", nd, m["decoder_ffn"], ("self_attn", "cross_attn"),
             ("self_attn_ln", "cross_attn_ln", "final_ln"))):
        for a in attns:
            for p in ("q", "v", "out"):
                put((part, "layers", a, p, "b"), zeros(n, d))
        put((part, "layers", "fc1", "b"), zeros(n, ffn))
        put((part, "layers", "fc2", "b"), zeros(n, d))
        for ln in lns:
            put((part, "layers", ln), {"scale": ones(n, d),
                                       "bias": zeros(n, d)})
    return tree


def _entry_dims(d: int, ffn: int, target: str) -> Tuple[int, int]:
    if target in ATTN:
        return d, d
    return (d, ffn) if target == "fc1" else (ffn, d)


def adapter_tree(config: dict, seed: int, device) -> dict:
    """The AdaLoRA adapters from ``seed`` on ``device``: A, B and E ~
    N(0, std^2) (``adapters.init_std``, ``adapters.e_std``), alpha and a
    mask of ones; every leaf its own f32 tensor."""
    a = config["adapters"]
    m = config["model"]
    r = a["init_r"]
    tree = {}
    gen = _generator(seed, 2, device)
    for part in a["parts"]:
        n = m[f"{part}_layers"]
        ffn = m[f"{part}_ffn"]
        shapes = []
        for t in a["targets"]:
            d_in, d_out = _entry_dims(m["d_model"], ffn, t)
            shapes += [(n, d_in, r), (n, r, d_out)]
        ab = _normals(shapes, a["init_std"], gen, device)
        es = _normals([(n, r, 1)] * len(a["targets"]), a["e_std"], gen,
                      device)
        layers: List[Dict] = [{} for _ in range(n)]
        for j, t in enumerate(a["targets"]):
            for i, layer in enumerate(layers):
                entry = {"A": ab[2 * j][i].clone(), "B": ab[2 * j + 1][i].clone(),
                         "E": es[j][i].clone(),
                         "alpha": torch.full((1, 1), float(a["alpha"]),
                                             device=device),
                         "mask": torch.ones((r, 1), device=device)}
                dest = layer.setdefault("self_attn", {}) if t in ATTN else layer
                dest[t] = entry
        tree[part] = {"layers": layers}
    return tree
