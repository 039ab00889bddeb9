"""Weight bridge between the JAX parameter tree and the PyTorch modules.

The tree is the JAX package's (``neuspeech1_tpu/models/init.py``): nested
dicts with per-layer leaves stacked on a leading ``[L, ...]`` axis, linears
stored ``[in, out]`` (``{"w", "b"}``), convs ``[out, in, k]``, layer norms
``{"scale", "bias"}``, and the output projection tied to
``decoder.token_embed``. Module attribute names equal the tree's keys, so
the walk below is generic: ``nn.Linear`` weights are transposed to
``[out, in]``, an ``nn.ModuleList`` takes (or gives) the ``[L]`` axis.

``save_npz`` writes the ``/``-joined leaf names that ``load_npz`` (the
port's copy of the JAX package's reader) reads back into a tree.
``lora_from_params`` / ``params_from_lora`` do the same for adapter trees:
the JAX package stacks each entry's leaves on ``[L, ...]``, the port keeps a
list of per-layer entries (``models/lora.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig
from neuspeech1_tpu_torch.models.whisper import Whisper

Params = Dict[str, Any]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))  # a copy: leaves may be read-only


def _expect_keys(node: Params, keys, where: str) -> None:
    if set(node) != set(keys):
        raise KeyError(f"{where}: tree has {sorted(node)}, module needs "
                       f"{sorted(keys)}")


def _copy(dst: torch.Tensor, src, where: str) -> None:
    src = _as_tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {tuple(src.shape)}, module "
                         f"expects {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _fill(module: nn.Module, node, where: str) -> None:
    if isinstance(module, nn.Linear):
        keys = ("w", "b") if module.bias is not None else ("w",)
        _expect_keys(node, keys, where)
        _copy(module.weight, _as_tensor(node["w"]).T, where + "/w")
        if module.bias is not None:
            _copy(module.bias, node["b"], where + "/b")
    elif isinstance(module, nn.Conv1d):
        _expect_keys(node, ("w", "b"), where)
        _copy(module.weight, node["w"], where + "/w")
        _copy(module.bias, node["b"], where + "/b")
    elif isinstance(module, nn.LayerNorm):
        _expect_keys(node, ("scale", "bias"), where)
        _copy(module.weight, node["scale"], where + "/scale")
        _copy(module.bias, node["bias"], where + "/bias")
    elif isinstance(module, nn.Embedding):
        _copy(module.weight, node, where)
    elif isinstance(module, nn.ModuleList):
        for i, layer in enumerate(module):
            _fill(layer, _index(node, i), f"{where}[{i}]")
    else:
        children = dict(module.named_children())
        children.update(module.named_parameters(recurse=False))
        _expect_keys(node, children, where)
        for key, child in children.items():
            if isinstance(child, nn.Parameter):
                _copy(child, node[key], f"{where}/{key}")
            else:
                _fill(child, node[key], f"{where}/{key}")


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return _as_tensor(node)[i]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _tree(module: nn.Module):
    if isinstance(module, nn.Linear):
        out = {"w": _numpy(module.weight).T.copy()}
        if module.bias is not None:
            out["b"] = _numpy(module.bias)
        return out
    if isinstance(module, nn.Conv1d):
        return {"w": _numpy(module.weight), "b": _numpy(module.bias)}
    if isinstance(module, nn.LayerNorm):
        return {"scale": _numpy(module.weight), "bias": _numpy(module.bias)}
    if isinstance(module, nn.Embedding):
        return _numpy(module.weight)
    if isinstance(module, nn.ModuleList):
        return _stack([_tree(layer) for layer in module])
    out = {k: _numpy(p) for k, p in module.named_parameters(recurse=False)}
    out.update({k: _tree(c) for k, c in module.named_children()})
    return out


def module_from_params(tree: Params, config: WhisperConfig, stem: StemConfig,
                       device="cuda", dtype: Optional[torch.dtype] = None
                       ) -> Whisper:
    """A ``Whisper`` module holding the JAX tree's weights (numpy or torch
    leaves) on ``device`` in ``dtype`` (default: ``config.dtype``; pass
    ``torch.float32`` for a training model's f32 masters, which compute
    still casts to ``config.dtype``). Every parameter is frozen. Raises on
    any missing, extra or misshapen leaf."""
    model = Whisper(config, stem)
    _fill(model, tree, "params")
    dtype = dtype or getattr(torch, config.dtype)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def params_from_module(model: Whisper) -> Params:
    """The JAX-layout tree (float32 numpy leaves) of a ``Whisper`` module."""
    return _tree(model)


def load_npz(path: str) -> Params:
    """The tree of an npz written by ``save_npz`` (or by the JAX package):
    ``/``-joined entry names become nested dicts of numpy leaves."""
    data = np.load(path)
    tree: Params = {}
    for name in data.files:
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[name]
    return tree


def save_npz(path: str, params: Params) -> None:
    """Write a tree (numpy or torch leaves) as ``/``-joined npz entries."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = (_numpy(node) if isinstance(node, torch.Tensor)
                            else np.asarray(node))

    walk(params, "")
    np.savez(path, **flat)


def lora_from_params(tree: Params, device="cuda") -> Params:
    """The port's adapter tree from the JAX package's (leaves stacked on
    ``[L, ...]``, numpy or torch): per part, a list of per-layer entries of
    f32 tensors on ``device``, values copied exactly."""
    def split(node, n_layers):
        if isinstance(node, dict):
            parts = {k: split(v, n_layers) for k, v in node.items()}
            return [{k: v[i] for k, v in parts.items()}
                    for i in range(n_layers)]
        t = _as_tensor(node).to(device=device, dtype=torch.float32)
        return [t[i].contiguous() for i in range(n_layers)]

    out: Params = {}
    for part, sub in tree.items():
        leaf = sub["layers"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        out[part] = {"layers": split(sub["layers"], len(leaf))}
    return out


def params_from_lora(lora: Params) -> Params:
    """The JAX-layout adapter tree (float32 numpy leaves stacked on
    ``[L, ...]``) of a port adapter tree; the inverse of
    ``lora_from_params``."""
    return {part: {"layers": _stack([
        {k: _lora_numpy(v) for k, v in layer.items()}
        for layer in sub["layers"]])}
        for part, sub in lora.items()}


def _lora_numpy(node):
    if isinstance(node, dict):
        return {k: _lora_numpy(v) for k, v in node.items()}
    return _numpy(node)
