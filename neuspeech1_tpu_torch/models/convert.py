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
``params_from_hf_state_dict`` (the port's copy of the JAX package's) builds
the tree from an HF whisper state dict (torch tensors or numpy arrays), and
``params_to_hf_state_dict`` the state dict from the tree.
``lora_from_params`` / ``params_from_lora`` do the same for adapter trees:
the JAX package stacks each entry's leaves on ``[L, ...]``, the port keeps a
list of per-layer entries (``models/lora.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
    any missing, extra or misshapen leaf. The module is laid out on
    ``device`` without an initialization of its own: every leaf comes from
    ``tree``."""
    with torch.device("meta"):
        model = Whisper(config, stem)
    model = model.to_empty(device=device)
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


def _hf_get(sd: Mapping, name: str) -> np.ndarray:
    if name not in sd:
        raise KeyError(f"missing weight: {name}")
    x = sd[name]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _hf_linear(sd, pattern: str, n: int, bias: bool = True) -> Params:
    p = {"w": np.stack([_hf_get(sd, pattern.format(i) + ".weight").T
                        for i in range(n)])}
    if bias:
        p["b"] = np.stack([_hf_get(sd, pattern.format(i) + ".bias")
                           for i in range(n)])
    return p


def _hf_ln(sd, pattern: str, n: int) -> Params:
    return {key: np.stack([_hf_get(sd, f"{pattern.format(i)}.{hf}")
                           for i in range(n)])
            for key, hf in (("scale", "weight"), ("bias", "bias"))}


def _hf_attn(sd, prefix: str, n: int) -> Params:
    return {"q": _hf_linear(sd, prefix + ".q_proj", n),
            "k": _hf_linear(sd, prefix + ".k_proj", n, bias=False),
            "v": _hf_linear(sd, prefix + ".v_proj", n),
            "out": _hf_linear(sd, prefix + ".out_proj", n)}


def _hf_conv(sd, name: str) -> Params:
    return {"w": _hf_get(sd, name + ".weight"), "b": _hf_get(sd, name + ".bias")}


def _hf_stem(sd, stem: StemConfig) -> Params:
    """conv1's names follow the stem module: 'speech' and 'replace' ->
    model.encoder.conv1.*; 'base' -> a Sequential, conv1.0.* and conv1.2.*
    (gelu at index 1); 'premel' -> pre_conv1.* and the original conv1."""
    if stem.kind in ("speech", "replace"):
        key = "conv1" if stem.kind == "speech" else "conv"
        return {key: _hf_conv(sd, "model.encoder.conv1")}
    if stem.kind == "base":
        return {"conv_a": _hf_conv(sd, "model.encoder.conv1.0"),
                "conv_b": _hf_conv(sd, "model.encoder.conv1.2")}
    if stem.kind == "premel":
        return {"pre_conv": _hf_conv(sd, "pre_conv1"),
                "conv1": _hf_conv(sd, "model.encoder.conv1")}
    raise ValueError(stem.kind)


def params_from_hf_state_dict(sd: Mapping, config: WhisperConfig,
                              stem: StemConfig) -> Params:
    """The JAX-layout tree (numpy leaves) of an HF whisper state dict:
    linears transposed to [in, out], per-layer tensors stacked on [L],
    ``proj_out`` tied to the token embedding. Raises KeyError on a missing
    weight (a stock speech checkpoint has no EEG stem)."""
    ne, nd = config.encoder_layers, config.decoder_layers
    e, d = "model.encoder.layers.{}", "model.decoder.layers.{}"
    encoder = {
        "stem": _hf_stem(sd, stem),
        "conv2": _hf_conv(sd, "model.encoder.conv2"),
        "pos_embed": _hf_get(sd, "model.encoder.embed_positions.weight"),
        "layers": {
            "self_attn": _hf_attn(sd, e + ".self_attn", ne),
            "self_attn_ln": _hf_ln(sd, e + ".self_attn_layer_norm", ne),
            "fc1": _hf_linear(sd, e + ".fc1", ne),
            "fc2": _hf_linear(sd, e + ".fc2", ne),
            "final_ln": _hf_ln(sd, e + ".final_layer_norm", ne),
        },
        "ln_post": {"scale": _hf_get(sd, "model.encoder.layer_norm.weight"),
                    "bias": _hf_get(sd, "model.encoder.layer_norm.bias")},
    }
    decoder = {
        "token_embed": _hf_get(sd, "model.decoder.embed_tokens.weight"),
        "pos_embed": _hf_get(sd, "model.decoder.embed_positions.weight"),
        "layers": {
            "self_attn": _hf_attn(sd, d + ".self_attn", nd),
            "self_attn_ln": _hf_ln(sd, d + ".self_attn_layer_norm", nd),
            "cross_attn": _hf_attn(sd, d + ".encoder_attn", nd),
            "cross_attn_ln": _hf_ln(sd, d + ".encoder_attn_layer_norm", nd),
            "fc1": _hf_linear(sd, d + ".fc1", nd),
            "fc2": _hf_linear(sd, d + ".fc2", nd),
            "final_ln": _hf_ln(sd, d + ".final_layer_norm", nd),
        },
        "ln": {"scale": _hf_get(sd, "model.decoder.layer_norm.weight"),
               "bias": _hf_get(sd, "model.decoder.layer_norm.bias")},
    }
    return {"encoder": encoder, "decoder": decoder}


def params_to_hf_state_dict(params: Params, stem: StemConfig
                            ) -> Dict[str, np.ndarray]:
    """The HF ``WhisperForConditionalGeneration`` state dict (numpy arrays,
    the JAX package's names) of a JAX-layout tree: the inverse of
    ``params_from_hf_state_dict``, for exporting merged full models. (The
    JAX function also takes the model config and reads nothing of it.)"""
    sd: Dict[str, np.ndarray] = {}

    def put(name, x):
        sd[name] = np.asarray(x)

    enc, dec = params["encoder"], params["decoder"]
    sp = enc["stem"]
    if stem.kind == "speech":
        put("model.encoder.conv1.weight", sp["conv1"]["w"])
        put("model.encoder.conv1.bias", sp["conv1"]["b"])
    elif stem.kind == "base":
        put("model.encoder.conv1.0.weight", sp["conv_a"]["w"])
        put("model.encoder.conv1.0.bias", sp["conv_a"]["b"])
        put("model.encoder.conv1.2.weight", sp["conv_b"]["w"])
        put("model.encoder.conv1.2.bias", sp["conv_b"]["b"])
    elif stem.kind == "premel":
        put("pre_conv1.weight", sp["pre_conv"]["w"])
        put("pre_conv1.bias", sp["pre_conv"]["b"])
        put("model.encoder.conv1.weight", sp["conv1"]["w"])
        put("model.encoder.conv1.bias", sp["conv1"]["b"])
    else:
        put("model.encoder.conv1.weight", sp["conv"]["w"])
        put("model.encoder.conv1.bias", sp["conv"]["b"])
    put("model.encoder.conv2.weight", enc["conv2"]["w"])
    put("model.encoder.conv2.bias", enc["conv2"]["b"])
    put("model.encoder.embed_positions.weight", enc["pos_embed"])
    put("model.encoder.layer_norm.weight", enc["ln_post"]["scale"])
    put("model.encoder.layer_norm.bias", enc["ln_post"]["bias"])

    def unstack(part, prefix, attn_names):
        L = part["self_attn"]["q"]["w"].shape[0]
        for i in range(L):
            for hf_attn, ours in attn_names:
                blk = part[ours]
                for hf_p, op in (
                    ("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out")
                ):
                    put(f"{prefix}.{i}.{hf_attn}.{hf_p}.weight", blk[op]["w"][i].T)
                    if "b" in blk[op]:
                        put(f"{prefix}.{i}.{hf_attn}.{hf_p}.bias", blk[op]["b"][i])
            ln_names = [("self_attn_layer_norm", "self_attn_ln"),
                        ("final_layer_norm", "final_ln")]
            if ("encoder_attn", "cross_attn") in attn_names:
                ln_names.insert(1, ("encoder_attn_layer_norm", "cross_attn_ln"))
            for hf_ln, ours_ln in ln_names:
                put(f"{prefix}.{i}.{hf_ln}.weight", part[ours_ln]["scale"][i])
                put(f"{prefix}.{i}.{hf_ln}.bias", part[ours_ln]["bias"][i])
            for fc in ("fc1", "fc2"):
                put(f"{prefix}.{i}.{fc}.weight", part[fc]["w"][i].T)
                put(f"{prefix}.{i}.{fc}.bias", part[fc]["b"][i])

    unstack(enc["layers"], "model.encoder.layers", [("self_attn", "self_attn")])
    unstack(
        dec["layers"],
        "model.decoder.layers",
        [("self_attn", "self_attn"), ("encoder_attn", "cross_attn")],
    )
    put("model.decoder.embed_tokens.weight", dec["token_embed"])
    put("model.decoder.embed_positions.weight", dec["pos_embed"])
    put("model.decoder.layer_norm.weight", dec["ln"]["scale"])
    put("model.decoder.layer_norm.bias", dec["ln"]["bias"])
    put("proj_out.weight", dec["token_embed"])  # tied
    return sd


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
