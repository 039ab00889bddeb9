"""Symmetric int8 quantization: the port of
``neuspeech1_tpu/models/quantize.py``.

    q = clip(round(x / s), -127, 127),  s = max|x| / 127 per column

``torch.round`` rounds half to even, as ``jnp.round`` does. `quantize_int8`
serves the int8 decode cross cache (``models/whisper.py::init_cache(
int8_cross=True)``) and `quantize_params`, int8 weight-only quantization of
a parameter tree's stacked linears (``Transcriber(int8_weights=True)``
serves the dequantized round trip, as the JAX package does). The tree
functions take the numpy tree that ``cli/common.py::load_full_model``
returns (numpy or CPU tensor leaves), compute on the CPU and return numpy
leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

_QUANT_KEY = "w_int8"
_SCALE_KEY = "w_scale"


def _is_linear_weight(path: Tuple, leaf) -> bool:
    """A stacked [L, d_in, d_out] linear weight ``w`` outside the stem and
    conv2 (the convs, norms and embeddings stay dense)."""
    keys = [str(k) for k in path]
    if not keys or keys[-1] != "w":
        return False
    if any(k in ("stem", "conv2") for k in keys):
        return False
    return leaf.ndim == 3


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n, cols] -> (int8 values, f32 scales [..., 1, cols]): one scale
    per column over the second-to-last axis; an all-zero column gets scale
    1."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / 127.0).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * s in f32."""
    return q.float() * scale


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def quantize_params(params: Params) -> Params:
    """The tree with every eligible linear weight ``w`` replaced by
    ``w_int8`` (int8) and ``w_scale`` (f32 [L, 1, d_out])."""

    def walk(tree, path=()):
        if not isinstance(tree, dict):
            return tree
        if "w" in tree and _is_linear_weight(path + ("w",),
                                             np.asarray(tree["w"])):
            q, s = quantize_int8(_tensor(tree["w"]))
            out = {k: v for k, v in tree.items() if k != "w"}
            out[_QUANT_KEY] = q.numpy()
            out[_SCALE_KEY] = s.numpy()
            return out
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(params)


def dequantize_params(params: Params) -> Params:
    """The dense tree back: each ``w_int8``/``w_scale`` pair becomes ``w``
    = q * s in f32."""

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if _QUANT_KEY in tree:
            out = {k: v for k, v in tree.items()
                   if k not in (_QUANT_KEY, _SCALE_KEY)}
            out["w"] = dequantize_int8(_tensor(tree[_QUANT_KEY]),
                                       _tensor(tree[_SCALE_KEY])).numpy()
            return out
        return {k: walk(v) for k, v in tree.items()}

    return walk(params)


def quantization_error(params: Params) -> float:
    """The largest relative RMS error of a quantized linear's round trip,
    ||w - dq(q(w))|| / ||w|| over its elements (a sanity metric)."""
    worst = 0.0

    def walk(orig, q):
        nonlocal worst
        if not isinstance(orig, dict):
            return
        if "w" in orig and _QUANT_KEY in q:
            w = np.asarray(orig["w"], np.float32)
            wd = dequantize_int8(_tensor(q[_QUANT_KEY]),
                                 _tensor(q[_SCALE_KEY])).numpy()
            rms = float(np.sqrt(np.mean((w - wd) ** 2)))
            denom = float(np.sqrt(np.mean(w ** 2))) + 1e-12
            worst = max(worst, rms / denom)
            return
        for k in orig:
            if isinstance(orig[k], dict):
                walk(orig[k], q[k])

    walk(params, quantize_params(params))
    return worst
