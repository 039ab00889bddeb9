"""Symmetric int8 quantization: the port's copy of ``quantize_int8`` from
``neuspeech1_tpu/models/quantize.py``, which the int8 decode cross cache
uses (``models/whisper.py::init_cache(int8_cross=True)``).

    q = clip(round(x / s), -127, 127),  s = max|x| / 127 per column

``torch.round`` rounds half to even, as ``jnp.round`` does. Int8 weights
(``quantize_params``) are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n, cols] -> (int8 values, f32 scales [..., 1, cols]): one scale
    per column over the second-to-last axis; an all-zero column gets scale
    1."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / 127.0).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale
