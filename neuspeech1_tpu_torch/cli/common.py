"""Model loading, saving and feature upload for the PyTorch port: the torch
side of ``neuspeech1_tpu/cli/common.py``. The port imports nothing of the
JAX package: the pieces it needs are repeated here and in the port's own
``config``, ``utils/tokenizer`` and ``models/convert``.

A full-model directory holds ``params.npz`` (the JAX tree, ``/``-joined
names) and ``config.json`` (``{"config": {...WhisperConfig fields...},
"stem": {...}}``); both packages read and write the same format.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig, preset_config
from neuspeech1_tpu_torch.models.convert import (load_npz, module_from_params,
                                                 save_npz)
from neuspeech1_tpu_torch.models.whisper import Whisper
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer

# The WhisperConfig fields save_full_model writes (the JAX package's list).
_SAVED_CONFIG_KEYS = (
    "vocab_size", "num_mel_bins", "d_model", "encoder_layers",
    "decoder_layers", "encoder_heads", "decoder_heads", "encoder_ffn",
    "decoder_ffn", "max_source_positions", "max_target_positions", "eot_id",
    "sot_id", "first_language_id", "num_languages", "translate_id",
    "transcribe_id", "startoflm_id", "startofprev_id", "nocaptions_id",
    "notimestamps_id",
)


def preset_model(size: str, stem_kind: str = "base",
                 in_channels: int = 208) -> Tuple[WhisperConfig, StemConfig]:
    """The config of a named Whisper size ('tiny'...'large', the JAX CLI's
    ``--model_size``) and a signal stem over ``in_channels``."""
    return preset_config(size), StemConfig(stem_kind, in_channels=in_channels)


def save_full_model(out_dir: str, params, config: WhisperConfig,
                    stem: StemConfig) -> str:
    """Write ``params.npz`` and ``config.json`` for a parameter tree."""
    os.makedirs(out_dir, exist_ok=True)
    save_npz(os.path.join(out_dir, "params.npz"), params)
    meta = {
        "config": {k: getattr(config, k) for k in _SAVED_CONFIG_KEYS},
        "stem": {"kind": stem.kind, "in_channels": stem.in_channels,
                 "dropout": stem.dropout},
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_full_model(model_dir: str) -> Tuple[Any, WhisperConfig, StemConfig]:
    """(numpy parameter tree, config, stem); any WhisperConfig field in
    ``config.json`` is honoured."""
    with open(os.path.join(model_dir, "config.json")) as f:
        meta = json.load(f)
    config = WhisperConfig(**meta["config"])
    stem = StemConfig(**meta["stem"])
    return load_npz(os.path.join(model_dir, "params.npz")), config, stem


def commit_params(params, config: WhisperConfig, stem: StemConfig,
                  device) -> Whisper:
    """The model on ``device`` in ``config.dtype``, moved there once."""
    return module_from_params(params, config, stem, device=device)


def feature_true_len(feats: np.ndarray, n_blocks: int = 8) -> int:
    """Block-aligned length past the last nonzero sample of a [B, ch, T]
    batch: a multiple of T / n_blocks in [T / n_blocks, T]. Clips are
    zero-padded to the model's input length, and everything past this
    point is zeros the device can restore."""
    t = feats.shape[-1]
    block = max(1, t // n_blocks)
    n = t
    while n > block and not np.any(feats[..., n - block:n]):
        n -= block
    return n


def upload_features(feats: np.ndarray, dtype: torch.dtype, device,
                    compact: bool = True) -> torch.Tensor:
    """[B, ch, T] host features -> device tensor in ``dtype``.

    The zero tail is cropped before the copy and restored on the device
    (exact), and the cast to the model dtype happens on the host (the
    encoder's first step is that cast). For a CUDA device the host buffer is
    pinned and the copy is asynchronous."""
    device = torch.device(device)
    t_full = feats.shape[-1]
    n = feature_true_len(feats) if compact else t_full
    host = torch.from_numpy(np.ascontiguousarray(feats[..., :n],
                                                 dtype=np.float32)).to(dtype)
    if device.type == "cuda":
        host = host.pin_memory()
    out = host.to(device, non_blocking=True)
    if n < t_full:
        out = F.pad(out, (0, t_full - n))
    return out


def resolve_tokenizer(spec: str, config: Optional[WhisperConfig] = None):
    return make_tokenizer(spec, config)


def suppress_kwargs(spec: str, tokenizer) -> Dict[str, Any]:
    """GenerationConfig kwargs for a ``suppress_tokens`` value: 'default'
    derives HF whisper's suppress / begin-suppress lists from the
    tokenizer's vocab, 'none' disables both, otherwise a comma-separated id
    list (begin-suppress stays empty)."""
    if spec == "default":
        return {
            "suppress_ids": tuple(tokenizer.default_suppress_ids()),
            "begin_suppress_ids": tuple(
                tokenizer.default_begin_suppress_ids()),
        }
    if spec in ("none", "", None):
        return {}
    return {"suppress_ids": tuple(int(x) for x in spec.split(","))}
