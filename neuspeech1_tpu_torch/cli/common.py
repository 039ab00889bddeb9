"""Model loading, saving and feature upload for the PyTorch port: the torch
side of ``neuspeech1_tpu/cli/common.py``. The port imports nothing of the
JAX package: the pieces it needs are repeated here and in the port's own
``config``, ``utils/tokenizer`` and ``models/convert``.

A full-model directory holds ``params.npz`` (the JAX tree, ``/``-joined
names) and ``config.json`` (``{"config": {...WhisperConfig fields...},
"stem": {...}}``); both packages read and write the same format. So do
adapter files: the trainable partition as npz, ``{"lora": tree, "model":
overrides}`` in the JAX package's stacked [L, ...] layout.

Base models (``load_base_params``): an ``.npz`` tree, a directory with HF
torch weights (``model.safetensors`` / ``pytorch_model.bin``, local files
only) or ``params.npz``, or ``'random'``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuspeech1_tpu_torch.config import (WHISPER_PRESETS, StemConfig,
                                         WhisperConfig, preset_config)
from neuspeech1_tpu_torch.models.convert import (
    load_npz, lora_from_params, module_from_params, params_from_hf_state_dict,
    save_npz)
from neuspeech1_tpu_torch.models.init import init_params, init_stem
from neuspeech1_tpu_torch.models.lora import merge_lora
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


def load_base_params(base_model: str, config: WhisperConfig,
                     stem: StemConfig, seed: int = 0):
    """A ``--base_model`` argument as a parameter tree.

    A stock (speech) whisper checkpoint loaded for an EEG stem gets the
    reference's stem swap (`finetune.py:143-148`): the transformer body and
    conv2 are ported, the projection stem is drawn fresh for the requested
    channel count. ``'random'`` and the swapped stem draw from the port's
    own `models/init.py` (a ``torch.Generator``), so for the same seed their
    weights differ from the JAX package's ``jax.random`` draws; runs that
    compare the two packages hand both the same npz."""
    if base_model == "random":
        return init_params(config, stem, seed)
    if base_model.endswith(".npz"):
        return load_npz(base_model)
    if os.path.isdir(base_model):
        for name in ("model.safetensors", "pytorch_model.bin"):
            path = os.path.join(base_model, name)
            if os.path.exists(path):
                sd = _load_torch_state_dict(path)
                try:
                    return params_from_hf_state_dict(sd, config, stem)
                except KeyError:
                    if stem.kind == "speech":
                        raise
                    params = params_from_hf_state_dict(
                        sd, config, StemConfig("speech"))
                    params["encoder"]["stem"] = init_stem(config, stem, seed)
                    print(f"[load] stock whisper checkpoint: swapped in a "
                          f"fresh '{stem.kind}' stem "
                          f"({stem.in_channels} channels)")
                    return params
        npz = os.path.join(base_model, "params.npz")
        if os.path.exists(npz):
            return load_npz(npz)
    raise FileNotFoundError(f"cannot resolve base model: {base_model}")


def _load_torch_state_dict(path: str) -> Dict[str, Any]:
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_adapter(path: str, trainable) -> None:
    """Save the trainable partition (lora + stem/conv2 overrides) as npz."""
    save_npz(path, trainable)


def load_adapter(path: str) -> Dict[str, Any]:
    """-> {"model": {...overrides...}, "lora": {...}} (trees may be
    partial)."""
    return load_npz(path)


def apply_adapter(params, adapter: Dict[str, Any]):
    """Overlay adapter['model'] onto params; return (params, lora)."""
    overrides = adapter.get("model") or {}
    lora = adapter.get("lora") or None

    def overlay(dst, src):
        out = dict(dst)
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                out[k] = overlay(dst[k], v)
            else:
                out[k] = v
        return out

    return overlay(params, overrides), lora


def parse_config_overrides(args) -> WhisperConfig:
    """The model config from CLI args: whisper-base defaults (the
    byte-tokenizer layout with ``--tokenizer=byte``), a ``--model_size``
    preset, geometry overrides and ``--bf16``."""
    kw = (dict(WhisperConfig.layout_for_vocab(256))
          if getattr(args, "tokenizer", None) == "byte" else {})
    size = getattr(args, "model_size", None)
    if size:
        # the layout wins over the preset's vocab for byte-tokenizer runs
        for k, v in WHISPER_PRESETS[size].items():
            kw.setdefault(k, v)
    for name in ("d_model", "encoder_layers", "decoder_layers",
                 "encoder_heads", "decoder_heads", "encoder_ffn",
                 "decoder_ffn", "max_source_positions",
                 "max_target_positions"):
        v = getattr(args, name, None)
        if v is not None:
            kw[name] = v
    kw["dtype"] = "bfloat16" if getattr(args, "bf16", True) else "float32"
    r = getattr(args, "remat", True)
    if isinstance(r, str):
        from neuspeech1_tpu_torch.utils.args import strtobool

        # 'auto' resolves once the corpus size is known; True is the
        # memory-safe provisional value
        r = True if r.lower() == "auto" else strtobool(r)
    kw["remat"] = bool(r)
    return WhisperConfig(**kw)


def commit_params(params, config: WhisperConfig, stem: StemConfig,
                  device, lora=None) -> Whisper:
    """The model on ``device`` in ``config.dtype``, moved there once.
    ``lora``, an adapter tree in the JAX package's layout (LoRA or
    AdaLoRA), is merged first: W + s A (E) B on the f32 weights on the
    host, then one cast to the compute dtype, as the JAX package's
    ``merge_lora`` on the f32 tree before the encoder's cast."""
    if not lora:
        return module_from_params(params, config, stem, device=device)
    model = module_from_params(params, config, stem, device="cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        for name, w in merge_lora(
                model, lora_from_params(lora, device="cpu")).items():
            model.get_parameter(name).copy_(w)
    return model.to(device=device, dtype=getattr(torch, config.dtype))


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
