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

``trainable_tree`` turns a training state into the JAX package's trainable
partition (what ``save_adapter`` writes), so that each package's
``merge_lora`` and eval CLI read the other's ``adapter_final.npz``;
``merge_params`` folds an adapter tree into a parameter tree (the JAX
package's ``merge_lora``), for ``--lora_model``, ``--export_full_model`` and
the merge CLI.
"""

from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuspeech1_tpu_torch.config import (WHISPER_PRESETS, StemConfig,
                                         WhisperConfig, preset_config)
from neuspeech1_tpu_torch.models.convert import (
    load_npz, lora_from_params, module_from_params, params_from_hf_state_dict,
    params_from_lora, params_from_module, save_npz)
from neuspeech1_tpu_torch.models.init import init_params, init_stem
from neuspeech1_tpu_torch.models.lora import merge_lora
from neuspeech1_tpu_torch.models.whisper import Whisper
from neuspeech1_tpu_torch.train.profiling import count, span, tracing
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


def trainable_tree(trainable: Dict[str, torch.Tensor], model: Whisper,
                   lora=None) -> Dict[str, Any]:
    """The trainable partition in the JAX package's layout (float32 numpy
    leaves, layers stacked on [L, ...], linears [in, out]): ``{"model":
    the trainable model leaves, "lora": the adapter tree}``, with the keys
    the JAX CLI saves for the same trainable set. ``trainable`` is a
    `train.trainstep.TrainState`'s, keyed by path."""
    wanted = {re.sub(r"/layers/\d+/", "/layers/", p)
              for p in trainable if p.startswith("model/")}

    def keep(node, prefix):
        if not isinstance(node, dict):
            return node if prefix in wanted else None
        out = {}
        for k, v in node.items():
            sub = keep(v, f"{prefix}/{k}")
            if sub is not None and (not isinstance(sub, dict) or sub):
                out[k] = sub
        return out

    tree: Dict[str, Any] = {}
    model_part = keep(params_from_module(model), "model") if wanted else {}
    if model_part:
        tree["model"] = model_part
    if lora and any(p.startswith("lora/") for p in trainable):
        tree["lora"] = params_from_lora(lora)
    return tree


def merge_params(params, lora, device="cpu"):
    """``params`` (numpy or torch leaves, the JAX layout) with ``lora``
    (the JAX package's stacked adapter tree, LoRA or AdaLoRA) folded in:
    W + A diag(E) B * alpha / r per adapted linear, in f32 on ``device``
    with the JAX package's ``merge_lora``'s order of operations; numpy
    float32 leaves come back for the adapted weights."""
    def t(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x, dtype=np.float32))
        return x.to(device=device, dtype=torch.float32)

    def fold(dst, src):
        out = dict(dst)
        for name, entry in src.items():
            if isinstance(entry, dict) and "A" in entry:
                a = t(entry["A"])
                if "E" in entry:
                    a = a * t(entry["E"]).transpose(1, 2)
                scale = t(entry["alpha"]) / a.shape[-1]
                delta = torch.matmul(a, t(entry["B"])) * scale
                out[name] = {**dst[name],
                             "w": (t(dst[name]["w"]) + delta).cpu().numpy()}
            elif isinstance(entry, dict):
                out[name] = fold(dst[name], entry)
        return out

    new = dict(params)
    for part, sub in lora.items():
        new[part] = {**params[part],
                     "layers": fold(params[part]["layers"], sub["layers"])}
    return new


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
    point is zeros the device can restore.

    Blocks are tested from the end as ``np.any`` tests them (-0.0 is zero,
    NaN is not): by an OR over the samples' bits, less a float's sign bit,
    which makes no temporary. Slabs of clips are scanned in threads, since
    numpy reduces integers without holding the interpreter's lock."""
    t = feats.shape[-1]
    block = max(1, t // n_blocks)
    # the blocks the scan may drop: n = t - k * block stays above block
    blocks = max(0, -(-t // block) - 1)
    size = feats.dtype.itemsize
    bits = feats.view(f"u{size}")
    mask = (1 << 8 * size) - 1
    if feats.dtype.kind == "f":
        mask >>= 1

    def first_nonzero(slab: np.ndarray) -> int:
        for k in range(blocks):
            tail = slab[..., t - (k + 1) * block:t - k * block]
            if np.bitwise_or.reduce(tail, axis=None) & mask:
                return k
        return blocks

    workers = min(len(bits), torch.get_num_threads())
    if workers < 2:
        return t - first_nonzero(bits) * block
    edges = np.linspace(0, len(bits), workers + 1).astype(int)
    with ThreadPoolExecutor(workers) as pool:
        k = min(pool.map(first_nonzero, [
            bits[a:b] for a, b in zip(edges[:-1], edges[1:])]))
    return t - k * block


class _Staging:
    """Pinned host buffers that CUDA uploads are cast into, one per
    (device, dtype), each grown to the largest upload seen and never
    shrunk, with the event recorded after the copy that last read it. The
    next write into a buffer waits on that event; the lock keeps threads
    apart while they write and enqueue."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: Dict[tuple, list] = {}

    def upload(self, src: torch.Tensor, dtype: torch.dtype,
               device: torch.device, length: int) -> torch.Tensor:
        """``src``, a [..., n] host tensor, cast to ``dtype`` in the buffer,
        copied to ``device`` asynchronously and zero-padded there to
        ``length``."""
        numel = src.numel()
        with self._lock:
            slot = self._slots.get((device, dtype))
            if slot is None:
                slot = self._slots[device, dtype] = [None, torch.cuda.Event()]
            buf, done = slot
            with span("upload/fence"):
                if not done.query():
                    count("upload.fence_waits", always=True)
                    done.synchronize()
            if buf is None or buf.numel() < numel:
                with span("upload/pin"):
                    buf = slot[0] = torch.empty(numel, dtype=dtype,
                                                pin_memory=True)
                count("upload.staging_allocs", always=True)
                count("upload.pinned_bytes", numel * dtype.itemsize)
            host = buf[:numel].view(src.shape)
            with span("upload/cast"):
                host.copy_(src)
            with span("upload/copy"):
                out = host.to(device, non_blocking=True)
                done.record(torch.cuda.current_stream(device))
                n = src.shape[-1]
                return F.pad(out, (0, length - n)) if n < length else out


_staging = _Staging()


def upload_features(feats: np.ndarray, dtype: torch.dtype, device,
                    compact: bool = True) -> torch.Tensor:
    """[B, ch, T] host features -> device tensor in ``dtype``.

    The zero tail is cropped before the copy and restored on the device
    (exact), and the cast to the model dtype happens on the host (the
    encoder's first step is that cast), from float32 as the JAX package
    casts. For a CUDA device the cast writes into a pinned staging buffer
    kept for the (device, dtype), the copy is asynchronous, and the next
    upload into that buffer waits for it. Spans ``upload/scan``,
    ``upload/cast``, ``upload/copy``, and on CUDA ``upload/fence`` and
    ``upload/pin`` (the buffer's growth); counters ``upload.h2d_bytes``
    and ``upload.pinned_bytes`` while tracing, ``upload.staging_allocs``
    and ``upload.fence_waits`` always (``train/profiling.py``)."""
    device = torch.device(device)
    t_full = feats.shape[-1]
    with span("upload/scan"):
        n = feature_true_len(feats) if compact else t_full
    src = np.asarray(feats[..., :n], dtype=np.float32)
    if tracing():
        count("upload.h2d_bytes", src.size * dtype.itemsize)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _staging.upload(torch.from_numpy(src), dtype, device, t_full)
    # a fresh tensor: a view of a reused buffer would change under the
    # caller at the next upload
    with span("upload/cast"):
        out = torch.from_numpy(np.ascontiguousarray(src)).to(dtype)
    with span("upload/copy"):
        return F.pad(out, (0, t_full - n)) if n < t_full else out


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
