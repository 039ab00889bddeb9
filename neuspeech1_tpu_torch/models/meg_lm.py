"""The EEG tower before a decoder-only language model: NeuSpeech's EEG stem
and a Whisper encoder (with its adapters) whose frames, projected to the
language model's width, are a soft prefix before the transcript's tokens.
The brain-to-text design that puts a pretrained LLM in place of Whisper's
text decoder; the projector has Kimi-VL's MLP-projector shape.

    frames = encoder_apply(stem(features))            [B, 1500, d_tower]
    prefix = fc2(gelu(fc1(merge(ln(frames)))))        [B, 1500 / m, d_lm]
    logits = lm([prefix, embed([start, labels[:-1]])]) at the text positions

``merge`` puts ``merge_frames`` (m) consecutive frames side by side in one
row. Positions run over the prefix and the text; attention is causal over
all of them; the head runs at the text positions only, so the logits line
up with the labels as the Whisper model's do, and the same cross entropy
(``models/whisper.py::ce_loss``) takes them. Ids below 0 (the labels'
-100) read as ``pad_id``.

The tower and the projector hold f32 masters and compute in the tower's
dtype; the language model (``models/moe_lm.py``) is frozen and held in its
dtype. `check_model_config` is the training step's check that a config
matches the model it runs. Spans: ``model/encoder`` (the tower's),
``model/projector``, ``model/lm``.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuspeech1_tpu_torch.config import MegLMConfig
from neuspeech1_tpu_torch.models import moe_lm
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import _fill
from neuspeech1_tpu_torch.train.profiling import span


class Projector(nn.Module):
    def __init__(self, config: MegLMConfig):
        super().__init__()
        d, m, out = (config.tower.d_model, config.merge_frames,
                     config.lm.hidden_size)
        self.ln = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d * m, out)
        self.fc2 = nn.Linear(out, out)


class MegLM(nn.Module):
    """The whole model: ``encoder`` (the Whisper encoder with its stem, so
    the tower's leaves keep the Whisper model's paths), ``projector`` and
    ``lm``."""

    def __init__(self, config: MegLMConfig):
        super().__init__()
        self.config = config
        self.stem_config = config.stem
        self.encoder = tw.Encoder(config.tower, config.stem)
        self.projector = Projector(config)
        self.lm = moe_lm.MoELM(config.lm)

    @property
    def dtype(self) -> torch.dtype:
        """The tower's compute dtype."""
        return getattr(torch, self.config.tower.dtype)

    def forward(self, features, decoder_input_ids, lora=None, dropout=None):
        """``forward(self, ...)``: lets ``torch.func.functional_call`` run
        the model on substituted (merged) weights."""
        return forward(self, features, decoder_input_ids, lora, dropout)


def _tower(model: MegLM):
    """What ``models/whisper.py::encoder_apply`` reads of a model."""
    return types.SimpleNamespace(config=model.config.tower,
                                 stem_config=model.config.stem,
                                 encoder=model.encoder, dtype=model.dtype)


def project(p: Projector, frames, merge: int):
    """[B, T, d] tower frames -> [B, T / merge, d_lm]."""
    b, t, d = frames.shape
    x = tw.layer_norm(frames, p.ln).reshape(b, t // merge, d * merge)
    return tw.linear(tw.gelu(tw.linear(x, p.fc1)), p.fc2)


def forward(model: MegLM, features, decoder_input_ids, lora=None,
            dropout=None):
    """Logits [B, L, vocab] at the L text positions of ``decoder_input_ids``
    [B, L] after the tower's prefix of ``features`` [B, ch, T]; ``lora``
    and ``dropout`` as in ``models/whisper.py::encoder_apply``."""
    config = model.config
    frames = tw.encoder_apply(_tower(model), features, lora, dropout)
    with span("model/projector"):
        prefix = project(model.projector, frames, config.merge_frames)
    with span("model/lm"):
        lm = model.lm
        ids = torch.where(decoder_input_ids < 0, config.pad_id,
                          decoder_input_ids)
        tokens = F.embedding(ids, lm.embed_tokens.weight)
        h = torch.cat([prefix.to(tokens.dtype), tokens], dim=1)
        return moe_lm.lm_apply(lm, h, prefix.shape[1],
                               remat=torch.is_grad_enabled())


def check_model_config(config: MegLMConfig, model) -> None:
    """Raise ValueError where ``config`` is not the config ``model`` was
    built from (field by field)."""
    if not isinstance(model, MegLM):
        raise ValueError(f"a MegLMConfig runs a MegLM model, not "
                         f"{type(model).__name__}")
    diff = [f.name for f in dataclasses.fields(config)
            if getattr(config, f.name) != getattr(model.config, f.name)]
    if diff:
        raise ValueError("the step's config differs from the model's in "
                         + ", ".join(diff) + "; build the model from the "
                         "step's config")


def trainable_pred():
    """The trainable set: the adapters, the stem and conv2 (the Whisper
    recipe's) and the projector."""
    return lambda p: (p.startswith(("lora/", "model/encoder/stem/",
                                    "model/encoder/conv2/",
                                    "model/projector/")))


def module_from_weights(tower: Dict, projector: Dict,
                        lm: Dict[str, torch.Tensor], config: MegLMConfig,
                        device="cuda", dtype: Optional[torch.dtype] = None
                        ) -> MegLM:
    """A frozen ``MegLM`` on ``device``: the encoder from the Whisper
    parameter tree's ``encoder`` node ``tower`` (``models/convert.py``'s
    layout), the projector from ``projector`` (``{"ln": {"scale", "bias"},
    "fc1": {"w" [d_in, d_out], "b"}, "fc2": ...}``), both held in ``dtype``
    (default: the tower's compute dtype; ``torch.float32`` for a training
    model's masters), and the language model from its state dict ``lm``,
    whose tensors it takes as they are (no copy: held in their dtype)."""
    with torch.device("meta"):
        model = MegLM(config)
    dtype = dtype or model.dtype
    for name, node in (("encoder", tower), ("projector", projector)):
        part = getattr(model, name).to_empty(device=device)
        _fill(part, node, name)
        part.to(dtype)
    model.lm.load_state_dict(lm, strict=True, assign=True)
    return model.eval().requires_grad_(False)
