"""The training step of the PyTorch port: the port of
``neuspeech1_tpu/train/trainstep.py`` for the path ``bench.py`` times.

One step: bf16 forward through the EEG-Whisper with LoRA adapters ->
masked cross entropy with its custom backward -> backward -> clip by global
norm -> AdamW on the trainable leaves. With ``fold_lora`` (the 'fc' regime
of the JAX package) the attention adapters are merged into f32 weights
W + s A B with autograd, and the fc adapters run through
``models/lora.py::folded_linear``, whose backward is the adapter-backward
kernel. Attention runs through the flash kernels (encoder self-attention,
decoder cross-attention) and their backward.

Under a config's ``seq_parallel_axis`` each rank of that axis's ring runs
the encoder's layer stack on its sequence shard (``models/whisper.py::
encoder_apply``), so the gradients of the leaves that stack reads (its
weights and their adapters, merged or folded) cover only its own tokens:
the step sums them over the ring before the norm and the update, and every
rank ends with the same gradients and parameters. Every other leaf is whole
on every rank already. Data parallelism (a mesh ``data`` axis larger than
1) is not ported and raises.

Not ported yet, and raising with a pointer to ROADMAP.md: augmentation,
dropout, int8 matmuls, the AdaLoRA orthogonality loss and importance
tracking, the 'merge' and 'linear' fold regimes, and remat.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.lora import (
    has_entries, merge_lora, split_lora_fc)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.train.optimizer import (
    AdamState, Optimizer, PathPred, default_trainable_pred, global_norm,
    named_leaves)

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]

_ROADMAP = "is not ported yet; ROADMAP.md queue 1 lists it"

# the leaves the encoder's layer stack reads: under sequence parallelism a
# rank's gradients for them cover its own tokens only
SEQ_SHARDED_PREFIXES = ("model/encoder/layers/", "lora/encoder/layers/")


class Frozen(NamedTuple):
    """The model and its adapter tree: every tensor of the step, trainable
    or not (the trainable ones are the same objects as in TrainState)."""

    model: tw.Whisper
    lora: Optional[Params]


@dataclasses.dataclass
class TrainState:
    """step count, trainable leaves by path, optimizer state, generator."""

    step: int
    trainable: Dict[str, torch.Tensor]
    opt_state: AdamState
    generator: torch.Generator


def init_train_state(model: tw.Whisper, lora: Optional[Params],
                     tx: Optimizer, pred: Optional[PathPred] = None,
                     seed: int = 2):
    """(state, frozen) for a model holding f32 masters and an adapter tree.
    Sets ``requires_grad`` on exactly the leaves ``pred`` selects (default:
    adapters, stem and conv2) and clears it everywhere else."""
    pred = pred or default_trainable_pred()
    leaves = named_leaves(model, lora)
    trainable = {p: t for p, t in leaves.items() if pred(p)}
    for path, t in leaves.items():
        t.requires_grad_(path in trainable)
    state = TrainState(step=0, trainable=trainable,
                       opt_state=tx.init(trainable),
                       generator=torch.Generator().manual_seed(seed))
    return state, Frozen(model, lora)


def make_loss_fn(config: WhisperConfig, stem: StemConfig,
                 orth_reg_weight: float = 0.0, fold_lora: bool = False,
                 int8_matmul: str = "off", fold_impl: str = "fc"
                 ) -> Callable[[Frozen, Batch], tuple]:
    """``loss_fn(frozen, batch) -> (loss, aux)``. With ``fold_lora`` the
    'fc' regime (attention adapters merged, fc adapters folded); without,
    the per-token delta path in every adapted linear.

    The model runs its own stem; ``stem`` must name the same kind. The JAX
    forward reads the stem's weights by ``stem.kind``, so another kind
    fails there, and the loss raises here too rather than run the model's.
    Its other fields are inert in this loss: ``in_channels`` is read by
    neither forward (the weights fix it), and ``dropout`` only under
    dropout, which the port refuses."""
    if orth_reg_weight > 0.0:
        raise NotImplementedError(f"the AdaLoRA orthogonality loss {_ROADMAP}")
    if int8_matmul != "off":
        raise NotImplementedError(f"int8 training matmuls {_ROADMAP}")
    if fold_impl != "fc":
        raise NotImplementedError(
            f"fold regime {fold_impl!r} is not ported: the port keeps the 'fc' "
            "regime (ROADMAP.md 'Not to port')")
    if config.remat:
        raise NotImplementedError(f"remat {_ROADMAP}")

    def loss_fn(frozen: Frozen, batch: Batch):
        model, lora = frozen
        if model.stem_config.kind != stem.kind:
            raise ValueError(
                f"stem kind {stem.kind!r} differs from the model's "
                f"{model.stem_config.kind!r}")
        if lora is not None and not has_entries(lora):
            lora = None
        feats, ids = batch["input_features"], batch["decoder_input_ids"]
        if fold_lora and lora is not None:
            merge_tree, fc_tree = split_lora_fc(lora)
            merged = merge_lora(model, merge_tree)
            fc = fc_tree if has_entries(fc_tree) else None
            with (tw.fold_at_linear() if fc is not None
                  else contextlib.nullcontext()):
                logits = torch.func.functional_call(
                    model, merged, (feats, ids), {"lora": fc})
        else:
            logits = tw.forward(model, feats, ids, lora)
        loss = tw.ce_loss(logits, batch["labels"])
        return loss, {"ce_loss": loss.detach(), "loss": loss.detach()}

    return loss_fn


def make_train_step(config: WhisperConfig, stem: StemConfig, tx: Optimizer,
                    orth_reg_weight: float = 0.0,
                    augment_config: Optional[dict] = None,
                    use_dropout: bool = False,
                    track_adalora_importance: bool = False,
                    fold_lora: bool = False, int8_matmul: str = "off"):
    """``step(state, frozen, batch) -> metrics``: one optimizer step on
    ``state`` (in place). Metrics are 0-d device tensors: ``loss``,
    ``ce_loss`` and ``grad_norm``, the pre-clip global norm of the
    trainable leaves' gradients (``optax.global_norm``)."""
    if augment_config:
        raise NotImplementedError(f"on-device augmentation {_ROADMAP}")
    if use_dropout:
        raise NotImplementedError(f"dropout {_ROADMAP}")
    if track_adalora_importance:
        raise NotImplementedError(f"AdaLoRA importance tracking {_ROADMAP}")
    loss_fn = make_loss_fn(config, stem, orth_reg_weight,
                           fold_lora=fold_lora, int8_matmul=int8_matmul)

    def step(state: TrainState, frozen: Frozen, batch: Batch):
        ring = _seq_ring(config)
        for t in state.trainable.values():
            t.grad = None
        loss, aux = loss_fn(frozen, batch)
        loss.backward()
        grads = {k: t.grad for k, t in state.trainable.items()
                 if t.grad is not None}
        if ring is not None:
            grads = sum_seq_sharded_grads(grads, ring)
        norm = global_norm(grads.values())
        tx.update(state.trainable, grads, state.opt_state, norm)
        state.step += 1
        return {**aux, "grad_norm": norm}

    return step


def _seq_ring(config: WhisperConfig):
    """The ring of ``config.seq_parallel_axis`` in the ambient mesh, or None
    without the axis; raises for a mesh ``data`` axis larger than 1."""
    mesh = pmesh.get_mesh()
    if mesh is not None and "data" in pmesh.axis_names(mesh) \
            and pmesh.axis_size("data", mesh) > 1:
        raise NotImplementedError(
            "data-parallel gradient averaging (a mesh 'data' axis > 1) is not "
            "ported yet; ROADMAP.md queue 1 item 8 lists it")
    if config.seq_parallel_axis is None:
        return None
    return pmesh.axis_ring(config.seq_parallel_axis)


def sum_seq_sharded_grads(grads: Dict[str, torch.Tensor], ring
                          ) -> Dict[str, torch.Tensor]:
    """``grads`` with every leaf under ``SEQ_SHARDED_PREFIXES`` summed over
    ``ring``: one collective per dtype over the leaves packed flat, the
    same sum on every rank."""
    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, g in grads.items():
        if k.startswith(SEQ_SHARDED_PREFIXES):
            by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = ring.all_reduce_sum(
            torch.cat([grads[k].reshape(-1) for k in keys]))
        for k, part in zip(keys, flat.split([grads[k].numel() for k in keys])):
            out[k] = part.view(grads[k].shape)
    return out


def make_eval_step(config: WhisperConfig, stem: StemConfig):
    """``eval_step(state, frozen, batch) -> {"loss", "n_tokens"}``: the
    teacher-forcing loss without gradients, on the delta path."""
    loss_fn = make_loss_fn(config, stem)

    @torch.no_grad()
    def eval_step(state: TrainState, frozen: Frozen, batch: Batch):
        del state
        _, aux = loss_fn(frozen, batch)
        return {"loss": aux["ce_loss"],
                "n_tokens": (batch["labels"] != -100).sum()}

    return eval_step
