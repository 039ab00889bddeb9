"""The training step of the PyTorch port: the port of
``neuspeech1_tpu/train/trainstep.py`` for the path ``bench.py`` times.

One step: on-device augmentation of the batch's signals (noise, mask,
taylor, SpecAugment; ``ops/augment.py``) -> bf16 forward through the
EEG-Whisper with LoRA or AdaLoRA adapters (with the stem's dropout, and
under ``int8_matmul`` int8 matmuls in every linear) -> masked cross entropy with its custom backward (+ AdaLoRA's
orthogonality loss over the whole adapter tree) -> backward -> clip by
global norm -> AdamW on the trainable leaves (-> AdaLoRA's importance EMAs
on the updated adapters and the raw gradients). With ``fold_lora`` (the 'fc' regime
of the JAX package) the attention adapters are merged into f32 weights
W + s A B with autograd, and the fc adapters run through
``models/lora.py::folded_linear``, whose backward is the adapter-backward
kernel. Attention runs through the flash kernels (encoder self-attention,
decoder cross-attention) and their backward. Under ``config.remat`` each
encoder layer runs under a checkpoint (``models/whisper.py``).

Under a config's ``seq_parallel_axis`` each rank of that axis's ring runs
the encoder's layer stack on its sequence shard (``models/whisper.py::
encoder_apply``), so the gradients of the leaves that stack reads (its
weights and their adapters, merged or folded) cover only its own tokens:
the step sums them over the ring before the norm and the update. Under its
``pipeline_axis`` each stage's layers take gradients on that stage alone:
the step sums the layer stacks' leaves over the pipeline ring.

Under a mesh ``data`` axis larger than 1 (data parallelism, as the JAX
package's GSPMD step on a batch sharded over ``data``) each rank holds its
block of the global batch's rows, and the step gives what one device gives
on the whole batch: the unmasked labels are counted over the data ring
before the forward, so that each rank's cross entropy is its token sum over
the global count; AdaLoRA's orthogonality loss enters the backward on data
rank 0 only; every gradient is then summed over the data ring. The norm,
the clip, the update and the importance EMAs run on the summed gradients,
which are the same bits on every rank, so every rank keeps the same
parameters, optimizer state and EMAs. The augmentation's and the dropout's
draws are taken for the global batch from the state's generator, and each
rank applies its rows: the generators stay in step. Every collective of
data parallelism runs between ``loss.backward()`` and the update, none
inside autograd's backward (the ranks of a ``LocalRing`` on one CUDA
device share one autograd worker thread).

Under mesh ``fsdp`` and ``tensor`` axes (FSDP and tensor parallelism, the
JAX package's GSPMD step on weights placed by its ``shard_params``) the
model holds this rank's shards (``parallel/sharding.py::shard_params``),
the rows are split over ``data`` x ``fsdp`` and shared within a tensor
group. The split linears' collectives run inside the forward and the
backward (``parallel/sharding.py``), so their ranks must be processes on
the card. After the backward the step sums the adapter leaves over
``tensor`` (a tensor-split product gives each rank a partial gradient for
them; the orthogonality loss enters on the first tensor rank only), every
leaf not split over ``fsdp`` over ``fsdp`` (an fsdp-split leaf's gradient
was reduce-scattered in the backward), then every leaf over ``data``. The
norm sums each split leaf's squares over its axes (``parallel/sharding.py::
global_norm``), so the clip sees the same norm on every rank, and AdamW's
moments have each leaf's shape: a rank keeps its shards' moments.

The axes compose as the JAX package's do (its GSPMD splits beside its ring
and its pipeline): sequence parallelism inside GPipe stages, and FSDP and
tensor parallelism beside either or both. Rows are split over ``data`` x
``fsdp`` only; the ranks of a ``seq``, ``pipe`` or ``tensor`` ring share
them. `reduce_grads` sums in a fixed order that every composition shares:
seq, then pipe (on an FSDP-split stage leaf the pipe sum runs on the
rank's shard, which its pipe peers hold at the same fsdp coordinate), then
tensor, fsdp and data; after it every rank of a seq, pipe or tensor ring
holds the same gradients, so the norm counts each leaf once.

The step makes no host sync: its metrics stay 0-d device tensors, and the
importance EMAs' stop test reads the host's step count.

The step's random draws come from the state's ``torch.Generator``, on the
state's device: first the augmentation's (`ops/augment.py::draw_augment`),
then the dropout's (`models/whisper.py::draw_dropout`). The JAX step splits
its key three ways every step; here an option that is off draws nothing,
so the draws a step takes depend on the options and the batch's shape.
The checkpoint saves the generator's state, so a resume continues its
sequence exactly.

The 'merge' and 'linear' fold regimes are not ported (ROADMAP.md "Not to
port") and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.lora import (
    IPT_NAMES, adalora_entries, adalora_ipt_init, adalora_ipt_update,
    adalora_orth_loss, has_entries, merge_lora, split_lora_fc)
from neuspeech1_tpu_torch.ops import augment
from neuspeech1_tpu_torch.ops import int8_matmul as i8
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.train.optimizer import (
    AdamState, Optimizer, PathPred, default_trainable_pred, global_norm,
    named_leaves)

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]

# the leaves the encoder's layer stack reads: under sequence parallelism a
# rank's gradients for them cover its own tokens only
SEQ_SHARDED_PREFIXES = ("model/encoder/layers/", "lora/encoder/layers/")
# the leaves of both layer stacks: under pipeline parallelism a layer's
# gradients land on its stage only
STAGE_PREFIXES = SEQ_SHARDED_PREFIXES + ("model/decoder/layers/",
                                         "lora/decoder/layers/")


# the config fields the model's forward reads (``models/whisper.py``, from
# ``model.config``): a step or loss built on a config must agree with the
# model's in each, since the JAX package runs its forward on that config
FORWARD_FIELDS = (
    "vocab_size", "num_mel_bins", "d_model", "encoder_layers",
    "decoder_layers", "encoder_heads", "decoder_heads", "encoder_ffn",
    "decoder_ffn", "max_source_positions", "max_target_positions", "dtype",
    "remat", "remat_policy", "flash_attention", "decoder_flash_min_q",
    "decoder_flash_self_min_q", "decoder_flash_cross_min_q",
    "seq_parallel_axis", "pipeline_axis", "pipeline_microbatches")


def check_model_config(config: WhisperConfig, model: tw.Whisper) -> None:
    """Raise ValueError where ``config`` differs from ``model.config`` in a
    field of ``FORWARD_FIELDS``: the forward would run on the model's
    config while the step reduces, draws and schedules on ``config``."""
    diff = {f: (getattr(config, f), getattr(model.config, f))
            for f in FORWARD_FIELDS
            if getattr(config, f) != getattr(model.config, f)}
    if diff:
        raise ValueError(
            "the step's config differs from the model's in fields its "
            "forward reads (step, model): " + ", ".join(
                f"{f}={a!r} vs {b!r}" for f, (a, b) in diff.items())
            + "; build the model from the step's config")


class Frozen(NamedTuple):
    """The model and its adapter tree: every tensor of the step, trainable
    or not (the trainable ones are the same objects as in TrainState)."""

    model: tw.Whisper
    lora: Optional[Params]


@dataclasses.dataclass
class TrainState:
    """step count, trainable leaves by path, optimizer state, generator (on
    the state's device: the step's augmentation and dropout draws), and
    AdaLoRA's importance EMAs ({} without AdaLoRA entries; not
    checkpointed, as PEFT's allocator state is not)."""

    step: int
    trainable: Dict[str, torch.Tensor]
    opt_state: AdamState
    generator: torch.Generator
    ipt: Any = None


def init_train_state(model: tw.Whisper, lora: Optional[Params],
                     tx: Optimizer, pred: Optional[PathPred] = None,
                     seed: int = 2):
    """(state, frozen) for a model holding f32 masters and an adapter tree.
    Sets ``requires_grad`` on exactly the leaves ``pred`` selects (default:
    adapters, stem and conv2) and clears it everywhere else. The generator
    is seeded with ``seed`` on the model's device."""
    pred = pred or default_trainable_pred()
    device = next(model.parameters()).device
    leaves = named_leaves(model, lora)
    trainable = {p: t for p, t in leaves.items() if pred(p)}
    for path, t in leaves.items():
        t.requires_grad_(path in trainable)
    state = TrainState(step=0, trainable=trainable,
                       opt_state=tx.init(trainable),
                       generator=torch.Generator(device).manual_seed(seed),
                       ipt=adalora_ipt_init(lora or {}))
    return state, Frozen(model, lora)


def make_loss_fn(config: WhisperConfig, stem: StemConfig,
                 orth_reg_weight: float = 0.0, fold_lora: bool = False,
                 int8_matmul: str = "off", fold_impl: str = "fc"
                 ) -> Callable[..., tuple]:
    """``loss_fn(frozen, batch, dropout=None) -> (loss, aux)``. With
    ``fold_lora`` the 'fc' regime (attention adapters merged, fc adapters
    folded); without, the per-token delta path in every adapted linear.
    ``dropout``: `models/whisper.py::draw_dropout`'s masks, or None for the
    deterministic forward. ``int8_matmul`` ('off', 'fwd' or 'full'): the
    forward runs under ``ops.int8_matmul.int8_mode``.

    The model runs its own config and stem: ``config`` must agree with
    ``model.config`` in every field of ``FORWARD_FIELDS`` (the loss raises
    ValueError otherwise), and ``stem`` must name the same kind. The JAX
    forward reads the stem's weights by ``stem.kind``, so another kind
    fails there, and the loss raises here too rather than run the model's.
    Its other fields are inert in this loss: ``in_channels`` is read by
    neither forward (the weights fix it), and ``dropout`` only through the
    masks the train step draws at that rate."""
    if int8_matmul not in i8.MODES:
        raise ValueError(f"int8_matmul={int8_matmul!r}: one of {i8.MODES}")
    if fold_impl != "fc":
        raise NotImplementedError(
            f"fold regime {fold_impl!r} is not ported: the port keeps the 'fc' "
            "regime (ROADMAP.md 'Not to port')")

    def loss_fn(frozen: Frozen, batch: Batch, dropout=None, n_tokens=None,
                reg_grad: bool = True):
        """``n_tokens``: the cross entropy's denominator (`models/whisper.py::
        ce_loss`); ``reg_grad=False`` keeps the orthogonality loss out of
        the returned loss (it stays in ``aux``)."""
        model, lora = frozen
        check_model_config(config, model)
        if model.stem_config.kind != stem.kind:
            raise ValueError(
                f"stem kind {stem.kind!r} differs from the model's "
                f"{model.stem_config.kind!r}")
        if lora is not None and not has_entries(lora):
            lora = None
        reg_lora = lora
        feats, ids = batch["input_features"], batch["decoder_input_ids"]
        with i8.int8_mode(int8_matmul):
            if fold_lora and lora is not None:
                merge_tree, fc_tree = split_lora_fc(lora)
                merged = merge_lora(model, merge_tree)
                fc = fc_tree if has_entries(fc_tree) else None
                with (tw.fold_at_linear() if fc is not None
                      else contextlib.nullcontext()):
                    logits = torch.func.functional_call(
                        model, merged, (feats, ids),
                        {"lora": fc, "dropout": dropout})
            else:
                logits = tw.forward(model, feats, ids, lora, dropout)
        loss = tw.ce_loss(logits, batch["labels"], n_tokens=n_tokens)
        aux = {"ce_loss": loss.detach()}
        if orth_reg_weight > 0.0 and reg_lora is not None:
            # over the whole tree, merged and folded entries alike
            reg = adalora_orth_loss(reg_lora)
            aux["orth_reg"] = reg.detach()
            aux["loss"] = (loss + orth_reg_weight * reg).detach()
            if reg_grad:
                loss = loss + orth_reg_weight * reg
        else:
            aux["loss"] = loss.detach()
        return loss, aux

    return loss_fn


def make_train_step(config: WhisperConfig, stem: StemConfig, tx: Optimizer,
                    orth_reg_weight: float = 0.0,
                    augment_config: Optional[dict] = None,
                    use_dropout: bool = False,
                    track_adalora_importance: bool = False,
                    fold_lora: bool = False,
                    adalora_ipt_stop_step: Optional[int] = None,
                    int8_matmul: str = "off"):
    """``step(state, frozen, batch) -> metrics``: one optimizer step on
    ``state`` (in place). Metrics are 0-d device tensors: ``loss``,
    ``ce_loss`` (and ``orth_reg``) and ``grad_norm``, the pre-clip global
    norm of the trainable leaves' gradients (``optax.global_norm``).

    With ``track_adalora_importance`` the state's importance EMAs take one
    PEFT ``update_ipt`` step after the update: on the updated adapters and
    the raw (pre-clip) gradients, the reference's order ``optimizer.step();
    update_and_allocate()``, until the step count before the increment
    reaches ``adalora_ipt_stop_step`` (PEFT: total_step - tfinal).

    ``augment_config`` (``ops/augment.py``'s schema: noise, mask, taylor,
    spec_augment) augments the batch's signals on its device before the
    forward; ``use_dropout`` drops at ``stem.dropout`` (`models/whisper.py::
    draw_dropout`); both draw from ``state.generator``, in that order.
    ``int8_matmul`` as in `make_loss_fn`. The step raises ValueError, before
    any draw, where ``config`` differs from the model's in a field its
    forward reads (`check_model_config`): its reductions over
    ``config``'s axes would not match the forward's."""
    loss_fn = make_loss_fn(config, stem, orth_reg_weight,
                           fold_lora=fold_lora, int8_matmul=int8_matmul)

    def step(state: TrainState, frozen: Frozen, batch: Batch):
        check_model_config(config, frozen.model)
        data = pmesh.data_ring()
        fsdp, tensor = pmesh.fsdp_ring(), pmesh.tensor_ring()
        rank, n = pmesh.batch_coordinate()
        row_rings = pmesh.batch_rings()
        specs = sharding.leaf_specs(frozen.model)
        gen = state.generator
        feats = batch["input_features"]
        rows, total = feats.shape[0], n * feats.shape[0]
        if augment_config:
            draws = augment.draw_augment(gen, (total, *feats.shape[1:]),
                                         augment_config)
            batch = {**batch, "input_features": augment.apply_augment(
                feats, _rank_rows(draws, rank, rows, total), augment_config)}
        dropout = (_rank_rows(tw.draw_dropout(gen, config, stem, total),
                              rank, rows, total) if use_dropout else None)
        n_tokens = None
        if row_rings:
            n_tokens = (batch["labels"] != -100).sum()
            for ring in row_rings:
                n_tokens = ring.all_reduce_sum(n_tokens)
        for t in state.trainable.values():
            t.grad = None
        loss, aux = loss_fn(frozen, batch, dropout, n_tokens,
                            reg_grad=rank == 0 and (tensor is None
                                                    or tensor.rank == 0))
        loss.backward()
        grads = reduce_grads(state.trainable, config, data, aux, fsdp=fsdp,
                             tensor=tensor, specs=specs)
        if row_rings:
            aux["loss"] = aux["ce_loss"] + orth_reg_weight * aux.get(
                "orth_reg", 0.0)
        norm_fn = (functools.partial(sharding.global_norm, specs=specs)
                   if specs else lambda g: global_norm(g.values()))
        norm = norm_fn(grads)
        tx.update(state.trainable, grads, state.opt_state, norm,
                  norm_fn=norm_fn)
        if track_adalora_importance and state.ipt and (
                adalora_ipt_stop_step is None
                or state.step < adalora_ipt_stop_step):
            adalora_ipt_update(state.ipt, frozen.lora, {
                path: {n: grads[f"lora/{path}/{n}"] for n in IPT_NAMES}
                for path, _ in adalora_entries(frozen.lora)})
        state.step += 1
        return {**aux, "grad_norm": norm}

    return step


def _rank_rows(draws, rank: int, rows: int, total: int):
    """``draws`` (a draw function's tree for a batch of ``total`` rows) cut
    to this rank's block: every tensor whose leading dim is ``total`` takes
    rows rank*rows .. (rank+1)*rows - 1; anything else stays."""
    if rows == total or draws is None:
        return draws
    if isinstance(draws, dict):
        return {k: _rank_rows(v, rank, rows, total)
                for k, v in draws.items()}
    if isinstance(draws, torch.Tensor) and draws.dim() and \
            draws.shape[0] == total:
        return draws[rank * rows:(rank + 1) * rows]
    return draws


def _axis_ring(axis: Optional[str]):
    return None if axis is None else pmesh.axis_ring(axis)


def reduce_grads(trainable: Dict[str, torch.Tensor], config: WhisperConfig,
                 data=None, aux: Optional[dict] = None, fsdp=None,
                 tensor=None, specs: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """The trainable leaves' gradients after ``loss.backward()``, summed
    where the mesh splits the work: the encoder stack's leaves over
    ``config.seq_parallel_axis``'s ring, both layer stacks' leaves over
    ``config.pipeline_axis``'s ring (a stage's missing gradients taken as
    zeros), the adapter leaves over the ``tensor`` ring, every leaf that
    ``specs`` (``parallel/sharding.py::leaf_specs``) does not split over
    ``fsdp``, with ``aux['ce_loss']``, over the ``fsdp`` ring, then every
    leaf, with ``aux['ce_loss']``, over the ``data`` ring. Each is one
    collective per dtype; the result is the same on every rank of a
    ring."""
    grads = {k: t.grad for k, t in trainable.items() if t.grad is not None}
    seq = _axis_ring(config.seq_parallel_axis)
    if seq is not None:
        grads = sum_seq_sharded_grads(grads, seq)
    pipe = _axis_ring(config.pipeline_axis)
    if pipe is not None and pipe.size > 1:
        # in the trainable leaves' order on every rank: the collective sums
        # the leaves packed flat
        grads = {k: grads[k] if k in grads else torch.zeros_like(t)
                 for k, t in trainable.items()
                 if k in grads or k.startswith(STAGE_PREFIXES)}
        grads = _sum_leaves(grads, pipe, STAGE_PREFIXES)
    if tensor is not None:
        grads = _sum_leaves(grads, tensor, sharding.TENSOR_PARTIAL_PREFIXES)
    if fsdp is not None:
        specs = specs or {}
        whole = tuple(k for k in grads if "fsdp" not in specs.get(k, ()))
        grads = _sum_with_loss(grads, fsdp, aux, whole)
    if data is not None:
        grads = _sum_with_loss(grads, data, aux)
    return grads


def _sum_with_loss(grads, ring, aux, keys: Optional[tuple] = None):
    """`_sum_leaves` of the leaves in ``keys`` (default: all) over
    ``ring``, ``aux['ce_loss']`` packed in and summed with them."""
    if aux is not None:
        grads = {**grads, "\0ce_loss": aux["ce_loss"]}
        keys = None if keys is None else keys + ("\0ce_loss",)
    grads = _sum_leaves(grads, ring, keys)
    if aux is not None:
        aux["ce_loss"] = grads.pop("\0ce_loss")
    return grads


def sum_seq_sharded_grads(grads: Dict[str, torch.Tensor], ring
                          ) -> Dict[str, torch.Tensor]:
    """``grads`` with every leaf under ``SEQ_SHARDED_PREFIXES`` summed over
    ``ring``: one collective per dtype over the leaves packed flat, the
    same sum on every rank."""
    return _sum_leaves(grads, ring, SEQ_SHARDED_PREFIXES)


def _sum_leaves(grads: Dict[str, torch.Tensor], ring,
                prefixes: Optional[tuple] = None
                ) -> Dict[str, torch.Tensor]:
    """``grads`` with every leaf (under ``prefixes``, a tuple of path
    prefixes, where given) summed over ``ring``, packed flat: one
    collective per dtype."""
    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, g in grads.items():
        if prefixes is None or k.startswith(prefixes):
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
