"""Optimizer, schedule and trainable set for the PyTorch port: the port of
``neuspeech1_tpu/train/optimizer.py``.

The update is optax's ``chain(clip_by_global_norm(1.0), adamw(schedule))``
written out, because torch's own pieces differ from it where a loss
trajectory shows:

- the schedule is read at the count *before* the step, so the first update
  under warmup uses lr = schedule(0) = 0;
- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``, with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and always
  scales);
- Adam's eps sits outside the square root and bias correction uses the
  incremented count.

Leaves are named by their path in the JAX package's combined tree
(``model/encoder/stem/conv_a/w``, ``lora/encoder/layers/0/fc1/A``), with a
layer index where the port keeps per-layer tensors, so the JAX package's
predicates and weight-decay mask read them unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from neuspeech1_tpu_torch.models.lora import entries

PathPred = Callable[[str], bool]

# Leaves that are hyper-parameters or norm/bias terms, never weight-decayed.
_NO_DECAY_LEAVES = {"b", "bias", "scale", "alpha", "mask"}


def named_leaves(model: nn.Module, lora=None) -> Dict[str, torch.Tensor]:
    """Every tensor of the model and the adapter tree by its path in the
    combined ``{"model": ..., "lora": ...}`` tree."""
    out: Dict[str, torch.Tensor] = {}

    def walk(module, prefix):
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            out[f"{prefix}/w"] = module.weight
            if module.bias is not None:
                out[f"{prefix}/b"] = module.bias
        elif isinstance(module, nn.LayerNorm):
            out[f"{prefix}/scale"] = module.weight
            out[f"{prefix}/bias"] = module.bias
        elif isinstance(module, nn.Embedding):
            out[prefix] = module.weight
        elif isinstance(module, nn.ModuleList):
            for i, layer in enumerate(module):
                walk(layer, f"{prefix}/{i}")
        else:
            for name, p in module.named_parameters(recurse=False):
                out[f"{prefix}/{name}"] = p
            for name, child in module.named_children():
                walk(child, f"{prefix}/{name}")

    walk(model, "model")
    for path, entry in entries(lora or {}):
        for k, v in entry.items():
            out[f"lora/{path}/{k}"] = v
    return out


def default_trainable_pred(ft_full: bool = False) -> PathPred:
    """The reference's trainable set: the adapters and the stem convs
    (``lora/*``, ``model/encoder/stem/*``, ``model/encoder/conv2/*``), or
    with ``ft_full`` every leaf (`finetune.py:191`)."""
    if ft_full:
        return lambda p: True
    return lambda p: (p.startswith("lora/")
                      or p.startswith("model/encoder/stem/")
                      or p.startswith("model/encoder/conv2/"))


def decays(path: str) -> bool:
    """The weight-decay mask: False for biases, norms and adapter
    hyper-parameters."""
    return path.rsplit("/", 1)[-1] not in _NO_DECAY_LEAVES


def warmup_linear_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """optax's ``join_schedules`` of two ``linear_schedule``s: 0 -> peak
    over ``warmup_steps``, then peak -> 0 at ``total_steps``."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def linear(init, end, steps, count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return linear(0.0, peak_lr, warm, count)
        return linear(peak_lr, 0.0, decay, count - warmup_steps)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-d tensor on
    the tensors' device). A rank's shards of split leaves take the sharded
    norm, ``parallel/sharding.py::global_norm``."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


@dataclasses.dataclass
class AdamState:
    """AdamW's update count and moments; under accumulation also the
    micro-step within the current group and the running mean of its
    gradients (optax ``MultiStepsState``'s ``mini_step`` and
    ``acc_grads``)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0
    acc: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class Optimizer:
    """Clip by global norm, then AdamW on a schedule, with optax's order
    and constants (see the module docstring). With ``accum_steps`` k > 1,
    optax's ``MultiSteps``: each call adds its gradients to a running mean,
    and only every k-th call clips that mean and updates the parameters
    (and counts a step of the schedule); the calls between leave them
    unchanged."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    accum_steps: int = 1

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for k, p in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros(),
                         acc=zeros() if self.accum_steps > 1 else None)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: AdamState,
               norm: Optional[torch.Tensor] = None,
               norm_fn: Optional[Callable] = None) -> None:
        """One call on ``params`` in place. ``grads`` maps a subset of the
        paths of ``params`` to gradients. A leaf without one keeps its value
        and moments: these are the leaves the loss never reaches (adapter
        ``alpha`` and ``mask``), whose optax update is exactly 0. ``norm``
        is the gradients' global norm when the caller has it (unused under
        accumulation, which clips the mean). ``norm_fn`` maps a gradient
        dict to its global norm (default: `global_norm` of its values;
        the training step passes the sharded norm when ``params`` are a
        rank's shards, ``parallel/sharding.py::global_norm``)."""
        if self.accum_steps > 1:
            n = state.mini_step
            for k, g in grads.items():
                acc = state.acc[k]
                acc.add_((g - acc) / (n + 1))
            if n + 1 < self.accum_steps:
                state.mini_step = n + 1
                return
            acc = {k: state.acc[k] for k in grads}
            self._apply(params, acc, state,
                        None if norm_fn is None else norm_fn(acc))
            for acc in state.acc.values():
                acc.zero_()
            state.mini_step = 0
            return
        self._apply(params, grads, state, norm)

    def _apply(self, params, grads, state: AdamState, norm) -> None:
        if self.grad_clip:
            if norm is None:
                norm = global_norm(grads.values())
            keep = norm < self.grad_clip
            grads = {k: torch.where(keep, g, (g / norm) * self.grad_clip)
                     for k, g in grads.items()}
        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        lr = self.schedule(state.count)
        for k, g in grads.items():
            mu, nu, p = state.mu[k], state.nu[k], params[k]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            if self.weight_decay and decays(k):
                u = u + self.weight_decay * p
            p.add_(u, alpha=-lr)
        state.count = count


def make_optimizer(peak_lr: float = 1e-3, warmup_steps: int = 500,
                   total_steps: int = 100_000, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   grad_clip: Optional[float] = 1.0,
                   accum_steps: int = 1) -> Optimizer:
    """AdamW + warmup-linear + clip (HF Trainer's defaults: max_grad_norm
    1.0, eps 1e-8, no weight decay), with optax ``MultiSteps``'s gradient
    accumulation over ``accum_steps`` calls."""
    return Optimizer(warmup_linear_schedule(peak_lr, warmup_steps,
                                            total_steps),
                     b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     grad_clip=grad_clip, accum_steps=accum_steps)

