"""LoRA / AdaLoRA adapters for the PyTorch port: the port of
``neuspeech1_tpu/models/lora.py``, AdaLoRA's rank allocation, orthogonality
loss and importance EMAs included.

An adapter tree mirrors the model's layer lists:
``{"encoder": {"layers": [layer_0, layer_1, ...]}}`` with, per layer,
``{"self_attn": {"q": entry, "k": ..., "v": ..., "out": ...}, "fc1": entry,
"fc2": entry}``. An entry is a dict of tensors:

  LoRA:    {"A": [d_in, r], "B": [r, d_out], "alpha": [1, 1]}
           delta = x A B * alpha / r
  AdaLoRA: the same plus "E": [r, 1] and "mask": [r, 1]
           delta = x A diag(E) B * alpha / r

``alpha`` and ``mask`` are hyper-parameters: they enter every product
detached, so they never receive a gradient (the JAX package's
``stop_gradient``). ``models/convert.py`` maps a tree onto the JAX package's
stacked ``[L, ...]`` leaves and back.

Adapters stay whole on every rank of a mesh. On a base weight split by
``parallel/sharding.py`` the products take the entry's block
(``sharding.entry_block``: B's columns of a column-parallel weight, A's
rows of a row-parallel one), so K3 runs at the split shapes and each
tensor rank's gradient for A, B and E is a partial sum, which the
training step adds over the ``tensor`` ring.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from neuspeech1_tpu_torch.ops.int8_matmul import mode as int8_mode
from neuspeech1_tpu_torch.ops.int8_matmul import qdot
from neuspeech1_tpu_torch.ops.lora_bwd import lora_adapter_bwd
from neuspeech1_tpu_torch.parallel import sharding

Params = Dict[str, Any]

# The reference's default target set: encoder q/k/v/out/fc1/fc2.
DEFAULT_TARGETS = ("q", "k", "v", "out", "fc1", "fc2")
ATTN_TARGETS = ("q", "k", "v", "out")


def _entry_shapes(d_model: int, ffn: int, name: str) -> Tuple[int, int]:
    if name in ATTN_TARGETS:
        return d_model, d_model
    if name == "fc1":
        return d_model, ffn
    if name == "fc2":
        return ffn, d_model
    raise KeyError(name)


def init_lora(config, rank: int = 32, alpha: float = 64.0,
              targets: Sequence[str] = DEFAULT_TARGETS,
              parts: Sequence[str] = ("encoder",), adalora: bool = False,
              seed: int = 1, device="cuda", dtype=torch.float32,
              layer_range: Optional[Tuple[int, int]] = None) -> Params:
    """The adapter tree of ``neuspeech1_tpu.models.lora.init_lora``: A ~
    N(0, 1/r), B = 0, so the model starts at its base weights; with
    ``adalora`` E = 0, mask = 1 and A, B ~ N(0, 0.02^2). ``layer_range=(lo,
    hi)`` zeroes alpha outside layers lo..hi-1. Seeded by a
    ``torch.Generator``: the numbers differ from ``jax.random``'s."""
    gen = torch.Generator().manual_seed(seed)
    tree: Params = {}
    for part in parts:
        n_layers = (config.encoder_layers if part == "encoder"
                    else config.decoder_layers)
        ffn = config.encoder_ffn if part == "encoder" else config.decoder_ffn
        layers: List[Params] = [{} for _ in range(n_layers)]
        for name in targets:
            d_in, d_out = _entry_shapes(config.d_model, ffn, name)
            a = torch.randn((n_layers, d_in, rank), generator=gen) / rank ** 0.5
            b = torch.zeros((n_layers, rank, d_out))
            if adalora:
                a = 0.02 * torch.randn((n_layers, d_in, rank), generator=gen)
                b = 0.02 * torch.randn((n_layers, rank, d_out), generator=gen)
            for i, layer in enumerate(layers):
                keep = layer_range is None or layer_range[0] <= i < layer_range[1]
                entry = {"A": a[i], "B": b[i],
                         "alpha": torch.full((1, 1), alpha if keep else 0.0)}
                if adalora:
                    entry["E"] = torch.zeros((rank, 1))
                    entry["mask"] = torch.ones((rank, 1))
                dest = (layer.setdefault("self_attn", {})
                        if name in ATTN_TARGETS else layer)
                dest[name] = {k: v.to(device=device, dtype=dtype).contiguous()
                              for k, v in entry.items()}
        tree[part] = {"layers": layers}
    return tree


def is_entry(node) -> bool:
    return isinstance(node, dict) and "A" in node


def entries(tree, prefix: str = ""):
    """(path, entry) pairs of a tree; paths are ``/``-joined, list indices
    included (``encoder/layers/0/self_attn/q``)."""
    if is_entry(tree):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from entries(v, f"{prefix}/{k}" if prefix else str(k))


def lora_delta(x, entry: Params):
    """The per-token low-rank delta x A (E) B * alpha / r of one adapted
    linear, in x's dtype."""
    a = entry["A"].to(x.dtype)
    h = x @ a
    if "E" in entry:
        h = h * entry["E"].to(x.dtype)[..., 0]
    scale = entry["alpha"].detach().to(x.dtype) / a.shape[-1]
    return (h @ entry["B"].to(x.dtype)) * scale


def w_eff_of(weight, entry: Params):
    """W + s A (E) B for one layer's weight [d_out, d_in]: the delta in f32
    added to the f32 master weight (the caller casts at use)."""
    a = entry["A"]
    if "E" in entry:
        a = a * entry["E"][..., 0][None, :]
    scale = entry["alpha"].detach().reshape(()) / a.shape[-1]
    return weight + ((a @ entry["B"]) * scale).T


def split_lora_fc(lora: Params) -> Tuple[Params, Params]:
    """Partition a tree into (attention entries, fc entries), structure
    kept: the training step merges the first and runs the second through
    ``folded_linear``. Layers keep their positions in the lists."""
    def walk(t):
        if isinstance(t, list):
            pairs = [walk(v) for v in t]
            return [m for m, _ in pairs], [f for _, f in pairs]
        m: Params = {}
        f: Params = {}
        for k, v in t.items():
            if is_entry(v):
                (f if k in ("fc1", "fc2") else m)[k] = v
            else:
                sm, sf = walk(v)
                if has_entries(sm):
                    m[k] = sm
                if has_entries(sf):
                    f[k] = sf
        return m, f

    return walk(lora)


def has_entries(tree) -> bool:
    return any(True for _ in entries(tree))


def merge_lora(model, lora: Params) -> Dict[str, torch.Tensor]:
    """W + s A (E) B for every adapted linear of ``model``, keyed by the
    parameter's name (``encoder.layers.0.self_attn.q.weight``): f32 merged
    weights that carry the adapters' autograd graph. Pass them to
    ``torch.func.functional_call`` to run the model on them (PEFT's
    ``merge_and_unload``; the JAX package's ``merge_lora``). A weight split
    by ``parallel/sharding.py`` merges with its block of the delta."""
    merged: Dict[str, torch.Tensor] = {}
    for path, entry in entries(lora):
        name = path.replace("/", ".")
        shard = getattr(model.get_submodule(name), "shard", None)
        if shard is not None:
            entry = sharding.entry_block(entry, shard["weight"])
        weight = model.get_parameter(f"{name}.weight")
        merged[f"{name}.weight"] = w_eff_of(weight.float(), entry)
    return merged


class FoldedLinear(torch.autograd.Function):
    """y = x W_eff^T + bias with W_eff = W + s A (E) B, and a low-rank-only
    backward: dA, dB (and dE) from one pass of the adapter-backward kernel
    over x and dy, dx from one matmul against W_eff. W and bias get no
    gradient (the frozen-base contract, checked by ``folded_linear``).

    ``i8``, the int8 mode when the forward ran (``ops/int8_matmul.py``):
    under 'fwd' the W_eff product is an int8 matmul, under 'full' the dx
    product too; dA, dB and dE stay on the kernel, on the exact x and dy."""

    @staticmethod
    def forward(ctx, x, weight, bias, a, b, e, alpha, i8: str = "off"):
        entry = {"A": a, "B": b, "alpha": alpha}
        if e is not None:
            entry["E"] = e
        w_eff = w_eff_of(weight.float(), entry).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        y = qdot(x2, w_eff, x.dtype) if i8 != "off" else x2 @ w_eff.T
        y = y.reshape(*x.shape[:-1], w_eff.shape[0])
        if bias is not None:
            y = y + bias.to(x.dtype)
        ctx.save_for_backward(x, w_eff, a, b, e, alpha)
        ctx.i8 = i8
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_eff, a, b, e, alpha = ctx.saved_tensors
        r = a.shape[-1]
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        da32, db_raw, de_raw = lora_adapter_bwd(
            x2, dy2, a.to(x.dtype), b.to(dy.dtype))
        scale32 = (alpha.reshape(()) / r).float()
        da32 = da32 * scale32
        de = None
        if e is not None:
            ge = e[..., 0].float()
            de = (de_raw * scale32)[:, None].to(e.dtype)
            da32 = da32 * ge[None, :]
            db32 = ge[:, None] * db_raw * scale32
        else:
            db32 = db_raw * scale32
        if ctx.i8 == "full":
            dx = qdot(dy2, w_eff.t().contiguous(), dy2.dtype)
        else:
            dx = dy2 @ w_eff
        dx = dx.reshape(x.shape).to(x.dtype)
        return (dx, None, None, da32.to(a.dtype), db32.to(b.dtype), de, None,
                None)


def folded_linear(x, p, entry: Params):
    """``x @ (W + s A (E) B)^T + bias`` for an ``nn.Linear`` ``p`` whose
    weight and bias are frozen (`folded_product`)."""
    return folded_product(x, p.weight, p.bias, entry)


def folded_product(x, weight, bias, entry: Params):
    """``x @ (W + s A (E) B)^T + bias`` for a frozen ``weight`` [d_out,
    d_in] and ``bias``; raises if either requires grad, because the
    backward returns none for them. The active int8 mode
    (``ops/int8_matmul.py``) is read here, when the forward runs."""
    if weight.requires_grad or (bias is not None and bias.requires_grad):
        raise ValueError(
            "folded_linear returns no gradient for the base weight and bias:"
            " freeze them (requires_grad=False) or use the delta path")
    return FoldedLinear.apply(x, weight, bias, entry["A"], entry["B"],
                              entry.get("E"), entry["alpha"].detach(),
                              int8_mode())


# ----------------------------------------------------------------------
# AdaLoRA rank allocation: PEFT's RankAllocator, as the JAX package has it
#
# Two elementwise EMAs per A/B/E tensor (sensitivity |theta * g| with beta1,
# its uncertainty |ipt - avg| with beta2); a rank's triplet score is
# s(E) + mean_in s(A) + mean_out s(B) with s = avg * unc; allocation zeroes
# E at the ranks scoring at or below the global k-th smallest score and
# records the pattern in ``mask``. The mask never gates the forward, so a
# pruned rank keeps its gradient and can come back, as in PEFT.
#
# The port's tree holds one entry per layer where the JAX package stacks
# [L, ...] leaves, so a score here is [r] per entry ([L, r] there), and the
# budget counts the same units: one per (layer, matrix, rank). Everything
# stays on the tensors' device; masking writes E and ``mask`` in place, so
# the tensors the optimizer and its moments hold stay the same objects.
# ----------------------------------------------------------------------

IPT_NAMES = ("A", "B", "E")


def adalora_entries(lora: Params) -> List[Tuple[str, Params]]:
    """(path, entry) of every AdaLoRA entry (one with ``E``), in tree
    order."""
    return [(p, e) for p, e in entries(lora) if "E" in e]


def adalora_ipt_init(lora: Params) -> Params:
    """Zeroed ``{"avg": {path: {A, B, E}}, "unc": ...}`` EMAs over the
    AdaLoRA entries (PEFT's exp_avg_ipt / exp_avg_unc); {} without any."""
    ada = adalora_entries(lora)
    if not ada:
        return {}

    def zeros():
        return {p: {n: torch.zeros_like(e[n]) for n in IPT_NAMES}
                for p, e in ada}

    return {"avg": zeros(), "unc": zeros()}


@torch.no_grad()
def adalora_ipt_update(ipt: Params, lora: Params, grads: Dict[str, Params],
                       beta1: float = 0.85, beta2: float = 0.85) -> Params:
    """One PEFT ``update_ipt`` step in place: ipt = |theta * g|; avg <-
    beta1 avg + (1 - beta1) ipt; unc <- beta2 unc + (1 - beta2) |ipt - avg|
    with the updated avg. ``grads`` maps an entry's path to its ``{A, B,
    E}`` gradients. A few fused ``torch._foreach_*`` launches over every
    tensor at once; returns ``ipt``."""
    avg, unc, theta, grad = [], [], [], []
    for path, entry in adalora_entries(lora):
        for n in IPT_NAMES:
            avg.append(ipt["avg"][path][n])
            unc.append(ipt["unc"][path][n])
            theta.append(entry[n])
            grad.append(grads[path][n])
    if not avg:
        return ipt
    sens = torch._foreach_mul(theta, grad)
    torch._foreach_abs_(sens)
    torch._foreach_mul_(avg, beta1)
    torch._foreach_add_(avg, torch._foreach_mul(sens, 1 - beta1))
    dev = torch._foreach_sub(sens, avg)
    torch._foreach_abs_(dev)
    torch._foreach_mul_(unc, beta2)
    torch._foreach_add_(unc, torch._foreach_mul(dev, 1 - beta2))
    return ipt


def adalora_triplet_scores(ipt: Params) -> Dict[str, torch.Tensor]:
    """Per-rank triplet importance [r] by entry path: s(E) + mean over A's
    input dim + mean over B's output dim, s = avg * unc (PEFT
    ``_element_score`` + ``_combine_ipt``)."""
    out = {}
    for path, avg in ipt["avg"].items():
        unc = ipt["unc"][path]
        sa = (avg["A"] * unc["A"]).mean(dim=0)
        sb = (avg["B"] * unc["B"]).mean(dim=1)
        se = (avg["E"] * unc["E"])[..., 0]
        out[path] = se + sa + sb
    return out


def adalora_total_ranks(lora: Params) -> int:
    """init_bgt in PEFT terms: one unit per (layer, matrix, rank)."""
    return sum(int(e["E"].shape[0]) for _, e in adalora_entries(lora))


def adalora_matrix_count(lora: Params) -> int:
    """The number of adapted (layer, matrix) units."""
    return len(adalora_entries(lora))


@torch.no_grad()
def adalora_apply_pattern(lora: Params, pattern: Dict[str, torch.Tensor]
                          ) -> Params:
    """Re-apply a frozen 0/1 rank pattern in place: E <- E * mask (PEFT
    ``mask_using_rank_pattern``, every step of the final phase, because
    pruned E entries keep their gradients and regrow)."""
    for path, entry in adalora_entries(lora):
        m = pattern[path]
        entry["E"].mul_(m)
        entry["mask"].copy_(m)
    return lora


def adalora_pattern_of(lora: Params) -> Dict[str, torch.Tensor]:
    """A copy of the current 0/1 mask of every AdaLoRA entry, by path."""
    return {p: e["mask"].detach().clone() for p, e in adalora_entries(lora)}


def adalora_budget_schedule(step: int, init_bgt: int, target_bgt: int,
                            tinit: int, tfinal: int, total_steps: int,
                            deltaT: int) -> Tuple[int, bool]:
    """(budget, mask_ind): PEFT's ``budget_schedule`` in total-rank units
    (the cubic decay on budgets, not per-matrix ranks)."""
    if step <= tinit:
        return init_bgt, False
    if step > total_steps - tfinal:
        return target_bgt, True
    mul = 1 - (step - tinit) / (total_steps - tfinal - tinit)
    budget = int((init_bgt - target_bgt) * mul**3 + target_bgt)
    return budget, (step % deltaT == 0)


@torch.no_grad()
def adalora_mask_to_budget(lora: Params, scores: Dict[str, torch.Tensor],
                           budget: int, init_bgt: Optional[int] = None
                           ) -> Params:
    """PEFT ``mask_to_budget`` in place: the threshold is the k-th smallest
    triplet score over every entry, k = init_bgt - budget; E is zeroed
    where the score is at or below it and ``mask`` holds the surviving
    pattern. The threshold and the masks stay on the device."""
    if init_bgt is None:
        init_bgt = adalora_total_ranks(lora)
    k = init_bgt - budget
    ada = adalora_entries(lora)
    if not ada or k <= 0:
        return lora
    everything = torch.cat([scores[p].reshape(-1) for p, _ in ada])
    thresh = torch.kthvalue(everything, k).values
    for path, entry in ada:
        keep = (scores[path] > thresh)[:, None]
        entry["E"].masked_fill_(~keep, 0.0)
        entry["mask"].copy_(keep)
    return lora


def adalora_budget(step: int, init_r: int, target_r: int, tinit: int,
                   tfinal: int, total_steps: int) -> int:
    """The cubic per-matrix rank schedule, boundary-exact with PEFT's
    ``RankAllocator.budget_schedule``: init_r through tinit, target_r after
    total_steps - tfinal, a cubic decay between."""
    if step <= tinit:
        return init_r
    if step > total_steps - tfinal:
        return target_r
    mul = 1 - (step - tinit) / (total_steps - tfinal - tinit)
    return int((init_r - target_r) * mul**3 + target_r)


def adalora_update_masks_global(lora: Params,
                                importance: Dict[str, torch.Tensor],
                                budget_per_matrix: int) -> Params:
    """Global allocation from per-rank importance: ``adalora_mask_to_budget``
    with the budget pooled over every (layer, matrix) unit, so hot matrices
    hold more ranks than cold ones."""
    return adalora_mask_to_budget(
        lora, importance, budget_per_matrix * adalora_matrix_count(lora))


def adalora_orth_loss(lora: Params) -> torch.Tensor:
    """The orthogonality regularizer mean((A^T A - I)^2) + mean((B B^T -
    I)^2) over each adapted matrix's layers, summed over matrices. Entries
    are grouped by their path without the layer index and stacked, so each
    mean runs over [L, r, r] as the JAX package's does on its stacked
    leaves; 0 for a tree without AdaLoRA entries, as there."""
    groups: Dict[str, List[Params]] = {}
    for path, entry in adalora_entries(lora):
        key = "/".join(p for p in path.split("/") if not p.isdigit())
        groups.setdefault(key, []).append(entry)
    total = None
    for group in groups.values():
        a = torch.stack([e["A"] for e in group])
        b = torch.stack([e["B"] for e in group])
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        ata = torch.matmul(a.transpose(1, 2), a)
        bbt = torch.matmul(b, b.transpose(1, 2))
        term = ((ata - eye) ** 2).mean() + ((bbt - eye) ** 2).mean()
        total = term if total is None else total + term
    return torch.zeros(()) if total is None else total
