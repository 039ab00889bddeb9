"""LoRA / AdaLoRA adapters for the PyTorch port: the port of
``neuspeech1_tpu/models/lora.py`` (everything but AdaLoRA's rank allocation,
orthogonality loss and importance EMAs, which ROADMAP.md queues).

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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from neuspeech1_tpu_torch.ops.lora_bwd import lora_adapter_bwd

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
    ``merge_and_unload``; the JAX package's ``merge_lora``)."""
    merged: Dict[str, torch.Tensor] = {}
    for path, entry in entries(lora):
        name = path.replace("/", ".")
        weight = model.get_parameter(f"{name}.weight")
        merged[f"{name}.weight"] = w_eff_of(weight.float(), entry)
    return merged


class FoldedLinear(torch.autograd.Function):
    """y = x W_eff^T + bias with W_eff = W + s A (E) B, and a low-rank-only
    backward: dA, dB (and dE) from one pass of the adapter-backward kernel
    over x and dy, dx from one matmul against W_eff. W and bias get no
    gradient (the frozen-base contract, checked by ``folded_linear``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, a, b, e, alpha):
        entry = {"A": a, "B": b, "alpha": alpha}
        if e is not None:
            entry["E"] = e
        w_eff = w_eff_of(weight.float(), entry).to(x.dtype)
        y = x.reshape(-1, x.shape[-1]) @ w_eff.T
        y = y.reshape(*x.shape[:-1], w_eff.shape[0])
        if bias is not None:
            y = y + bias.to(x.dtype)
        ctx.save_for_backward(x, w_eff, a, b, e, alpha)
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
        dx = (dy2 @ w_eff).reshape(x.shape).to(x.dtype)
        return dx, None, None, da32.to(a.dtype), db32.to(b.dtype), de, None


def folded_linear(x, p, entry: Params):
    """``x @ (W + s A (E) B)^T + bias`` for an ``nn.Linear`` ``p`` whose
    weight and bias are frozen; raises if either requires grad, because the
    backward returns none for them."""
    if p.weight.requires_grad or (p.bias is not None and p.bias.requires_grad):
        raise ValueError(
            "folded_linear returns no gradient for the base weight and bias:"
            " freeze them (requires_grad=False) or use the delta path")
    return FoldedLinear.apply(x, p.weight, p.bias, entry["A"], entry["B"],
                              entry.get("E"), entry["alpha"].detach())
