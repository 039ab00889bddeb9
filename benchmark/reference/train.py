"""The reference's replay of the first training steps.

From the seed's weights, adapters and batches it runs the recipe's steps
in float32 without TF32: the cross entropy over the labels (mean over the
tokens that are not -100) plus the orthogonality regularizer at its
weight, its gradients for the trainable leaves (the adapters' A, B and E,
the stem's convs and Whisper's conv2), clipping by the global norm, then
AdamW with the warmup schedule read at the count before the step. The
batch's rows go through the backward in blocks, their gradients summed,
so that the plain attention's score matrices fit.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.lib import data, weights
from benchmark.reference import model as ref

STEM_LEAVES = (("stem", "conv_a"), ("stem", "conv_b"), ("conv2",))


def trainable(tree: dict, lora: dict) -> Dict[str, torch.Tensor]:
    """The trainable leaves by their path in the program's combined tree
    (``model/encoder/stem/conv_a/w``, ``lora/encoder/layers/0/fc1/A``)."""
    out = {}
    enc = tree["encoder"]
    for path in STEM_LEAVES:
        node = enc
        for key in path:
            node = node[key]
        for leaf in ("w", "b"):
            out["model/encoder/" + "/".join(path) + f"/{leaf}"] = node[leaf]
    for part, sub in lora.items():
        for i, layer in enumerate(sub["layers"]):
            for name, node in layer.items():
                pairs = (node.items() if name == "self_attn"
                         else [(None, node)])
                for target, entry in pairs:
                    prefix = f"lora/{part}/layers/{i}/{name}" + (
                        f"/{target}" if target else "")
                    for leaf in ("A", "B", "E"):
                        out[f"{prefix}/{leaf}"] = entry[leaf]
    return out


def _lr(opt: dict, count: int) -> float:
    """The warmup-linear schedule at ``count`` (0 -> peak over the warmup
    steps, then to 0 at the total)."""
    warm, total, peak = opt["warmup_steps"], opt["total_steps"], opt["peak_lr"]
    if count < warm:
        return peak * count / max(warm, 1)
    return peak * (1.0 - min(count - warm, total - warm) / max(total - warm, 1))


def loss_and_grads(tree, lora, leaves, config, feats, labels, dec_in,
                   rows: int) -> float:
    """The loss of one batch, its gradients accumulated into the leaves'
    ``.grad``, blocks of ``rows`` rows at a time."""
    n_tokens = int((labels != data.LABEL_IGNORE_ID).sum())
    total = 0.0
    for lo in range(0, feats.shape[0], rows):
        sl = slice(lo, lo + rows)
        enc = ref.encoder(tree, config, feats[sl].float(), lora)
        logits = ref.decoder(tree, config, dec_in[sl], enc)
        lab = labels[sl]
        keep = lab != data.LABEL_IGNORE_ID
        logp = logits.log_softmax(-1)
        picked = logp.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
        ce = -(picked * keep).sum() / n_tokens
        ce.backward()
        total += float(ce.detach())
    weight = config["adapters"]["orth_reg_weight"]
    if weight:
        reg = weight * ref.orthogonality(lora)
        reg.backward()
        total += float(reg.detach())
    return total


def replay(config: dict, traffic: dict, seed: int, batches: List, device,
           precision=None) -> dict:
    """The reference's first ``len(batches)`` steps on the seed's weights
    and the pool rows ``batches`` (index tensors). Returns ``losses``,
    ``grad`` (the first step's clipped gradient's norm per leaf, as the
    optimizer gets it), ``grad_raw`` (before the clip) and ``change`` (each
    leaf's norm of its change over the steps)."""
    opt = traffic["optimizer"]
    if opt["weight_decay"]:
        raise NotImplementedError("the reference replays AdamW without "
                                  "weight decay, as the recipe runs it")
    with ref.exact_f32():
        tree = weights.param_tree(config, seed, device)
        lora = weights.adapter_tree(config, seed, device)
        feats, labels, dec_in = data.train_pool(config, traffic, seed, device)
        leaves = trainable(tree, lora)
        start = {k: v.detach().clone() for k, v in leaves.items()}
        for v in leaves.values():
            v.requires_grad_(True)
        mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        out = {"losses": []}
        for count, idx in enumerate(batches):
            for v in leaves.values():
                v.grad = None
            idx = torch.as_tensor(idx, device=device)
            with ref.precision(precision):
                out["losses"].append(loss_and_grads(
                    tree, lora, leaves, config, feats[idx], labels[idx],
                    dec_in[idx], traffic["reference_rows"]))
            with torch.no_grad():
                grads = {k: v.grad if v.grad is not None
                         else torch.zeros_like(v) for k, v in leaves.items()}
                norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                clip = opt["grad_clip"]
                if clip and norm >= clip:
                    grads = {k: g / norm * clip for k, g in grads.items()}
                if count == 0:
                    out["grad_raw"] = {k: float(v.grad.norm()) if v.grad
                                       is not None else 0.0
                                       for k, v in leaves.items()}
                    out["grad"] = {k: float(g.norm())
                                   for k, g in grads.items()}
                lr = _lr(opt, count)
                bc1 = 1.0 - opt["b1"] ** (count + 1)
                bc2 = 1.0 - opt["b2"] ** (count + 1)
                for k, v in leaves.items():
                    g = grads[k]
                    mu[k].mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
                    nu[k].mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
                    u = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + opt["eps"])
                    v.add_(u, alpha=-lr)
        out["change"] = {k: float((v.detach() - start[k]).norm())
                         for k, v in leaves.items()}
    return out
