"""Seeded weights and inputs of a configuration with a language model
behind the EEG tower (``configs/kimi-vl-a3b-lm-meg208.json``): the tower's
Whisper weights and adapters (`tower`, through ``lib/weights.py``), the
projector's, the language model's, and the pool of clips and labels.

The language model's weights are a flat dict under the program's
parameter names (``layers.1.mlp.experts.gate_up`` [E, hidden, 2 x width],
``layers.1.mlp.experts.down`` [E, width, hidden], the other linears
[out, in], ``layers.1.mlp.gate.e_score_correction_bias`` [E] in f32), each
drawn on the device in ``dtype`` in a fixed order from one generator, so the
reference draws the same bits again after the program is freed. Imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib import data, weights

LM_STREAM, PROJECTOR_STREAM = 5, 6


def tower(config: dict) -> dict:
    """The tower's configuration, in the shape of a Whisper cell's file
    (``model``, ``stem``, ``adapters``, ...)."""
    return config["tower"]


def lm_shapes(c: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every leaf of the language model in drawing
    order; kind 'normal' (N(0, init_std)), 'ones' or 'bias' (N(0,
    e_score_correction_bias_std), f32)."""
    d, heads = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    lora, e, w = c["kv_lora_rank"], c["n_routed_experts"], \
        c["moe_intermediate_size"]
    out = [("embed_tokens.weight", (c["vocab_size"], d), "normal")]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "input_layernorm.weight", (d,), "ones"),
            (p + "self_attn.q_proj.weight", (heads * (nope + rope), d),
             "normal"),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (lora + rope, d),
             "normal"),
            (p + "self_attn.kv_a_layernorm.weight", (lora,), "ones"),
            (p + "self_attn.kv_b_proj.weight", (heads * (nope + vd), lora),
             "normal"),
            (p + "self_attn.o_proj.weight", (d, heads * vd), "normal"),
            (p + "post_attention_layernorm.weight", (d,), "ones"),
        ]
        moe = (i >= c["first_k_dense_replace"]
               and i % c["moe_layer_freq"] == 0)
        if moe:
            shared = w * c["n_shared_experts"]
            out += [
                (p + "mlp.gate.weight", (e, d), "normal"),
                (p + "mlp.gate.e_score_correction_bias", (e,), "bias"),
                (p + "mlp.experts.gate_up", (e, d, 2 * w), "normal"),
                (p + "mlp.experts.down", (e, w, d), "normal"),
            ] + [(p + f"mlp.shared_experts.{n}.weight", s, "normal")
                 for n, s in (("gate_proj", (shared, d)),
                              ("up_proj", (shared, d)),
                              ("down_proj", (d, shared)))]
        else:
            f = c["intermediate_size"]
            out += [(p + f"mlp.{n}.weight", s, "normal")
                    for n, s in (("gate_proj", (f, d)), ("up_proj", (f, d)),
                                 ("down_proj", (d, f)))]
    out += [("norm.weight", (d,), "ones"),
            ("lm_head.weight", (c["vocab_size"], d), "normal")]
    return out


def lm_state(c: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The language model's weights from ``seed`` on ``device``: linears,
    embeddings and experts in ``dtype``, RMSNorm weights of ones in
    ``dtype``, the router's correction bias in f32."""
    gen = weights._generator(seed, LM_STREAM, device)
    out = {}
    for name, shape, kind in lm_shapes(c):
        if kind == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "bias":
            out[name] = torch.randn(shape, generator=gen, device=device).mul_(
                c["e_score_correction_bias_std"])
        else:
            out[name] = torch.randn(shape, generator=gen, device=device,
                                    dtype=dtype).mul_(c["init_std"])
    return out


def projector_tree(c: dict, seed: int, device) -> dict:
    """The projector's f32 weights, in the Whisper tree's layout
    (``{"ln": {"scale", "bias"}, "fc1": {"w" [d_in, d_out], "b"}, "fc2":
    ...}``)."""
    d = tower(c)["model"]["d_model"]
    m, out = c["projector"]["merge_frames"], c["hidden_size"]
    gen = weights._generator(seed, PROJECTOR_STREAM, device)
    std = c["projector"]["init_std"]
    w1, w2 = weights._normals([(d * m, out), (out, out)], std, gen, device)
    return {"ln": {"scale": torch.ones(d, device=device),
                   "bias": torch.zeros(d, device=device)},
            "fc1": {"w": w1, "b": torch.zeros(out, device=device)},
            "fc2": {"w": w2, "b": torch.zeros(out, device=device)}}


def pool(c: dict, traffic: dict, seed: int, device):
    """(features bf16 [n, ch, S], labels [n, L], inputs [n, L]) of the mix's
    pool on ``device``: clips as ``lib/data.py::train_pool``'s; labels
    ``real_tokens`` text ids drawn uniformly from the whole vocabulary, then
    -100; inputs ``start_id`` then the labels, -100 read as ``pad_id``."""
    t = tower(c)
    n, s, width = traffic["pool_clips"], t["signal_samples"], \
        traffic["label_len"]
    lengths = data.clip_lengths(traffic, n, seed)
    feats = torch.zeros((n, t["stem"]["in_channels"], s), device=device,
                        dtype=torch.bfloat16)
    feats[..., :int(lengths.max())] = data._signals(t, lengths, seed, device,
                                                    torch.bfloat16)
    draw = data.rng(seed, 12)
    real = draw.permutation(data._spread(*traffic["real_tokens"], n))
    text = draw.integers(0, c["vocab_size"], (n, width))
    labels = np.full((n, width), data.LABEL_IGNORE_ID, dtype=np.int64)
    for i, k in enumerate(real):
        labels[i, :k] = text[i, :k]
    inputs = np.full((n, width), c["pad_id"], dtype=np.int64)
    inputs[:, 0] = c["start_id"]
    inputs[:, 1:] = np.where(labels[:, :-1] == data.LABEL_IGNORE_ID,
                             c["pad_id"], labels[:, :-1])
    return (feats, torch.as_tensor(labels, device=device),
            torch.as_tensor(inputs, device=device))
