"""The plain reference of the EEG tower before a DeepSeek-V3-style language
model (Kimi-VL-A3B's), in float32, and its replay of the first training
steps.

The tower is ``reference/model.py``'s encoder (NeuSpeech's 'base' stem,
the Whisper encoder with its AdaLoRA adapters). The projector: LayerNorm
over the tower's width, ``merge_frames`` consecutive frames side by side in
one row, Linear, GELU, Linear. The language model as its published
modeling code computes it:

- RMSNorm: w * x / sqrt(mean(x^2) + eps).
- MLA with q uncompressed: q = x W_q, heads of nope + rope dims; kv_a = x
  W_kva; c_kv = RMSNorm(kv_a[:kv_lora_rank]); k_pe = kv_a[kv_lora_rank:],
  one key for every head; [k_nope, v] = c_kv W_kvb; the rope parts of q and
  k_pe de-interleaved (dims 0, 2, ... then 1, 3, ...) and rotated by halves
  at positions x theta^(-2i/d); causal softmax over (nope + rope)^-0.5
  scaled scores; out W_o.
- Dense layers: down(silu(x gate) * x up).
- Routed layers: sigmoid scores of x W_gate; the top-k of score + the
  correction bias chosen, weighted by their unbiased scores over the sum
  (+1e-20) times the routed scaling factor; each expert's SwiGLU over the
  tokens that chose it, one expert at a time, weighted and summed back;
  plus the shared experts' SwiGLU.
- Final RMSNorm, the untied head at the text positions.

A routed layer's choices are discrete, as a decode's tokens are: in bf16
some tokens' k-th and (k+1)-th experts trade places against f32, and one
trade moves a token's states as much as a fault would. So the replay may
follow a program's choices (``routes``), as a decode cell's reference reads
the served tokens: it weights the followed experts by its own unbiased
scores, and reads how far each followed choice lies below its own k-th
best biased score (`select`'s gap; a token given fewer than k choices
counts as having chosen the worst-scored expert) and how many tokens'
followed choices are not its own top k (`select`'s miss). Where the given
choices do not cover a block's tokens (a program that ran fewer rows), the
reference chooses for that block itself.

Plain ``torch`` operations on the weights of ``lib/llm_inputs.py``; no
kernels, no cache, no batching tricks: attention over the whole score
matrix. The language model's weights stay as drawn (bf16 on the card) and
each layer is cast to f32 when it runs. For the gradients `loss_and_grads`
takes ``reference_rows`` rows at a time and runs the language model's
backward one layer at a time (each layer's forward again from its saved
input), so that one layer's f32 weights and activations are live at once.
Under ``ref.precision('fp8')`` every product's operands round to e4m3,
the control. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.lib import data, llm_inputs, weights
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train


def rms_norm(x, w, eps: float):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_tables(c: dict, t: int, device):
    d = c["qk_rope_head_dim"]
    inv = 1.0 / (c["rope_theta"] ** (torch.arange(0, d, 2, device=device,
                                                  dtype=torch.float32) / d))
    freqs = torch.arange(t, device=device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """x [b, t, heads, d], adjacent dims paired (DeepSeek's layout)."""
    b, t, h, d = x.shape
    x = x.view(b, t, h, d // 2, 2).transpose(-1, -2).reshape(b, t, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[:, None] + half * sin[:, None]


def linear(x, w):
    """x W^T for a weight [out, in]."""
    return ref.matmul(x, w.T)


def layer_weights(lm: Dict[str, torch.Tensor], i: int) -> dict:
    """Layer ``i``'s weights in f32, by their names inside the layer."""
    p = f"layers.{i}."
    return {k[len(p):]: v.float() for k, v in lm.items() if k.startswith(p)}


def mla(x, p: dict, c: dict, cos, sin):
    b, t, _ = x.shape
    h = c["num_attention_heads"]
    nope, rot, vd, lora = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                           c["v_head_dim"], c["kv_lora_rank"])
    q = linear(x, p["self_attn.q_proj.weight"]).view(b, t, h, nope + rot)
    kv_a = linear(x, p["self_attn.kv_a_proj_with_mqa.weight"])
    c_kv, k_pe = kv_a[..., :lora], kv_a[..., lora:]
    kv = linear(rms_norm(c_kv, p["self_attn.kv_a_layernorm.weight"],
                         c["rms_norm_eps"]),
                p["self_attn.kv_b_proj.weight"]).view(b, t, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], -1)
    k_pe = apply_rope(k_pe[:, :, None], cos, sin).expand(b, t, h, rot)
    k = torch.cat([k_nope, k_pe], dim=-1)
    o = ref.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal=True)
    return linear(o.transpose(1, 2).reshape(b, t, h * vd),
                  p["self_attn.o_proj.weight"])


def swiglu(x, p: dict, prefix: str):
    return linear(F.silu(linear(x, p[prefix + "gate_proj.weight"]))
                  * linear(x, p[prefix + "up_proj.weight"]),
                  p[prefix + "down_proj.weight"])


def select(x, p: dict, c: dict, forced=None):
    """(expert ids [T, k], weights [T, k], gap, miss) of tokens ``x`` [T,
    d]: the top-k of score + bias, or the choices ``forced`` [T, k'],
    weighted by the unbiased scores; ``gap`` is the most a followed choice
    lies below the k-th best biased score, ``miss`` the number of tokens
    whose followed choices are not the top-k of score + bias (both 0 when
    choosing)."""
    scores = torch.sigmoid(linear(x, p["mlp.gate.weight"]))
    biased = scores.detach() + p["mlp.gate.e_score_correction_bias"]
    k = c["num_experts_per_tok"]
    best = torch.topk(biased, k, dim=-1)
    idx, gap, miss = best.indices, 0.0, 0
    if forced is not None:
        idx = forced.to(x.device)
        low = (biased.gather(1, idx).min(-1).values if idx.shape[1] >= k
               else biased.min(-1).values)
        gap = float((best.values[:, -1] - low).clamp(min=0).max())
        own = torch.zeros_like(biased, dtype=torch.bool).scatter_(
            1, best.indices, True)
        miss = (x.shape[0] if idx.shape[1] != k
                else int((~own.gather(1, idx)).any(-1).sum()))
    w = scores.gather(1, idx)
    if c["norm_topk_prob"] and idx.shape[1] > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"], gap, miss


def moe(x, p: dict, c: dict, forced=None):
    """(states, expert ids, gap, miss) of a routed layer's MLP
    (`select`)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    idx, w, gap, miss = select(xf, p, c, forced)
    width = c["moe_intermediate_size"]
    y = torch.zeros_like(xf)
    for e in range(c["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = p["mlp.experts.gate_up"][e]
        xe = xf[tok]
        act = F.silu(ref.matmul(xe, gu[:, :width])) * ref.matmul(
            xe, gu[:, width:])
        out = ref.matmul(act, p["mlp.experts.down"][e])
        y = y.index_add(0, tok, out * w[tok, slot][:, None])
    y = y + swiglu(xf, p, "mlp.shared_experts.")
    return y.view(b, t, d), idx, gap, miss


def routed(c: dict, i: int) -> bool:
    return i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0


def layer(h, p: dict, c: dict, i: int, cos, sin, forced=None):
    """(states, expert ids or None, gap, miss) of layer ``i``."""
    eps = c["rms_norm_eps"]
    h = h + mla(rms_norm(h, p["input_layernorm.weight"], eps), p, c, cos,
                sin)
    x = rms_norm(h, p["post_attention_layernorm.weight"], eps)
    if not routed(c, i):
        return h + swiglu(x, p, "mlp."), None, 0.0, 0
    y, idx, gap, miss = moe(x, p, c, forced)
    return h + y, idx, gap, miss


def head(h, lm: dict, c: dict):
    return linear(rms_norm(h, lm["norm.weight"].float(), c["rms_norm_eps"]),
                  lm["lm_head.weight"].float())


def prefix(tree: dict, lora: dict, proj: dict, c: dict, signals):
    """[b, ch, samples] -> the projected tower frames [b, frames / m,
    hidden]."""
    enc = ref.encoder(tree, llm_inputs.tower(c), signals, lora)
    b, t, d = enc.shape
    m = c["projector"]["merge_frames"]
    x = ref.layer_norm(enc, proj["ln"]).reshape(b, t // m, d * m)
    return ref.dense(ref.gelu(ref.dense(x, proj["fc1"])), proj["fc2"])


def embed(lm: dict, prefix_states, inputs):
    """The language model's input: the prefix, then the embeddings of
    ``inputs`` (ids of the vocabulary: the pool maps the labels' -100 to
    the pad id)."""
    tok = lm["embed_tokens.weight"][inputs].float()
    return torch.cat([prefix_states, tok], dim=1)


def logits(tree, lora, proj, lm, c: dict, signals, inputs):
    """Logits [b, L, vocab] at the text positions, differentiable through
    the whole model (small sizes: every layer's f32 weights stay live)."""
    h = embed(lm, prefix(tree, lora, proj, c, signals), inputs)
    cos, sin = rope_tables(c, h.shape[1], h.device)
    for i in range(c["num_hidden_layers"]):
        h = layer(h, layer_weights(lm, i), c, i, cos, sin)[0]
    return head(h[:, -inputs.shape[1]:], lm, c)


def cross_entropy(lg, labels, n_tokens: int):
    keep = labels != data.LABEL_IGNORE_ID
    logp = lg.log_softmax(-1)
    picked = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return -(picked * keep).sum() / n_tokens


def loss_and_grads(tree, lora, proj, lm, c: dict, feats, labels, inputs,
                   rows: int, routes=None) -> tuple:
    """(loss, choices, gap, misses) of one batch: the cross entropy (plus
    AdaLoRA's orthogonality loss at its weight), its gradients accumulated
    into the trainable leaves' ``.grad``: ``rows`` rows at a time, the
    language model's backward one layer at a time from each layer's saved
    input, along the same choices as its forward. ``routes``: choices to
    follow, one [batch x positions, k] per routed layer (rows major);
    ``choices`` those taken, in the same form; ``gap`` the widest of
    `select`'s; ``misses`` the (token, routed layer) pairs whose followed
    choices missed (`select`'s miss, summed) and all such pairs read."""
    n_tokens = int((labels != data.LABEL_IGNORE_ID).sum())
    n_layers = c["num_hidden_layers"]
    taken = {i: [] for i in range(n_layers) if routed(c, i)}
    total, widest, missed, pairs = 0.0, 0.0, 0, 0
    for lo in range(0, feats.shape[0], rows):
        sl = slice(lo, lo + rows)
        h0 = embed(lm, prefix(tree, lora, proj, c, feats[sl].float()),
                   inputs[sl])
        t = h0.shape[1]
        span = slice(lo * t, (lo + h0.shape[0]) * t)
        forced = {}
        if routes is not None and all(r.shape[0] >= span.stop
                                      for r in routes):
            forced = {i: r[span] for i, r in zip(taken, routes)}
        cos, sin = rope_tables(c, t, h0.device)
        saved = []
        with torch.no_grad():
            h = h0
            for i in range(n_layers):
                saved.append(h)
                h, idx, gap, miss = layer(h, layer_weights(lm, i), c, i,
                                          cos, sin, forced.get(i))
                if idx is not None:
                    forced[i] = idx
                    taken[i].append(idx)
                    widest = max(widest, gap)
                    missed, pairs = missed + miss, pairs + idx.shape[0]
        h = h.detach().requires_grad_(True)
        ce = cross_entropy(head(h[:, -inputs.shape[1]:], lm, c), labels[sl],
                           n_tokens)
        ce.backward()
        g, total = h.grad, total + float(ce.detach())
        for i in reversed(range(n_layers)):
            x = saved[i].detach().requires_grad_(True)
            layer(x, layer_weights(lm, i), c, i, cos, sin,
                  forced.get(i))[0].backward(g)
            g = x.grad
        h0.backward(g)
    weight = llm_inputs.tower(c)["adapters"]["orth_reg_weight"]
    if weight:
        reg = weight * ref.orthogonality(lora)
        reg.backward()
        total += float(reg.detach())
    return (total, [torch.cat(v).cpu() for v in taken.values()], widest,
            (missed, pairs))


def trainable(tree: dict, lora: dict, proj: dict) -> Dict[str, torch.Tensor]:
    """The trainable leaves by the program's paths: the Whisper recipe's
    (``reference/train.py::trainable``) and ``model/projector/...``."""
    out = ref_train.trainable(tree, lora)
    out["model/projector/ln/scale"] = proj["ln"]["scale"]
    out["model/projector/ln/bias"] = proj["ln"]["bias"]
    for name in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            out[f"model/projector/{name}/{leaf}"] = proj[name][leaf]
    return out


def replay(config: dict, traffic: dict, seed: int, batches: List, device,
           precision=None, routes=None) -> dict:
    """The reference's first ``len(batches)`` steps on the seed's weights
    and the pool rows ``batches`` (index tensors), as
    ``reference/train.py::replay`` gives them: ``losses``, ``grad``,
    ``grad_raw`` and ``change`` per trainable leaf; and ``routes`` (per
    step, the choices taken, as `loss_and_grads` gives them),
    ``route_gap`` (the widest gap of a followed choice) and
    ``route_miss_share`` (the share of (token, routed layer) pairs over the
    steps whose followed choices are not the reference's own top k). ``routes``: per
    step, the choices to follow (a program's), or None. The language model
    is drawn in ``lm_dtype`` and stays so."""
    opt = traffic["optimizer"]
    if opt["weight_decay"]:
        raise NotImplementedError("the reference replays AdamW without "
                                  "weight decay, as the recipe runs it")
    tcfg = llm_inputs.tower(config)
    with ref.exact_f32():
        lm = llm_inputs.lm_state(config, seed, device,
                                 getattr(torch, config["lm_dtype"]))
        tree = weights.param_tree(tcfg, seed, device)
        lora = weights.adapter_tree(tcfg, seed, device)
        proj = llm_inputs.projector_tree(config, seed, device)
        feats, labels, inputs = llm_inputs.pool(config, traffic, seed, device)
        leaves = trainable(tree, lora, proj)
        start = {k: v.detach().clone() for k, v in leaves.items()}
        for v in leaves.values():
            v.requires_grad_(True)
        mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        out = {"losses": [], "routes": [], "route_gap": 0.0}
        missed, pairs = 0, 0
        for count, idx in enumerate(batches):
            for v in leaves.values():
                v.grad = None
            idx = torch.as_tensor(idx, device=device)
            with ref.precision(precision):
                loss, taken, gap, misses = loss_and_grads(
                    tree, lora, proj, lm, config, feats[idx], labels[idx],
                    inputs[idx], traffic["reference_rows"],
                    None if routes is None else routes[count])
            out["losses"].append(loss)
            out["routes"].append(taken)
            out["route_gap"] = max(out["route_gap"], gap)
            missed, pairs = missed + misses[0], pairs + misses[1]
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
                lr = ref_train._lr(opt, count)
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
        out["route_miss_share"] = missed / max(pairs, 1)
    return out
