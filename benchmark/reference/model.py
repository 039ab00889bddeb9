"""The plain reference of the EEG-Whisper model in float32.

The architecture as published (OpenAI Whisper: pre-LN transformer encoder
and decoder, GELU MLPs, no bias on the key projections, sinusoidal encoder
positions, learned decoder positions, the output projection tied to the
token embedding) with NeuSpeech's 'base' EEG stem in place of the mel
conv1: conv(ch -> d, k3) + GELU + conv(d -> d, k3, stride 2) + GELU, then
Whisper's conv2 (k3, stride 2) + GELU, which maps 6000 samples to 1500
frames. AdaLoRA adapters add x A diag(E) B alpha / r to an adapted linear.

Plain ``torch`` operations on the weight tree of ``benchmark/lib/
weights.py``: no kernels, no cache, attention as a softmax over the whole
score matrix. Callers turn TF32 off (`exact_f32`). Under `precision`
('fp8') the same code is the control: every product's operands rounded
to float8. Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F

ATTN = ("q", "k", "v", "out")

# The control's precision: "fp8" rounds both operands of every product
# (linears, convolutions, attention's two products, the logits) to
# float8 e4m3 with a scale per row, as an fp8 GEMM takes them; gradients
# pass the rounding unchanged. None: float32 throughout.
_PRECISION = contextvars.ContextVar("reference_precision", default=None)
E4M3_MAX = 448.0


@contextlib.contextmanager
def precision(name: Optional[str]):
    """Computes the reference's products in ``name`` ('fp8' or None)."""
    if name not in (None, "fp8"):
        raise ValueError(f"precision {name!r}: None or 'fp8'")
    token = _PRECISION.set(name)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def rounded(x, dim: int = -1):
    """``x`` as a product reads it: under 'fp8', each slice along ``dim``
    scaled to e4m3's range, rounded, scaled back (straight through for the
    gradient)."""
    if _PRECISION.get() is None:
        return x
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(
        min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def matmul(a, b):
    """a @ b with each operand rounded along its reduced dimension."""
    return rounded(a, -1) @ rounded(b, -2)


def conv1d(x, w, b, **kw):
    return F.conv1d(rounded(x, 1), rounded(w, 1), b, **kw)


@contextlib.contextmanager
def exact_f32():
    """Float32 products without TF32, in matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _layer(node, i: int):
    """Layer ``i`` of a stacked subtree."""
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    return node[i]


def adapted_weight(w, entry: Optional[dict]):
    """[d_in, d_out] weight plus the adapter's A diag(E) B alpha / r."""
    if entry is None:
        return w
    a, b = entry["A"], entry["B"]
    scale = entry["alpha"].reshape(()) / a.shape[-1]
    return w + (a * entry["E"][:, 0][None, :]) @ b * scale


def dense(x, p: dict, entry: Optional[dict] = None):
    y = matmul(x, adapted_weight(p["w"], entry))
    return y + p["b"] if "b" in p else y


def layer_norm(x, p: dict):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-5)


def gelu(x):
    return F.gelu(x)


def attend(q, k, v, causal: bool = False):
    """softmax(q k^T / sqrt(dh)) v over the last two axes; ``k`` and ``v``
    may broadcast against ``q`` (one key set for a group of query rows)."""
    scores = matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        tq, tk = scores.shape[-2:]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return matmul(scores.softmax(-1), v)


def _split(x, heads: int):
    """[b, t, d] -> [b, heads, t, d / heads]."""
    b, t, d = x.shape
    return x.view(b, t, heads, d // heads).transpose(1, 2)


def attention(x, kv, p: dict, heads: int, causal: bool = False,
              lora: Optional[dict] = None):
    """Multi-head attention of ``x`` [b, tq, d] over ``kv`` [b, tk, d]."""
    lora = lora or {}
    b, tq, d = x.shape
    q, k, v = (_split(dense(y, p[n], lora.get(n)), heads)
               for y, n in ((x, "q"), (kv, "k"), (kv, "v")))
    out = attend(q, k, v, causal).transpose(1, 2).reshape(b, tq, d)
    return dense(out, p["out"], lora.get("out"))


def encoder(tree: dict, config: dict, signals, lora: Optional[dict] = None):
    """[b, ch, samples] signals -> [b, frames, d] encoder states."""
    m = config["model"]
    enc = tree["encoder"]
    stem = enc["stem"]
    x = gelu(conv1d(signals, stem["conv_a"]["w"], stem["conv_a"]["b"],
                    padding=1))
    x = gelu(conv1d(x, stem["conv_b"]["w"], stem["conv_b"]["b"], stride=2,
                    padding=1))
    x = gelu(conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2,
                    padding=1))
    h = x.transpose(1, 2) + enc["pos_embed"][:x.shape[-1]]
    layers = (lora or {}).get("encoder", {}).get("layers")
    for i in range(m["encoder_layers"]):
        p = _layer(enc["layers"], i)
        ad = layers[i] if layers else {}
        a = layer_norm(h, p["self_attn_ln"])
        h = h + attention(a, a, p["self_attn"], m["encoder_heads"],
                          lora=ad.get("self_attn"))
        a = layer_norm(h, p["final_ln"])
        h = h + dense(gelu(dense(a, p["fc1"], ad.get("fc1"))), p["fc2"],
                      ad.get("fc2"))
    return layer_norm(h, enc["ln_post"])


def cross_kv(tree: dict, config: dict, enc_out) -> list:
    """Each decoder layer's cross-attention keys and values [b, heads, tk,
    dh] of ``enc_out`` [b, tk, d]."""
    m = config["model"]
    out = []
    for i in range(m["decoder_layers"]):
        p = _layer(tree["decoder"]["layers"], i)["cross_attn"]
        out.append(tuple(_split(dense(enc_out, p[n]), m["decoder_heads"])
                         for n in ("k", "v")))
    return out


def decoder(tree: dict, config: dict, tokens, enc_out=None, cross=None,
            last: bool = False):
    """Teacher forcing: token ids [rows, t] over ``enc_out`` [b, tk, d] (or
    its `cross_kv` ``cross``), rows / b consecutive rows to a clip ->
    logits [rows, t, vocab] (``last``: [rows, 1, vocab], the last
    position's)."""
    m = config["model"]
    dec = tree["decoder"]
    heads = m["decoder_heads"]
    if cross is None:
        cross = cross_kv(tree, config, enc_out)
    rows, t = tokens.shape
    b = cross[0][0].shape[0]
    h = dec["token_embed"][tokens] + dec["pos_embed"][:t]
    d = h.shape[-1]
    for i in range(m["decoder_layers"]):
        p = _layer(dec["layers"], i)
        a = layer_norm(h, p["self_attn_ln"])
        h = h + attention(a, a, p["self_attn"], heads, causal=True)
        a = layer_norm(h, p["cross_attn_ln"])
        q = _split(dense(a, p["cross_attn"]["q"]), heads)
        k, v = cross[i]
        out = attend(q.reshape(b, rows // b, *q.shape[1:]), k[:, None],
                     v[:, None]).reshape(rows, heads, t, d // heads)
        h = h + dense(out.transpose(1, 2).reshape(rows, t, d),
                      p["cross_attn"]["out"])
        a = layer_norm(h, p["final_ln"])
        h = h + dense(gelu(dense(a, p["fc1"])), p["fc2"])
    if last:
        h = h[:, -1:]
    return matmul(layer_norm(h, dec["ln"]), dec["token_embed"].T)


def orthogonality(lora: dict):
    """AdaLoRA's regularizer: per adapted matrix (its entries over the
    layers), mean((A^T A - I)^2) + mean((B B^T - I)^2), summed."""
    groups = {}
    for part_name, part in lora.items():
        for layer in part["layers"]:
            for name, node in layer.items():
                entries = node.items() if name == "self_attn" else [
                    (name, node)]
                for target, entry in entries:
                    groups.setdefault((part_name, target), []).append(entry)
    total = 0.0
    for entries in groups.values():
        a = torch.stack([e["A"] for e in entries])
        b = torch.stack([e["B"] for e in entries])
        eye = torch.eye(a.shape[-1], device=a.device)
        total = total + ((a.transpose(1, 2) @ a - eye) ** 2).mean() \
            + ((b @ b.transpose(1, 2) - eye) ** 2).mean()
    return total
