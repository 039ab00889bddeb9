"""Whisper-style encoder-decoder in PyTorch: the port of
``neuspeech1_tpu/models/whisper.py`` for serving (encoder, cached greedy
decoding) and training (the teacher-forcing forward with LoRA adapters and
the cross-entropy loss with its custom backward).

Parameters live in ``nn.Module``s whose attribute names follow the JAX
parameter tree (``models/convert.py`` maps one onto the other). Layers sit in
``nn.ModuleList``s instead of stacked ``[L, ...]`` arrays. Compute runs in
``config.dtype``; a weight held in another dtype is cast at each use, as
the JAX package casts its f32 master weights. A serving model holds its
weights in the compute dtype (no casts), a training model f32 masters.

Public functions keep the JAX package's layouts: features [B, ch, T],
attention in BTHD, decode caches ``k_t``/``v_t`` as [B, H, Dh, T].
Attention goes through ``ops.flash_attention`` (the Hopper kernels on CUDA
tensors) where the JAX package takes its flash kernel: encoder
self-attention, and teacher-forcing decoder cross- and self-attention from
the ``decoder_flash_*_min_q`` lengths on. Elsewhere it is plain tensor code,
as it is XLA in the JAX package, with the same rounding points: scores from
a product in the compute dtype, softmax in f32, probabilities cast back to
the compute dtype for the PV product.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuspeech1_tpu.config import StemConfig, WhisperConfig
from neuspeech1_tpu_torch.models.lora import folded_linear, lora_delta
from neuspeech1_tpu_torch.ops.flash_attention import flash_attention_bthd

# --------------------------------------------------------------------------
# modules (parameter holders; attribute names follow the JAX tree)
# --------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)  # whisper: no k bias
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, ffn: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.self_attn_ln = nn.LayerNorm(d)
        self.self_attn = Attention(d)
        self.final_ln = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)

    def forward(self, h, use_flash: bool = True, lora=None):
        lora = lora or {}
        x = layer_norm(h, self.self_attn_ln)
        h = h + self_attention(x, self.self_attn, self.n_heads, use_flash,
                               lora=lora.get("self_attn"))
        return h + mlp(layer_norm(h, self.final_ln), self, lora)


class DecoderLayer(nn.Module):
    def __init__(self, d: int, ffn: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.self_attn_ln = nn.LayerNorm(d)
        self.self_attn = Attention(d)
        self.cross_attn_ln = nn.LayerNorm(d)
        self.cross_attn = Attention(d)
        self.final_ln = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)

    def forward(self, h, enc_out, self_mask, self_cache=None,
                cross_cache=None, cache_index: Optional[int] = None,
                lora=None, flash_self: bool = False,
                flash_cross: bool = False):
        """Teacher forcing without caches, self-attention causal through
        flash with ``flash_self`` (else under ``self_mask``) and
        cross-attention through flash with ``flash_cross``; one incremental
        step with caches (updated in place)."""
        lora = lora or {}
        x = layer_norm(h, self.self_attn_ln)
        if self_cache is None:
            x = self_attention(x, self.self_attn, self.n_heads,
                               use_flash=flash_self,
                               mask=None if flash_self else self_mask,
                               lora=lora.get("self_attn"), causal=True)
        else:
            x = self_decode_dt(x, self.self_attn, self.n_heads, self_cache,
                               cache_index, self_mask)
        h = h + x
        x = layer_norm(h, self.cross_attn_ln)
        if cross_cache is None:
            # the encoder runs unpadded: no encoder row needs masking
            x = cross_attention(x, enc_out, self.cross_attn, self.n_heads,
                                flash_cross, kv_len=None,
                                lora=lora.get("cross_attn"))
        else:
            x = cross_decode_dt(x, self.cross_attn, self.n_heads, cross_cache)
        h = h + x
        return h + mlp(layer_norm(h, self.final_ln), self, lora)


class EEGStem(nn.Module):
    """Projection stem over [B, ch, T] signals (``config.StemConfig``):

    'speech':  gelu(conv1(mel))               k3 s1
    'base':    gelu(conv_b(gelu(conv_a(x))))  a: k3 s1, b: k3 s2
    'replace': gelu(conv(x))                  k3 s2
    'premel':  gelu(conv1(pre_conv(x)))       pre: k5 s2 p2, conv1: k3 s1

    Channel dropout of 'premel' is a training feature and is not ported yet.
    """

    def __init__(self, config: WhisperConfig, stem: StemConfig):
        super().__init__()
        self.kind = stem.kind
        d, ch = config.d_model, stem.in_channels
        if stem.kind == "speech":
            self.conv1 = nn.Conv1d(config.num_mel_bins, d, 3, padding=1)
        elif stem.kind == "base":
            self.conv_a = nn.Conv1d(ch, d, 3, padding=1)
            self.conv_b = nn.Conv1d(d, d, 3, stride=2, padding=1)
        elif stem.kind == "replace":
            self.conv = nn.Conv1d(ch, d, 3, stride=2, padding=1)
        elif stem.kind == "premel":
            self.pre_conv = nn.Conv1d(ch, config.num_mel_bins, 5, stride=2,
                                      padding=2)
            self.conv1 = nn.Conv1d(config.num_mel_bins, d, 3, padding=1)
        else:
            raise ValueError(stem.kind)

    def forward(self, x):
        """[B, T, ch] channels-last -> [B, T', d]."""
        if self.kind == "speech":
            return gelu(conv1d_cl(x, self.conv1))
        if self.kind == "base":
            return gelu(conv1d_cl(gelu(conv1d_cl(x, self.conv_a)), self.conv_b))
        if self.kind == "replace":
            return gelu(conv1d_cl(x, self.conv))
        return gelu(conv1d_cl(conv1d_cl(x, self.pre_conv), self.conv1))


class Encoder(nn.Module):
    def __init__(self, config: WhisperConfig, stem: StemConfig):
        super().__init__()
        d = config.d_model
        self.stem = EEGStem(config, stem)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.pos_embed = nn.Parameter(torch.zeros(config.max_source_positions, d))
        self.layers = nn.ModuleList(
            EncoderLayer(d, config.encoder_ffn, config.encoder_heads)
            for _ in range(config.encoder_layers))
        self.ln_post = nn.LayerNorm(d)


class Decoder(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        d = config.d_model
        self.token_embed = nn.Embedding(config.vocab_size, d)
        self.pos_embed = nn.Parameter(torch.zeros(config.max_target_positions, d))
        self.layers = nn.ModuleList(
            DecoderLayer(d, config.decoder_ffn, config.decoder_heads)
            for _ in range(config.decoder_layers))
        self.ln = nn.LayerNorm(d)


class Whisper(nn.Module):
    """The whole model. The output projection is tied to
    ``decoder.token_embed``."""

    def __init__(self, config: WhisperConfig, stem: StemConfig):
        super().__init__()
        self.config = config
        self.stem_config = stem
        self.encoder = Encoder(config, stem)
        self.decoder = Decoder(config)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype, ``config.dtype``; the weights may be held in
        another (a training model's f32 masters)."""
        return getattr(torch, self.config.dtype)

    def forward(self, features, decoder_input_ids, lora=None):
        """``forward(self, ...)``: lets ``torch.func.functional_call`` run
        the model on substituted (merged) weights."""
        return forward(self, features, decoder_input_ids, lora)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

# Set by `fold_at_linear` (the training step's 'fc' fold regime): adapted
# linears run one product against W_eff = W + s A (E) B with the low-rank-only
# backward of `models/lora.py::folded_linear`, instead of a per-token delta.
_FOLD_AT_LINEAR = [False]


@contextlib.contextmanager
def fold_at_linear():
    prev = _FOLD_AT_LINEAR[0]
    _FOLD_AT_LINEAR[0] = True
    try:
        yield
    finally:
        _FOLD_AT_LINEAR[0] = prev


def _cast(t, dtype):
    """``t`` in ``dtype``; no copy when it already is (a serving model's
    weights), a differentiable cast when not (a training model's masters)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def linear(x, p: nn.Linear, lora=None):
    """x W^T + b, plus the low-rank delta of a LoRA ``lora`` entry: folded
    into the weight under `fold_at_linear`, per token otherwise."""
    if lora is not None and _FOLD_AT_LINEAR[0]:
        return folded_linear(x, p, lora)
    y = F.linear(x, _cast(p.weight, x.dtype), _cast(p.bias, x.dtype))
    if lora is not None:
        y = y + lora_delta(x, lora)
    return y


def layer_norm(x, p: nn.LayerNorm, eps: float = 1e-5):
    return F.layer_norm(x, p.normalized_shape, _cast(p.weight, x.dtype),
                        _cast(p.bias, x.dtype), eps)


def gelu(x):
    """Exact erf GELU (the JAX package's ``ops/gelu.py`` is a fast erf within
    6.1e-7 of it)."""
    return F.gelu(x, approximate="none")


def conv1d_cl(x, p: nn.Conv1d):
    """Channels-last 1-D conv: [B, T, C] -> [B, T', O], torch kernel
    [O, C, k]; stride and padding are the module's."""
    return F.conv1d(x.transpose(1, 2), _cast(p.weight, x.dtype),
                    _cast(p.bias, x.dtype), p.stride, p.padding).transpose(1, 2)


def mlp(x, layer, lora=None):
    lora = lora or {}
    h = gelu(linear(x, layer.fc1, lora.get("fc1")))
    return linear(h, layer.fc2, lora.get("fc2"))


def apply_stem(model: Whisper, features):
    """[B, ch, T] -> [B, T', d]: the projection stem, then whisper's conv2
    (k3 s2) under gelu."""
    h = model.encoder.stem(features.transpose(1, 2))
    return gelu(conv1d_cl(h, model.encoder.conv2))


def _split_heads(x, n_heads: int):
    b, t, d = x.shape
    return x.view(b, t, n_heads, d // n_heads)


def _merge_heads(x):
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def attention(q, k, v, mask=None):
    """Plain attention on BTHD tensors: scores in the compute dtype, f32
    softmax, probabilities cast back for PV (the JAX package's XLA path)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * dh ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def self_attention(x, p: Attention, n_heads: int, use_flash: bool,
                   mask=None, lora=None, causal: bool = False):
    """Self-attention; the flash path applies ``causal`` as its mask, the
    plain path ``mask``."""
    lora = lora or {}
    q = _split_heads(linear(x, p.q, lora.get("q")), n_heads)
    k = _split_heads(linear(x, p.k, lora.get("k")), n_heads)
    v = _split_heads(linear(x, p.v, lora.get("v")), n_heads)
    if use_flash:
        out = flash_attention_bthd(q, k, v, causal=causal)
    else:
        out = attention(q, k, v, mask)
    return linear(_merge_heads(out), p.out, lora.get("out"))


def cross_attention(x, enc_out, p: Attention, n_heads: int,
                    use_flash: bool = False, kv_len: Optional[int] = None,
                    lora=None):
    """Cross-attention over ``enc_out``; ``kv_len`` masks encoder rows at or
    past it on the flash path (the plain path takes unpadded states)."""
    lora = lora or {}
    q = _split_heads(linear(x, p.q, lora.get("q")), n_heads)
    k = _split_heads(linear(enc_out, p.k, lora.get("k")), n_heads)
    v = _split_heads(linear(enc_out, p.v, lora.get("v")), n_heads)
    if use_flash:
        out = flash_attention_bthd(q, k, v, kv_len=kv_len)
    else:
        out = attention(q, k, v)
    return linear(_merge_heads(out), p.out, lora.get("out"))


def self_decode_dt(x, p: Attention, n_heads: int, cache: dict,
                   cache_index: int, mask):
    """Incremental self-attention on the [B, H, Dh, Tmax] cache: the new
    K/V columns are written at ``cache_index`` in place (the JAX package
    returns an updated copy), then all Tmax columns are scored under
    ``mask``."""
    q = _split_heads(linear(x, p.q), n_heads)
    t = q.shape[1]
    k_t, v_t = cache["k_t"], cache["v_t"]
    k_t[..., cache_index:cache_index + t] = (
        _split_heads(linear(x, p.k), n_heads).permute(0, 2, 3, 1))
    v_t[..., cache_index:cache_index + t] = (
        _split_heads(linear(x, p.v), n_heads).permute(0, 2, 3, 1))
    return linear(_merge_heads(_attend_t(q, k_t, v_t, mask)), p.out)


def cross_decode_dt(x, p: Attention, n_heads: int, cache: dict):
    q = _split_heads(linear(x, p.q), n_heads)
    out = _attend_t(q, cache["k_t"], cache["v_t"])
    return linear(_merge_heads(out), p.out)


def _attend_t(q, k_t, v_t, mask=None):
    """q [B, q, H, Dh] against transposed K/V [B, H, Dh, T] -> [B, q, H, Dh]."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bhdk->bhqk", q, k_t).float() * dh ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhdk->bqhd", probs, v_t)


# --------------------------------------------------------------------------
# encoder / decoder
# --------------------------------------------------------------------------

def resolve_flash(model: Whisper) -> bool:
    """The flash path runs unless the config turns it off. On the card it
    launches the kernel, which raises for a head dim or dtype it does not
    take rather than falling back to plain attention; CPU tensors run its
    plain version, which takes any."""
    return model.config.flash_attention != "off"


def _layer_lora(lora, part: str):
    """The per-layer adapter list of ``part`` in a LoRA tree, or None."""
    return ((lora or {}).get(part) or {}).get("layers")


def encoder_apply(model: Whisper, features, lora=None):
    """[B, ch, T] -> [B, T', d] encoder states, T' == max_source_positions;
    ``lora`` is an adapter tree (``models/lora.py``).

    T' runs unpadded: the flash kernel masks the ragged last tile itself
    (the JAX package pads to a 128-row multiple for its TPU tiling)."""
    config = model.config
    h = apply_stem(model, _cast(features, model.dtype))
    t = h.shape[1]
    if t != config.max_source_positions:
        raise ValueError(
            f"stem produced {t} frames, expected {config.max_source_positions}"
            " — input length must be 4x the source positions (stride 2 x 2)")
    h = h + _cast(model.encoder.pos_embed[:t], h.dtype)
    flash = resolve_flash(model)
    layers_lora = _layer_lora(lora, "encoder")
    for i, layer in enumerate(model.encoder.layers):
        h = layer(h, flash, None if layers_lora is None else layers_lora[i])
    return layer_norm(h, model.encoder.ln_post)


def decoder_apply(model: Whisper, tokens, enc_out, cache=None,
                  cache_index: Optional[int] = None, lora=None):
    """Token ids [B, T] -> logits [B, T, vocab].

    Without ``cache``: causal teacher forcing over ``enc_out``, with the
    JAX package's flash gates: from ``config.decoder_flash_min_q`` tokens
    on, cross-attention goes through flash at T >= ``decoder_flash_cross_min_q``
    and causal self-attention at T >= ``decoder_flash_self_min_q``.
    With ``cache`` (from `init_cache`): one incremental step writing
    positions ``cache_index .. cache_index + T - 1``; returns (logits,
    cache) with the cache updated in place."""
    dec = model.decoder
    config = model.config
    t = tokens.shape[1]
    h = _cast(F.embedding(tokens, dec.token_embed.weight), model.dtype)
    if cache is None:
        h = h + _cast(dec.pos_embed[:t], h.dtype)
        mask = torch.ones((t, t), dtype=torch.bool,
                          device=h.device).tril()[None, None]
        enc_out = _cast(enc_out, h.dtype)
        use_flash = resolve_flash(model) and t >= config.decoder_flash_min_q
        flash_self = use_flash and t >= config.decoder_flash_self_min_q
        flash_cross = use_flash and t >= config.decoder_flash_cross_min_q
        layers_lora = _layer_lora(lora, "decoder")
        for i, layer in enumerate(dec.layers):
            h = layer(h, enc_out, mask,
                      lora=None if layers_lora is None else layers_lora[i],
                      flash_self=flash_self, flash_cross=flash_cross)
    else:
        h = h + _cast(dec.pos_embed[cache_index:cache_index + t], h.dtype)
        t_max = cache["self"][0]["k_t"].shape[-1]
        positions = torch.arange(t_max, device=h.device)
        rows = cache_index + torch.arange(t, device=h.device)
        mask = (positions[None, :] <= rows[:, None])[None, None]
        for layer, sc, cc in zip(dec.layers, cache["self"], cache["cross"]):
            h = layer(h, None, mask, self_cache=sc, cross_cache=cc,
                      cache_index=cache_index)
    h = layer_norm(h, dec.ln)
    logits = F.linear(h, _cast(dec.token_embed.weight, h.dtype))
    return logits if cache is None else (logits, cache)


def init_cache(model: Whisper, enc_out, max_len: int, int8_cross: bool = False,
               cross_layout: str = "bhtd", self_t_major: bool = False):
    """Decode caches for the default layout: per layer, cross K/V
    precomputed from ``enc_out`` as ``k_t``/``v_t`` [B, H, Dh, T_src] and
    zeroed self K/V ``k_t``/``v_t`` [B, H, Dh, max_len], in the model dtype.

    The JAX package's int8 cross cache (``int8_cross``), its 'btc' cross
    layout and its speculative-decode self caches (``self_t_major``) are
    not ported yet: they raise (ROADMAP.md queue 1)."""
    if int8_cross or cross_layout != "bhtd" or self_t_major:
        raise NotImplementedError(
            "only the 'bhtd' k_t cache layout is ported; the int8 and 'btc' "
            "cross caches and the speculative self caches are queued in "
            "ROADMAP.md")
    config = model.config
    b = enc_out.shape[0]
    h = config.decoder_heads
    dh = config.d_model // h
    enc_out = enc_out.to(model.dtype)
    cross: List[dict] = []
    selfc: List[dict] = []
    for layer in model.decoder.layers:
        ca = layer.cross_attn
        cross.append({
            "k_t": _split_heads(linear(enc_out, ca.k), h).permute(0, 2, 3, 1)
            .contiguous(),
            "v_t": _split_heads(linear(enc_out, ca.v), h).permute(0, 2, 3, 1)
            .contiguous(),
        })
        selfc.append({
            name: torch.zeros((b, h, dh, max_len), dtype=model.dtype,
                              device=enc_out.device)
            for name in ("k_t", "v_t")})
    return {"self": selfc, "cross": cross}


def forward(model: Whisper, features, decoder_input_ids, lora=None):
    """Teacher-forcing forward: logits [B, T, vocab]."""
    return decoder_apply(model, decoder_input_ids,
                         encoder_apply(model, features, lora), lora=lora)


class CrossEntropy(torch.autograd.Function):
    """The JAX package's ``ce_loss`` with its custom backward. Forward:
    logsumexp - picked logit per token in f32, clamped at 0, masked at
    ``ignore_id`` and divided by max(n, 1). Backward: (softmax - onehot) * w
    in the logits' dtype, from the saved f32 lse; the clamp passes the
    gradient through (autograd through it would zero it where it binds)."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_id: int):
        mask = labels != ignore_id
        safe = torch.where(mask, labels, 0)
        m = logits.amax(dim=-1).float()  # exact in the logits dtype
        lse = torch.log(torch.exp(logits.float() - m[..., None]).sum(-1)) + m
        picked = logits.gather(-1, safe[..., None])[..., 0].float()
        nll = torch.clamp(lse - picked, min=0.0)
        n = mask.sum().clamp(min=1)
        ctx.save_for_backward(logits, safe, mask, lse, n)
        return (nll * mask).sum() / n

    @staticmethod
    def backward(ctx, g):
        logits, safe, mask, lse, n = ctx.saved_tensors
        w = (g * mask.float() / n.float())[..., None]
        probs = torch.exp(logits.float() - lse[..., None])
        probs.scatter_add_(-1, safe[..., None],
                           torch.full_like(lse[..., None], -1.0))
        return (probs * w).to(logits.dtype), None, None


def ce_loss(logits, labels, ignore_id: int = -100):
    """Token-mean cross entropy over logits [B, T, V] with labels [B, T]
    (``ignore_id`` masked), differentiable through `CrossEntropy`."""
    return CrossEntropy.apply(logits, labels, ignore_id)
