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
attention in BTHD, the decode cross cache ``k``/``v`` as [B, H, T_src, Dh]
(or int8 ``k_qt``/``v_qt`` [B, H, Dh, T_src] with scales ``k_s``/``v_s``
[B, H, 1, Dh]) and the self cache ``k_t``/``v_t`` (greedy and beam) or
``k_tu``/``v_tu`` (speculative decoding) as [B, H, Dh, Tmax].
Attention goes through ``ops.flash_attention`` (the Hopper kernels on CUDA
tensors) where the JAX package takes its flash kernel: encoder
self-attention, and teacher-forcing decoder cross- and self-attention from
the ``decoder_flash_*_min_q`` lengths on. Under ``config.remat`` each
encoder layer of a forward that records gradients runs under a checkpoint
(`REMAT_POLICIES`). Under ``ops.int8_matmul.int8_mode`` every `linear`
runs its product as an int8 matmul (the LoRA delta stays exact), and a
training forward given dropout draws (`draw_dropout`) applies the stem's
channel dropout and the frame dropout. The cached decoder goes through
the decode kernels: every cross-attention call on the bf16 cache through
``ops.decode_cross`` (K6), every width-1 self-attention step on a ``k_t``
cache through ``ops.decode_step`` (K7) and every call on a ``k_tu`` cache
through ``ops.decode_step_multi`` (K8). With ``config.flash_attention ==
"off"`` all of these run their plain versions. Under a config's
``seq_parallel_axis`` the encoder's self-attention is ring attention over
that axis of the ambient mesh (``parallel/ring_attention.py``, K4 in every
round). Elsewhere attention is plain
tensor code, as it is XLA in the JAX package (the int8 cross cache
included), with the same rounding points: scores from a product in the
compute dtype, softmax in f32, probabilities cast back to the compute dtype
for the PV product.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig
from neuspeech1_tpu_torch.models.lora import folded_linear, lora_delta
from neuspeech1_tpu_torch.models.quantize import quantize_int8
from neuspeech1_tpu_torch.ops import int8_matmul
from neuspeech1_tpu_torch.ops.decode_cross import decode_cross, decode_cross_plain
from neuspeech1_tpu_torch.ops.decode_step import (
    decode_step, decode_step_multi, decode_step_multi_plain, decode_step_plain)
from neuspeech1_tpu_torch.ops.flash_attention import flash_attention_bthd
from neuspeech1_tpu_torch.parallel.mesh import axis_ring
from neuspeech1_tpu_torch.parallel.ring_attention import (
    SHARD_QUANTUM, gather_seq, ring_attention_local, shard_seq)

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

    def forward(self, h, use_flash: bool = True, lora=None, ring=None,
                kv_valid_len: Optional[int] = None):
        """With ``ring``, ``h`` is this rank's sequence shard and the
        self-attention is ring attention masking keys at or past
        ``kv_valid_len`` (K4 with ``use_flash``, its plain versions
        without)."""
        lora = lora or {}
        x = layer_norm(h, self.self_attn_ln)
        h = h + self_attention(x, self.self_attn, self.n_heads, use_flash,
                               lora=lora.get("self_attn"), ring=ring,
                               kv_valid_len=kv_valid_len)
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
                flash_cross: bool = False, kernels: bool = True):
        """Teacher forcing without caches, self-attention causal through
        flash with ``flash_self`` (else under ``self_mask``) and
        cross-attention through flash with ``flash_cross``; one incremental
        step with caches (updated in place), through the decode kernels
        with ``kernels`` and their plain versions without. ``lora`` (this
        layer's adapters) applies on both paths; with caches, as in the JAX
        package, to self-attention's q, k, v and out, cross-attention's q
        and out (its K/V come from the cache), and the MLP."""
        lora = lora or {}
        x = layer_norm(h, self.self_attn_ln)
        if self_cache is None:
            x = self_attention(x, self.self_attn, self.n_heads,
                               use_flash=flash_self,
                               mask=None if flash_self else self_mask,
                               lora=lora.get("self_attn"), causal=True)
        else:
            x = self_decode(x, self.self_attn, self.n_heads, self_cache,
                            cache_index, self_mask, kernels,
                            lora=lora.get("self_attn"))
        h = h + x
        x = layer_norm(h, self.cross_attn_ln)
        if cross_cache is None:
            # the encoder runs unpadded: no encoder row needs masking
            x = cross_attention(x, enc_out, self.cross_attn, self.n_heads,
                                flash_cross, kv_len=None,
                                lora=lora.get("cross_attn"))
        else:
            x = cross_decode(x, self.cross_attn, self.n_heads, cross_cache,
                             kernels, lora=lora.get("cross_attn"))
        h = h + x
        return h + mlp(layer_norm(h, self.final_ln), self, lora)


class EEGStem(nn.Module):
    """Projection stem over [B, ch, T] signals (``config.StemConfig``):

    'speech':  gelu(conv1(mel))               k3 s1
    'base':    gelu(conv_b(gelu(conv_a(x))))  a: k3 s1, b: k3 s2
    'replace': gelu(conv(x))                  k3 s2
    'premel':  gelu(conv1(pre_conv(x)))       pre: k5 s2 p2, conv1: k3 s1

    'premel' takes a channel dropout between its two convs in training
    (``keep``, see `forward`).
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

    def forward(self, x, keep=None, rate: float = 0.0):
        """[B, T, ch] channels-last -> [B, T', d]. ``keep`` (premel only):
        a bool [B, 1, num_mel_bins] mask of the channels the dropout at
        ``rate`` keeps after pre_conv, the kept ones scaled by 1 / (1 -
        rate) (torch ``Dropout1d`` semantics; reference
        `utils/load_model.py:1516-1521`)."""
        if self.kind == "speech":
            return gelu(conv1d_cl(x, self.conv1))
        if self.kind == "base":
            return gelu(conv1d_cl(gelu(conv1d_cl(x, self.conv_a)), self.conv_b))
        if self.kind == "replace":
            return gelu(conv1d_cl(x, self.conv))
        h = conv1d_cl(x, self.pre_conv)
        if keep is not None:
            h = _dropout(h, keep, rate)
        return gelu(conv1d_cl(h, self.conv1))


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

    def forward(self, features, decoder_input_ids, lora=None, dropout=None):
        """``forward(self, ...)``: lets ``torch.func.functional_call`` run
        the model on substituted (merged) weights."""
        return forward(self, features, decoder_input_ids, lora, dropout)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

# Set by `fold_at_linear` (the training step's 'fc' fold regime): adapted
# linears run one product against W_eff = W + s A (E) B with the low-rank-only
# backward of `models/lora.py::folded_linear`, instead of a per-token delta.
# A context variable, so that each thread has its own (the ranks of a
# `parallel.ring_attention.LocalRing` are threads).
_FOLD_AT_LINEAR = contextvars.ContextVar("fold_at_linear", default=False)


@contextlib.contextmanager
def fold_at_linear():
    token = _FOLD_AT_LINEAR.set(True)
    try:
        yield
    finally:
        _FOLD_AT_LINEAR.reset(token)


# A name for the product being computed, read by the remat policies (the
# JAX package's ``checkpoint_name``): set around the q, k and v projections
# ('flash_q', 'flash_k', 'flash_v'), the encoder self-attention's out
# projection ('attn_out') and fc1 ('mlp_h'). A context variable, as
# ``_FOLD_AT_LINEAR``.
_SAVE_NAME = contextvars.ContextVar("save_name", default=None)


@contextlib.contextmanager
def _named(name: str):
    token = _SAVE_NAME.set(name)
    try:
        yield
    finally:
        _SAVE_NAME.reset(token)


def _cast(t, dtype):
    """``t`` in ``dtype``; no copy when it already is (a serving model's
    weights), a differentiable cast when not (a training model's masters)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def linear(x, p: nn.Linear, lora=None):
    """x W^T + b, plus the low-rank delta of a LoRA ``lora`` entry: folded
    into the weight under `fold_at_linear`, per token otherwise. Under
    ``int8_matmul.int8_mode`` the product x W^T runs as an int8 matmul with
    straight-through gradients (`int8_matmul.quantized_dot`; the folded
    path quantizes inside `folded_linear`); the bias and the per-token
    delta stay exact."""
    if lora is not None and _FOLD_AT_LINEAR.get():
        return folded_linear(x, p, lora)
    if int8_matmul.mode() != "off":
        y = int8_matmul.quantized_dot(x, _cast(p.weight, x.dtype))
        if p.bias is not None:
            y = y + _cast(p.bias, x.dtype)
    else:
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
    # 'mlp_h', the fc1 pre-activation: from it the backward recomputes only
    # the gelu under remat policy 'flash_mlp'
    with _named("mlp_h"):
        h = linear(x, layer.fc1, lora.get("fc1"))
    return linear(gelu(h), layer.fc2, lora.get("fc2"))


def _dropout(h, keep, rate: float):
    """``h`` where ``keep`` holds, scaled by 1 / (1 - rate); 0 elsewhere."""
    return torch.where(keep, h / (1.0 - rate), 0.0)


def draw_dropout(gen: torch.Generator, config: WhisperConfig,
                 stem: StemConfig, batch_size: int):
    """The training forward's dropout masks at ``stem.dropout``, drawn from
    ``gen`` on its device, or None at rate 0 (no draw): for a 'premel' stem
    first ``stem``, the channels its dropout keeps (bool [B, 1,
    num_mel_bins]), then ``frames``, the frames the dropout after the
    position embedding keeps (bool [B, max_source_positions, 1]). Each is
    ``uniform < 1 - rate`` (``jax.random.bernoulli``'s rule)."""
    if stem.dropout <= 0:
        return None
    keep = 1.0 - stem.dropout
    draws = {"rate": stem.dropout}
    if stem.kind == "premel":
        draws["stem"] = torch.rand((batch_size, 1, config.num_mel_bins),
                                   generator=gen, device=gen.device) < keep
    draws["frames"] = torch.rand(
        (batch_size, config.max_source_positions, 1), generator=gen,
        device=gen.device) < keep
    return draws


def apply_stem(model: Whisper, features, dropout=None):
    """[B, ch, T] -> [B, T', d]: the projection stem (with its channel
    dropout under ``dropout``'s ``stem`` mask), then whisper's conv2 (k3
    s2) under gelu."""
    dropout = dropout or {}
    h = model.encoder.stem(features.transpose(1, 2), dropout.get("stem"),
                           dropout.get("rate", 0.0))
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
                   mask=None, lora=None, causal: bool = False, ring=None,
                   kv_valid_len: Optional[int] = None):
    """Self-attention; the flash path applies ``causal`` as its mask, the
    plain path ``mask``. With ``ring`` (non-causal, mask-free), ring
    attention over this rank's shard, through K4 or, without ``use_flash``,
    its plain versions."""
    lora = lora or {}
    with _named("flash_q"):
        q = _split_heads(linear(x, p.q, lora.get("q")), n_heads)
    with _named("flash_k"):
        k = _split_heads(linear(x, p.k, lora.get("k")), n_heads)
    with _named("flash_v"):
        v = _split_heads(linear(x, p.v, lora.get("v")), n_heads)
    if ring is not None:
        out = ring_attention_local(q, k, v, ring, kv_valid_len,
                                   kernels=use_flash)
    elif use_flash:
        out = flash_attention_bthd(q, k, v, causal=causal)
    else:
        out = attention(q, k, v, mask)
    # 'attn_out', the block's output: kept under remat policy 'attn'
    with _named("attn_out"):
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


def self_decode(x, p: Attention, n_heads: int, cache: dict,
                cache_index: int, mask, kernels: bool = True, lora=None):
    """Incremental self-attention on the [B, H, Dh, Tmax] cache, writing
    columns ``cache_index ..`` in place (the JAX package returns an updated
    copy).

    The speculative-decode cache ``k_tu``/``v_tu`` sends every call, the
    prompt's prefill included, through `decode_step_multi` (K8) under
    ``mask``, as the JAX package routes every ``k_tu`` call before any width
    check. On the ``k_t``/``v_t`` cache a width-1 step without a mask
    attends the contiguous columns 0..cache_index through `decode_step`
    (K7); a wider call (the prompt's prefill) writes its columns, then
    scores all Tmax columns under ``mask`` with plain tensor code, as in the
    JAX package. ``lora`` adapts q, k, v and out; the kernels take q, k
    and v after the projections."""
    lora = lora or {}
    q = _split_heads(linear(x, p.q, lora.get("q")), n_heads)
    k = _split_heads(linear(x, p.k, lora.get("k")), n_heads)
    v = _split_heads(linear(x, p.v, lora.get("v")), n_heads)
    t = q.shape[1]
    if "k_tu" in cache:
        step = decode_step_multi if kernels else decode_step_multi_plain
        out = step(q, k, v, mask, cache["k_tu"], cache["v_tu"], cache_index)
    elif t == 1 and mask is None:
        step = decode_step if kernels else decode_step_plain
        out = step(q, k, v, cache["k_t"], cache["v_t"], cache_index)
    else:
        k_t, v_t = cache["k_t"], cache["v_t"]
        k_t[..., cache_index:cache_index + t] = k.permute(0, 2, 3, 1)
        v_t[..., cache_index:cache_index + t] = v.permute(0, 2, 3, 1)
        out = _attend_t(q, k_t, v_t, mask)
    return linear(_merge_heads(out), p.out, lora.get("out"))


def cross_decode(x, p: Attention, n_heads: int, cache: dict,
                 kernels: bool = True, lora=None):
    """Cross-attention of the cached decoder over the encoder cache: the
    bf16 ``k``/``v`` [B, H, T_src, Dh] through `decode_cross` (K6), or the
    int8 ``k_qt``/``v_qt`` [B, H, Dh, T_src] with per-channel scales in
    plain tensor code (XLA in the JAX package): the K scales fold into q,
    the V scales into the output, and the products read the int8 values
    cast to the compute dtype. Beam search runs B*K decoder rows against
    one cache per utterance: the beam rows fold into the query,
    [B*K, t, H, Dh] -> [B, K*t, H, Dh], beam-major within an utterance
    (cross K/V is beam-invariant). ``lora`` adapts q and out only: the
    cache's K/V were projected without adapters (`init_cache`), as in the
    JAX package."""
    lora = lora or {}
    q = _split_heads(linear(x, p.q, lora.get("q")), n_heads)
    b = next(iter(cache.values())).shape[0]
    qb = q.reshape(b, -1, *q.shape[2:])
    if "k_qt" in cache:
        k_s, v_s = (cache[n][:, :, 0].to(q.dtype)[:, None]
                    for n in ("k_s", "v_s"))
        out = _attend_t(qb * k_s, cache["k_qt"].to(q.dtype),
                        cache["v_qt"].to(q.dtype)) * v_s
    else:
        attend = decode_cross if kernels else decode_cross_plain
        out = attend(qb, cache["k"], cache["v"])
    return linear(_merge_heads(out.reshape(q.shape)), p.out, lora.get("out"))


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


# The remat policies (``config.remat_policy``), the JAX package's
# ``_remat_policy``. Under a checkpoint the backward runs the layer's forward
# again; an op a policy keeps returns its saved output there instead of
# running (``torch.utils.checkpoint``'s selective checkpoint), so a policy
# that keeps a named tensor keeps every op inside its name's region
# (`_named`: the projection's casts and products, under int8 its
# quantization too).
#   None         full recompute: K1 runs again in the backward. So does a
#                name not listed here (`remat_policy`).
#   'flash'      the flash forward's o and lse (``neuspeech::flash_fwd``).
#   'flash_qkv'  'flash' plus the q, k and v projections.
#   'flash_mlp'  'flash_qkv' plus the fc1 pre-activation ('mlp_h'): the
#                backward recomputes only layer norms and the gelu.
#   'dots'       every matrix product (mm, addmm, bmm, _int_mm), not the
#                flash forward: K1 runs again.
#   'attn'       only 'attn_out', the self-attention block's output after
#                its out projection: K1 runs again.
#   'everything' every tensor the backward reads, nothing recomputed: the
#                layer runs without a checkpoint (the JAX package's
#                ``everything_saveable``, whose backward also reads only
#                what it saved).
REMAT_POLICIES = (None, "flash", "flash_qkv", "flash_mlp", "dots", "attn",
                  "everything")
_QKV = ("flash_q", "flash_k", "flash_v")
_SAVED_NAMES = {"flash": (), "flash_qkv": _QKV,
                "flash_mlp": _QKV + ("mlp_h",), "attn": ("attn_out",)}
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten._int_mm.default)


def check_remat(config: WhisperConfig) -> None:
    """Raises for remat under sequence parallelism (not ported). A policy
    name outside `REMAT_POLICIES` is full recompute, as policy None
    (`remat_policy`), as the JAX package's ``_remat_policy`` runs it for a
    name it does not know (such as ``perf/ablate.py``'s 'full')."""
    if config.remat and config.seq_parallel_axis is not None:
        raise NotImplementedError(
            "remat under sequence parallelism is not ported yet; ROADMAP.md "
            "queue 1 item 8 lists it")


def remat_policy(config: WhisperConfig):
    """The policy the checkpoint runs: ``config.remat_policy``, or None
    (full recompute) for a name outside `REMAT_POLICIES`."""
    name = config.remat_policy
    return name if name in REMAT_POLICIES else None


def _policy_fn(policy: str):
    """The selective checkpoint's rule for ``policy``: which ops keep their
    outputs (MUST_SAVE) and which run again (PREFER_RECOMPUTE)."""
    if policy == "dots":
        def rule(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        return rule
    names = _SAVED_NAMES[policy]
    flash = policy != "attn"

    def rule(ctx, op, *args, **kwargs):
        if flash and op is torch.ops.neuspeech.flash_fwd.default:
            return CheckpointPolicy.MUST_SAVE
        if _SAVE_NAME.get() in names and not op.is_view:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return rule


def _remat_layer(layer: nn.Module, h, flash: bool, lora, policy):
    """``layer(h, flash, lora)`` under a non-reentrant checkpoint. The
    layer's weights are the checkpoint's inputs, read as the layer holds
    them now (the training step's merged weights, which it substitutes with
    ``functional_call``) and substituted again when the backward runs the
    layer's forward anew, by which time the step's substitution has ended;
    so are the fold regime (`fold_at_linear`) and the int8 mode, whose
    contexts have closed by then too."""
    if policy == "everything":
        return layer(h, flash, lora)
    names = [n for n, _ in layer.named_parameters()]
    weights = [functools.reduce(getattr, n.split("."), layer) for n in names]
    fold = _FOLD_AT_LINEAR.get()
    i8 = int8_matmul.mode()

    def run(h, *weights):
        token = _FOLD_AT_LINEAR.set(fold)
        try:
            with int8_matmul.int8_mode(i8):
                return torch.func.functional_call(
                    layer, dict(zip(names, weights)), (h, flash, lora))
        finally:
            _FOLD_AT_LINEAR.reset(token)

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _policy_fn(policy))
    return checkpoint(run, h, *weights, use_reentrant=False, **kw)


def _layer_lora(lora, part: str):
    """The per-layer adapter list of ``part`` in a LoRA tree, or None."""
    return ((lora or {}).get(part) or {}).get("layers")


def encoder_apply(model: Whisper, features, lora=None, dropout=None):
    """[B, ch, T] -> [B, T', d] encoder states, T' == max_source_positions;
    ``lora`` is an adapter tree (``models/lora.py``). ``dropout``
    (`draw_dropout`'s masks, training only) drops the premel stem's
    channels and, after the position embedding, whole frames.

    T' runs unpadded: the flash kernel masks the ragged last tile itself
    (the JAX package pads to a 128-row multiple for its TPU tiling).

    Under ``config.seq_parallel_axis`` (the JAX routing): T' is padded to a
    multiple of n x 128 for the ring of n ranks along that axis of the
    ambient mesh (``parallel/mesh.py::set_mesh``), keys at or past T' are
    masked, and the padded states are sharded along T once: each rank runs
    the layer stack on its [B, T'/n, d] shard with ring attention, so
    activations stay O(T'/n), then the shards are gathered, cut back to T'
    and layer-normed on every rank. The gradients of the layer stack's
    weights then cover only this rank's tokens; the training step sums them
    over the ring. ``pipeline_axis`` (GPipe) is not ported and raises."""
    config = model.config
    if config.pipeline_axis is not None:
        raise NotImplementedError(
            "pipeline parallelism (pipeline_axis) is not ported yet; "
            "ROADMAP.md queue 1 item 8 lists it")
    check_remat(config)
    remat = config.remat and torch.is_grad_enabled()
    h = apply_stem(model, _cast(features, model.dtype), dropout)
    t = h.shape[1]
    if t != config.max_source_positions:
        raise ValueError(
            f"stem produced {t} frames, expected {config.max_source_positions}"
            " — input length must be 4x the source positions (stride 2 x 2)")
    h = h + _cast(model.encoder.pos_embed[:t], h.dtype)
    if dropout is not None:
        h = _dropout(h, dropout["frames"], dropout["rate"])
    flash = resolve_flash(model)
    ring, kv_valid_len = None, None
    if config.seq_parallel_axis is not None:
        ring = axis_ring(config.seq_parallel_axis)
        quantum = ring.size * SHARD_QUANTUM
        t_pad = -(-t // quantum) * quantum
        if t_pad != t:
            h = F.pad(h, (0, 0, 0, t_pad - t))
            kv_valid_len = t
        h = shard_seq(h, ring)
    layers_lora = _layer_lora(lora, "encoder")
    for i, layer in enumerate(model.encoder.layers):
        layer_lora = None if layers_lora is None else layers_lora[i]
        if remat:
            h = _remat_layer(layer, h, flash, layer_lora,
                              remat_policy(config))
        else:
            h = layer(h, flash, layer_lora, ring=ring,
                      kv_valid_len=kv_valid_len)
    if ring is not None:
        h = gather_seq(h, ring)[:, :t]
    return layer_norm(h, model.encoder.ln_post)


def decoder_apply(model: Whisper, tokens, enc_out, cache=None,
                  cache_index: Optional[int] = None, lora=None, pos_ids=None,
                  self_attn_mask=None, return_hidden: bool = False):
    """Token ids [B, T] -> logits [B, T, vocab].

    Without ``cache``: causal teacher forcing over ``enc_out``, with the
    JAX package's flash gates: from ``config.decoder_flash_min_q`` tokens
    on, cross-attention goes through flash at T >= ``decoder_flash_cross_min_q``
    and causal self-attention at T >= ``decoder_flash_self_min_q``.
    With ``cache`` (from `init_cache`): one incremental step writing
    positions ``cache_index .. cache_index + T - 1``; returns (logits,
    cache) with the cache updated in place. ``lora``'s decoder adapters
    apply on both paths (`DecoderLayer.forward`).

    ``pos_ids`` / ``self_attn_mask`` (cached decode only): per-row logical
    position ids [B, T] for the learned position embedding, and a
    [B, 1, T, Tmax] bool mask replacing the contiguous
    ``position <= cache_index + i`` rule. Speculative decoding needs both:
    accepted tokens sit at non-contiguous cache columns (rejected drafts
    leave holes) while their logical positions stay dense
    (``decode/spec.py``).

    ``return_hidden`` (cached decode only): also return the final-LN hidden
    states [B, T, d] that feed the logits, HF's ``last_hidden_state``, which
    contrastive search's degeneration penalty reads: (logits, cache,
    hidden)."""
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
        # past the table's end the JAX package's reads clamp
        # (``lax.dynamic_slice``'s start, a gather's indices): so do these
        n_pos = dec.pos_embed.shape[0]
        if pos_ids is None:
            start = min(cache_index, n_pos - t)
            pos = dec.pos_embed[start:start + t]
        else:
            pos = F.embedding(pos_ids.clamp(max=n_pos - 1), dec.pos_embed)
        h = h + _cast(pos, h.dtype)
        # a width-1 step on the k_t cache attends the contiguous columns
        # without a mask (K7); K8 takes the mask of every call
        mask = self_attn_mask
        sc0 = cache["self"][0]
        if mask is None and (t > 1 or "k_tu" in sc0):
            t_max = sc0["k_tu" if "k_tu" in sc0 else "k_t"].shape[-1]
            positions = torch.arange(t_max, device=h.device)
            rows = cache_index + torch.arange(t, device=h.device)
            mask = (positions[None, :] <= rows[:, None])[None, None]
        kernels = resolve_flash(model)
        layers_lora = _layer_lora(lora, "decoder")
        for i, (layer, sc, cc) in enumerate(
                zip(dec.layers, cache["self"], cache["cross"])):
            h = layer(h, None, mask, self_cache=sc, cross_cache=cc,
                      cache_index=cache_index,
                      lora=None if layers_lora is None else layers_lora[i],
                      kernels=kernels)
    h = layer_norm(h, dec.ln)
    logits = F.linear(h, _cast(dec.token_embed.weight, h.dtype))
    if cache is None:
        return logits
    return (logits, cache, h) if return_hidden else (logits, cache)


def init_cache(model: Whisper, enc_out, max_len: int, int8_cross: bool = False,
               cross_layout: str = "bhtd", self_t_major: bool = False,
               self_batch: Optional[int] = None):
    """Decode caches: per layer, the cross K/V projected from ``enc_out``
    once, and zeroed self K/V [self_batch or B, H, Dh, max_len] in the
    model dtype. ``self_batch`` is the decoder's row count when it exceeds
    the encoder batch: beam search runs B*K rows against one cross cache per
    utterance.

    The cross cache is ``k``/``v`` [B, H, T_src, Dh] in the model dtype (the
    layout `decode_cross` reads natively) or, with ``int8_cross``, the JAX
    package's int8 cache: the projections in the model dtype, quantized in
    f32 over T_src with one scale per (row, head, channel), stored as
    ``k_qt``/``v_qt`` int8 [B, H, Dh, T_src] and ``k_s``/``v_s`` f32
    [B, H, 1, Dh]. The self cache is ``k_t``/``v_t``, or ``k_tu``/``v_tu``
    with ``self_t_major`` (the JAX package's default speculative-decode
    cache, whose every call goes through K8). The 'btc' cross layout is not
    ported: no decode path of the JAX package builds it by default; it
    raises (ROADMAP.md queue 1)."""
    if cross_layout != "bhtd":
        raise NotImplementedError(
            "only the 'bhtd' cross cache layout is ported; the 'btc' cross "
            "cache is queued in ROADMAP.md")
    config = model.config
    h = config.decoder_heads
    dh = config.d_model // h
    enc_out = enc_out.to(model.dtype)
    rows = self_batch or enc_out.shape[0]
    names = ("k_tu", "v_tu") if self_t_major else ("k_t", "v_t")

    def bhtd(x):
        return _split_heads(x, h).transpose(1, 2)

    def int8_cross_cache(k, v):
        (k_q, k_s), (v_q, v_s) = (quantize_int8(bhtd(x).float())
                                  for x in (k, v))
        return {"k_qt": k_q.transpose(2, 3).contiguous(), "k_s": k_s,
                "v_qt": v_q.transpose(2, 3).contiguous(), "v_s": v_s}

    cross: List[dict] = []
    selfc: List[dict] = []
    for layer in model.decoder.layers:
        ca = layer.cross_attn
        k, v = linear(enc_out, ca.k), linear(enc_out, ca.v)
        cross.append(int8_cross_cache(k, v) if int8_cross else
                     {"k": bhtd(k).contiguous(), "v": bhtd(v).contiguous()})
        selfc.append({
            name: torch.zeros((rows, h, dh, max_len), dtype=model.dtype,
                              device=enc_out.device)
            for name in names})
    return {"self": selfc, "cross": cross}


def forward(model: Whisper, features, decoder_input_ids, lora=None,
            dropout=None):
    """Teacher-forcing forward: logits [B, T, vocab]; ``dropout`` as in
    `encoder_apply`."""
    return decoder_apply(model, decoder_input_ids,
                         encoder_apply(model, features, lora, dropout),
                         lora=lora)


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
