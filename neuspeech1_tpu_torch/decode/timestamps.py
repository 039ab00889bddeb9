"""Whisper timestamp decoding: the logits rules and DTW token timestamps, the
port of ``neuspeech1_tpu/decode/timestamps.py`` (the reference's vendored
generate-with-timestamps machinery, `utils/load_model.py:1072-1330`, its
`_median_filter` / `_dynamic_time_warping` at `:252-324` and the token
timestamps from cross-attention at `:1362-1401`).

`timestamp_rules` is a logits processor with HF's
WhisperTimeStampLogitsProcessor semantics, on tensors; the decode loops
append it to their processor chain under ``GenerationConfig.timestamps``.
`word_timestamps` runs the encoder (K1), recomputes the cross-attention
probabilities teacher-forced (`cross_attention_maps`, plain PyTorch: the
kernels return attention outputs, not probabilities) and aligns tokens to
frames with a median filter and DTW on the host (numpy), an offline
analysis path, not a hot loop.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from neuspeech1_tpu_torch.decode.logits_process import NEG_INF
from neuspeech1_tpu_torch.models import whisper as tw

# the encoder's frame step (30 s over 1500 frames) and the median filter's
# width over the frames (the reference's settings)
TIME_PER_FRAME = 0.02
MEDFILT_WIDTH = 7


def timestamp_rules(logits, tokens, cur_len: int, config, prompt_len: int,
                    max_initial_timestamp_index: Optional[int] = 50):
    """Whisper's timestamp grammar on [B, V] scores; ``config`` carries
    ``timestamp_begin``, ``notimestamps_id`` and ``eot_id`` (a
    WhisperConfig or a GenerationConfig). Rules (HF
    WhisperTimeStampLogitsProcessor):

    - <|notimestamps|> is always banned;
    - timestamps come in pairs: after (ts, ts) text follows, after (text,
      ts) a timestamp or eot;
    - timestamps do not decrease: those below the largest seen are banned,
      and so is the largest itself except right after a timestamp that
      follows text;
    - at the first free position only timestamps up to ``timestamp_begin +
      max_initial_timestamp_index`` are allowed;
    - when the timestamps' total probability beats the best text token's,
      only timestamps are allowed."""
    c = config
    v = logits.shape[-1]
    ts_begin = c.timestamp_begin
    dev = logits.device
    vocab = torch.arange(v, device=dev)[None, :]
    logits = torch.where(vocab == c.notimestamps_id, NEG_INF, logits.float())

    def tok_at(offset):
        pos = cur_len - offset
        if pos < prompt_len:
            return torch.full((tokens.shape[0],), -1, dtype=tokens.dtype,
                              device=tokens.device)
        return tokens[:, pos]

    last_was_ts = tok_at(1) >= ts_begin
    penult_was_ts = tok_at(2) >= ts_begin
    is_ts = vocab >= ts_begin
    is_text = vocab < c.eot_id

    # the pair rule
    ban_ts = (last_was_ts & penult_was_ts)[:, None]
    ban_text = (last_was_ts & ~penult_was_ts)[:, None]
    logits = torch.where(ban_ts & is_ts, NEG_INF, logits)
    logits = torch.where(ban_text & is_text, NEG_INF, logits)

    # monotonicity over the generated tokens tokens[:, prompt_len:cur_len]
    gen = tokens[:, prompt_len:cur_len]
    if gen.shape[1]:
        max_ts = torch.where(gen >= ts_begin, gen, ts_begin - 1).amax(dim=1)
    else:
        max_ts = torch.full((tokens.shape[0],), ts_begin - 1,
                            dtype=tokens.dtype, device=tokens.device)
    limit = torch.where(last_was_ts & ~penult_was_ts, max_ts, max_ts + 1)
    below = is_ts & (vocab < limit[:, None])
    has_ts = (max_ts >= ts_begin)[:, None]
    logits = torch.where(has_ts & below, NEG_INF, logits)

    # the first free position: timestamps only, clamped
    if cur_len == prompt_len:
        logits = torch.where(is_ts, logits, NEG_INF)
        if max_initial_timestamp_index is not None:
            clamp = vocab > ts_begin + max_initial_timestamp_index
            logits = torch.where(clamp, NEG_INF, logits)

    # the timestamp-mass rule
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(torch.where(is_ts, logprobs, -np.inf), dim=-1)
    max_text = torch.where(is_ts, -np.inf, logprobs).amax(dim=-1)
    force_ts = (ts_mass > max_text)[:, None]
    return torch.where(force_ts & ~is_ts, NEG_INF, logits)


# --------------------------------------------------------------------------
# DTW token timestamps from cross-attention
# --------------------------------------------------------------------------

def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """1-D median filter over the last axis with edge reflection (the
    reference's `_median_filter`, `utils/load_model.py:252-270`)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The monotonic alignment through a [N_tokens, N_frames] cost matrix
    (the reference's `_dynamic_time_warping`, `utils/load_model.py:
    273-324`): (token indices, frame indices) of the cheapest path. One
    numpy step per anti-diagonal (cells with i + j = k depend only on the
    diagonals k - 1 and k - 2); on ties the diagonal move wins, then the
    token step."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for k in range(2, n + m + 1):
        i = np.arange(max(1, k - m), min(n, k - 1) + 1)
        if i.size == 0:
            continue
        j = k - i
        c0 = acc[i - 1, j - 1]   # diagonal
        c1 = acc[i - 1, j]       # token step
        c2 = acc[i, j - 1]       # frame step
        t = np.where((c0 <= c1) & (c0 <= c2), 0,
                     np.where(c1 <= c2, 1, 2)).astype(np.int8)
        acc[i, j] = np.choose(t, [c0, c1, c2]) + cost[i - 1, j - 1]
        trace[i, j] = t
    ti, fi = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fi[::-1])


@torch.no_grad()
def cross_attention_maps(model: tw.Whisper, tokens, enc_out):
    """Teacher-forced decoder pass over ``tokens`` [B, T] that keeps every
    layer's cross-attention probabilities: [L, B, H, T, T_enc] in f32.

    Plain PyTorch throughout, as the JAX package computes it with einsum
    outside any kernel: causal self-attention under a mask, then
    cross-attention with explicit f32 softmax probabilities (scores in the
    compute dtype, the probabilities cast back for the PV product). The
    decoder runs without adapters, as the JAX package's does."""
    dec = model.decoder
    t = tokens.shape[1]
    n_heads = model.config.decoder_heads
    h = tw._cast(torch.nn.functional.embedding(tokens, dec.token_embed.weight),
                 model.dtype)
    h = h + tw._cast(dec.pos_embed[:t], h.dtype)
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=h.device).tril()[None, None]
    enc_out = tw._cast(enc_out, h.dtype)
    maps = []
    for layer in dec.layers:
        x = tw.layer_norm(h, layer.self_attn_ln)
        h = h + tw.self_attention(x, layer.self_attn, n_heads,
                                  use_flash=False, mask=causal)
        x = tw.layer_norm(h, layer.cross_attn_ln)
        ca = layer.cross_attn
        q = tw._split_heads(tw.linear(x, ca.q), n_heads)
        k = tw._split_heads(tw.linear(enc_out, ca.k), n_heads)
        v = tw._split_heads(tw.linear(enc_out, ca.v), n_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        probs = torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        h = h + tw.linear(tw._merge_heads(att), ca.out)
        h = h + tw.mlp(tw.layer_norm(h, layer.final_ln), layer)
        maps.append(probs)
    return torch.stack(maps)


@torch.no_grad()
def word_timestamps(model: tw.Whisper, features,
                    token_ids: List[int]) -> List[dict]:
    """Token start and end times of one decoded sequence by DTW over the
    cross-attention (reference `utils/load_model.py:1362-1401`).

    ``features`` [1, ch, T_sig] on the model's device; ``token_ids`` the
    whole sequence, specials included. Returns [{"token": id, "start": s,
    "end": s}] for the text tokens (ids below eot)."""
    enc = tw.encoder_apply(model, features)
    toks = torch.as_tensor([token_ids], dtype=torch.long, device=enc.device)
    maps = cross_attention_maps(model, toks, enc).cpu().numpy()
    w = maps[:, 0].mean(axis=(0, 1))   # [T_tok, T_enc] over layers and heads
    # each token's row normalized, then median-filtered along the frames
    w = (w - w.mean(axis=-1, keepdims=True)) / (
        w.std(axis=-1, keepdims=True) + 1e-9)
    w = median_filter(w, MEDFILT_WIDTH)
    ti, fi = dtw_path(-w)   # the most attention is the cheapest path
    starts = np.zeros(len(token_ids))
    ends = np.zeros(len(token_ids))
    for tok_idx in range(len(token_ids)):
        frames = fi[ti == tok_idx]
        if len(frames):
            starts[tok_idx] = frames.min() * TIME_PER_FRAME
            ends[tok_idx] = (frames.max() + 1) * TIME_PER_FRAME
    eot = model.config.eot_id
    return [{"token": int(tok), "start": float(starts[i]),
             "end": float(ends[i])}
            for i, tok in enumerate(token_ids) if tok < eot]
