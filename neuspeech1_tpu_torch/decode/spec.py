"""Self-speculative (multi-token draft-and-verify) greedy decoding: the port
of ``neuspeech1_tpu/decode/spec.py``.

Each iteration feeds every row its last token and gamma - 1 drafted tokens
in one cached decoder call (width gamma), so the cross-attention cache and
the weights are read once for gamma positions. A draft is accepted only
while it equals the model's own greedy argmax given the same accepted
history, so the output is the tokens of `generate.greedy_decode` (up to
reduction-order ulps on exact logit ties: the verify step runs the decoder
at width gamma, where greedy runs it at width 1).

Drafts come from the row's own decoded prefix (`_ngram_draft`, prompt
lookup) or from a corpus table of trigram and bigram followers
(`build_draft_table`, `_table_draft`).

Per-row acceptance counts differ, so accepted tokens sit at non-contiguous
columns of the self cache: each iteration writes its gamma fed tokens at a
batch-wide column offset, a per-row validity mask marks which of them hold
accepted tokens, and the holes rejected drafts leave are never attended
again. Logical positions (the position embedding, the output buffer) stay
dense per row. The self cache holds prompt + gamma * max_new columns (one
accepted token per iteration at worst), ``k_tu``/``v_tu`` [B, H, Dh, Tmax],
and every decoder call on it goes through K8 (``ops/decode_step.py::
decode_step_multi``).

The loop runs eagerly and waits for the device once per iteration, to read
its stop condition; drafting, masks, acceptance and the output append stay
on the device.

Supported options: plain greedy with the suppress lists (position
independent). Repetition penalty, no-repeat-ngram, min_new_tokens, sampling
and beams are per-position state across the gamma block: they raise.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neuspeech1_tpu_torch.decode import logits_process as lp
from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                  _process_logits)
from neuspeech1_tpu_torch.models import whisper as tw

# Pair codes are prev2 * V + prev1. An empty table holds one sentinel row
# (NO_MATCH_CODE); a query without a pair context (prev2 < 0) asks for
# NO_PAIR_CODE, which matches nothing, the sentinel included. Both lie above
# every real code (<= V^2 - 1 with V <= 65535). The JAX package keeps codes
# in uint32 (its int64 arrays truncate to int32 with x64 off); the port
# keeps them in int64 (torch.searchsorted has no uint32) with the same
# values, wrapped to 32 bits as uint32 arithmetic wraps.
NO_MATCH_CODE = 0xFFFFFFFF
NO_PAIR_CODE = 0xFFFFFFFE
MAX_VOCAB = 0xFFFF


def _check_supported(gen: GenerationConfig) -> None:
    bad = []
    if gen.repetition_penalty != 1.0:
        bad.append("repetition_penalty")
    if gen.no_repeat_ngram_size:
        bad.append("no_repeat_ngram_size")
    if gen.min_new_tokens:
        bad.append("min_new_tokens")
    if gen.timestamps:
        bad.append("timestamps")
    if gen.do_sample:
        bad.append("do_sample")
    if gen.num_beams != 1:
        bad.append("num_beams")
    if bad:
        raise NotImplementedError(
            "spec_greedy_decode supports plain greedy (+suppress lists); "
            f"unsupported options set: {bad}")


def build_draft_table(texts, tokenizer, vocab_size: int) -> Dict[str, np.ndarray]:
    """The corpus drafter's tables, built on the host from ``texts`` (a
    training manifest's sentences):

    {"keys": sorted int64 [K] pair codes prev2 * V + prev1,
     "vals": int32 [K] the most frequent follower of each pair,
     "uni":  int32 [V] the most frequent follower of each token (-1 unseen)}

    Ties keep the first follower counted, as in the JAX package."""
    if vocab_size > MAX_VOCAB:
        raise ValueError(
            f"vocab_size {vocab_size} overflows the uint32 pair-code "
            "space (max 65535)")
    pair = collections.Counter()
    uni = collections.Counter()
    for text in texts:
        ids = tokenizer.encode(text)
        for a, b in zip(ids, ids[1:]):
            uni[(a, b)] += 1
        for a, b, c in zip(ids, ids[1:], ids[2:]):
            pair[(a, b, c)] += 1
    best_pair = {}
    for (a, b, c), n in pair.items():
        k = a * vocab_size + b
        if k not in best_pair or n > best_pair[k][1]:
            best_pair[k] = (c, n)
    if not best_pair:
        best_pair[NO_MATCH_CODE] = (0, 0)
    keys = np.sort(np.asarray(list(best_pair.keys()), np.int64))
    vals = np.asarray([best_pair[int(k)][0] for k in keys], np.int32)
    best_uni = np.full((vocab_size,), -1, np.int32)
    score = {}
    for (a, b), n in uni.items():
        if a not in score or n > score[a][1]:
            score[a] = (b, n)
    for a, (b, _) in score.items():
        best_uni[a] = b
    return {"keys": keys, "vals": vals, "uni": best_uni}


def _prev2(out, out_len):
    """The token before the last one per row, -1 where the row holds one."""
    idx = (out_len - 2).clamp(0, out.shape[1] - 1)[:, None]
    return torch.where(out_len >= 2, out.gather(1, idx)[:, 0], -1)


def _table_draft(out, out_len, t_last, gamma: int, table):
    """Corpus-table drafter: the follower of the (prev2, prev1) pair
    (searchsorted over the sorted codes), else of prev1 alone, else prev1
    repeated. out [B, L], out_len [B], t_last [B] -> drafts [B, gamma-1];
    ``table`` holds `build_draft_table`'s arrays as tensors on out's
    device."""
    keys, vals, uni = table["keys"], table["vals"], table["uni"]
    v = uni.shape[0]

    def follower(prev2, prev1):
        code = torch.where(prev2 < 0, NO_PAIR_CODE,
                           (prev2 * v + prev1) & 0xFFFFFFFF)
        i = torch.searchsorted(keys, code).clamp(0, keys.shape[0] - 1)
        d1 = uni[prev1.clamp(0, v - 1)].long()
        return torch.where(keys[i] == code, vals[i].long(),
                           torch.where(d1 >= 0, d1, prev1))

    prev2, prev1 = _prev2(out, out_len), t_last
    drafts = []
    for _ in range(gamma - 1):
        nxt = follower(prev2, prev1)
        drafts.append(nxt)
        prev2, prev1 = prev1, nxt
    return torch.stack(drafts, dim=1)


def _ngram_draft(out, out_len, t_last, gamma: int):
    """Prompt-lookup drafter over the row's own prefix: the token that
    followed the most recent earlier occurrence of the (prev2, prev1) pair,
    else of prev1 alone, else prev1 repeated. Candidates j lie in
    [1, out_len - 2] for the pair and [0, out_len - 2] for prev1 alone.
    out [B, L], out_len [B], t_last [B] -> drafts [B, gamma-1]."""
    length = out.shape[1]
    idxs = torch.arange(length, device=out.device)[None]
    out_m1 = F.pad(out[:, :-1], (1, 0), value=-1)  # out_m1[:, j] = out[:, j-1]
    lim = (out_len - 1)[:, None]

    def follower(prev2, prev1):
        hit1 = (idxs < lim) & (out == prev1[:, None])
        hit2 = hit1 & (idxs >= 1) & (out_m1 == prev2[:, None])
        j2 = torch.where(hit2, idxs, -1).amax(dim=1)
        j1 = torch.where(hit1, idxs, -1).amax(dim=1)
        j = torch.where(j2 >= 0, j2, j1)
        nxt = out.gather(1, (j + 1).clamp(0, length - 1)[:, None])[:, 0]
        return torch.where(j >= 0, nxt, prev1)

    prev2, prev1 = _prev2(out, out_len), t_last
    drafts = []
    for _ in range(gamma - 1):
        nxt = follower(prev2, prev1)
        drafts.append(nxt)
        prev2, prev1 = prev1, nxt
    return torch.stack(drafts, dim=1)


def verify_mask(valid, phys: int, gamma: int):
    """The verify step's self-attention mask [B, 1, gamma, Tmax]: the
    accepted columns ``valid`` [B, Tmax], plus for query i the block's own
    columns phys .. phys + i."""
    t_max = valid.shape[1]
    off = torch.arange(t_max, device=valid.device) - phys
    inblock = (off >= 0) & (off[None, :] <= torch.arange(
        gamma, device=valid.device)[:, None])            # [gamma, Tmax]
    return valid[:, None, None, :] | inblock[None, None]


@torch.no_grad()
def spec_greedy_decode(model: tw.Whisper, features, prompt_ids,
                       gen: GenerationConfig, gamma: int = 2,
                       lora=None, draft_table: Optional[dict] = None):
    """Greedy decoding with gamma-token draft-verify iterations: features
    [B, ch, T], prompt_ids [B, P] -> (tokens [B, max_length] as
    `greedy_decode` gives them, the number of iterations). With
    ``draft_table`` (`build_draft_table`'s arrays as tensors on the model's
    device) drafts come from the corpus table, else from each row's own
    prefix (neither drafter runs the model). ``lora``: an unmerged adapter
    tree applied in the encoder and in every decoder call, the prefill's
    and the verify steps', as in the JAX package."""
    _check_supported(gen)
    if gamma < 2:
        raise ValueError("gamma must be >= 2 (1 is plain greedy_decode)")
    enc = tw.encoder_apply(model, features, lora)
    dev = enc.device
    b, p = prompt_ids.shape
    length = gen.max_length
    max_iters = length - p  # every iteration accepts >= 1 token per live row
    n_pos = model.decoder.pos_embed.shape[0]
    cache = tw.init_cache(model, enc, max_len=p + gamma * max_iters,
                          int8_cross=gen.int8_kv_cache, self_t_major=True)
    out = torch.full((b, length), gen.pad_id, dtype=torch.long, device=dev)
    out[:, :p] = prompt_ids

    # the prefill: physical columns equal logical positions for the prompt
    logits, cache = tw.decoder_apply(model, out[:, :p], enc, cache=cache,
                                     cache_index=0, lora=lora)
    g0 = _process_logits(logits[:, -1], out, p, gen, p, None).argmax(dim=-1)
    if p < length:
        out[:, p] = g0
    out_len = torch.full((b,), p + 1, dtype=torch.long, device=dev)
    finished = (g0 == gen.eos_id) | (out_len >= length)

    valid = torch.zeros((b, p + gamma * max_iters), dtype=torch.bool,
                        device=dev)
    valid[:, :p] = True
    ar_g = torch.arange(gamma, device=dev)
    ar_len = torch.arange(length, device=dev)
    phys, it = p, 0
    # the one wait per iteration
    while it < max_iters and not bool(finished.all()):
        t_last = out.gather(1, (out_len - 1)[:, None])[:, 0]
        if draft_table is not None:
            drafts = _table_draft(out, out_len, t_last, gamma, draft_table)
        else:
            drafts = _ngram_draft(out, out_len, t_last, gamma)
        toks = torch.cat([t_last[:, None], drafts], dim=1)   # [B, gamma]
        pos_ids = ((out_len - 1)[:, None] + ar_g).clamp(0, n_pos - 1)
        logits, cache = tw.decoder_apply(
            model, toks, enc, cache=cache, cache_index=phys, pos_ids=pos_ids,
            self_attn_mask=verify_mask(valid, phys, gamma), lora=lora)
        g = lp.suppress_tokens(logits.float(), gen.suppress_ids).argmax(-1)

        # accepted run: the true next token plus the leading matching drafts,
        # cut at the first eos, the buffer's end, and 0 for finished rows
        m = 1 + torch.cumprod((toks[:, 1:] == g[:, :-1]).long(), 1).sum(1)
        is_eos = g == gen.eos_id
        pe = torch.where(is_eos, ar_g, gamma).amin(dim=1)
        m_eff = torch.minimum(torch.minimum(m, pe + 1), length - out_len)
        m_eff = torch.where(finished, 0, m_eff)

        # out[:, out_len + i] = g[:, i] for i < m_eff
        upd = ar_g < m_eff[:, None]                          # [B, gamma]
        onehot = (ar_len == (out_len[:, None] + ar_g)[..., None]) \
            & upd[..., None]                                 # [B, gamma, L]
        out = torch.where(onehot.any(dim=1), (onehot * g[..., None]).sum(1),
                          out)
        # fed column i holds a true-sequence token iff i < m_eff
        valid[:, phys:phys + gamma] = upd & ~finished[:, None]
        out_len = out_len + m_eff
        finished = finished | (is_eos & upd).any(dim=1) | (out_len >= length)
        phys += gamma
        it += 1
    return out, it
