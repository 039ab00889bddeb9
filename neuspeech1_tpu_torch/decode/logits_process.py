"""Logits processors for greedy and beam decoding: the port of the dense
forms in ``neuspeech1_tpu/decode/logits_process.py`` (HF's SuppressTokens,
SuppressTokensAtBegin, MinNewTokens, RepetitionPenalty and
NoRepeatNGram processors).

Each takes scores [B, V] (greedy's logits, or beam search's log-probs) and,
where it needs them, the token buffer ``tokens`` [B, L] and the current
length ``cur_len``; positions at or past ``cur_len`` are never read.
Decoding here is eager, so ``cur_len`` is a Python int and a processor that
cannot fire at this step returns at once. Bans build a dense [V] or [B, V]
mask and apply it with one ``where``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

NEG_INF = -1e9


@functools.lru_cache(maxsize=64)
def _ban_mask(ids: Sequence[int], vocab: int, device) -> torch.Tensor:
    """The dense [V] mask of ``ids`` (a tuple), made once per (ids, vocab,
    device): building it copies the ids from the host, which would wait for
    the device at every decode step."""
    mask = torch.zeros(vocab, dtype=torch.bool, device=device)
    mask[torch.as_tensor(list(ids), dtype=torch.long, device=device)] = True
    return mask


def suppress_tokens(logits, ids: Sequence[int]):
    """Always-banned ids."""
    if not len(ids):
        return logits
    mask = _ban_mask(tuple(ids), logits.shape[-1], logits.device)
    return torch.where(mask, NEG_INF, logits)


def suppress_tokens_at_begin(logits, cur_len: int, begin_index: int,
                             ids: Sequence[int]):
    """Ban ids only at the first free position (whisper bans eot and the
    space token right after the forced prefix)."""
    if not len(ids) or cur_len != begin_index:
        return logits
    return suppress_tokens(logits, ids)


def apply_min_new_tokens(logits, cur_len: int, begin_index: int,
                         min_new_tokens: int, eos_id: int):
    if not min_new_tokens or cur_len >= begin_index + min_new_tokens:
        return logits
    return suppress_tokens(logits, (eos_id,))


def seen_from_tokens(tokens, cur_len: int, vocab: int):
    """Dense seen-token set [B, V] of the buffer prefix ``tokens[:, :cur_len]``."""
    seen = torch.zeros((tokens.shape[0], vocab), dtype=torch.bool,
                       device=tokens.device)
    return seen.scatter_(1, tokens[:, :cur_len].long(), True)


def update_seen(seen, new_tokens):
    """seen [B, V] |= onehot(new_tokens [B]), in place."""
    return seen.scatter_(1, new_tokens.long()[:, None], True)


def repetition_penalty_from_seen(logits, seen, penalty: float):
    """Tokens in the seen set (prompt and generated so far) get score / p
    when positive, score * p otherwise."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def no_repeat_ngram(logits, tokens, cur_len: int, n: int):
    """Ban every token that would complete an n-gram already present in
    ``tokens[:, :cur_len]``: for each start s <= cur_len - n whose window
    ``tokens[s : s+n-1]`` equals the trailing (n-1)-gram, ban
    ``tokens[s+n-1]``."""
    if n <= 0 or cur_len < n:
        return logits
    seq = tokens[:, :cur_len].long()
    windows = seq.unfold(1, n, 1)                  # [B, W, n]
    tail = seq[:, cur_len - (n - 1):]              # [B, n-1]
    match = (windows[:, :, :n - 1] == tail[:, None, :]).all(dim=-1)
    ban = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    ban.scatter_add_(1, windows[:, :, n - 1], match.to(torch.int32))
    return torch.where(ban > 0, NEG_INF, logits)
