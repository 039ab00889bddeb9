"""Logits processors and warpers for decoding: the port of the dense forms
in ``neuspeech1_tpu/decode/logits_process.py`` (HF's SuppressTokens,
SuppressTokensAtBegin, ForceTokens, MinNewTokens, RepetitionPenalty,
NoRepeatNGram and SequenceBias processors, and the Temperature, TopK and TopP warpers that
sampling and beam-sample apply after them).

Each takes scores [B, V] (greedy's logits, or beam search's log-probs) and,
where it needs them, the token buffer ``tokens`` [B, L] and the current
length ``cur_len``; positions at or past ``cur_len`` are never read.
Decoding here is eager, so ``cur_len`` is a Python int and a processor that
cannot fire at this step returns at once. Bans build a dense [V] or [B, V]
mask and apply it with one ``where``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

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


def force_tokens(logits, cur_len: int, forced_positions: Sequence[int],
                 forced_ids: Sequence[int]):
    """At the positions listed in ``forced_positions`` every score but the
    paired id's goes to ``NEG_INF`` and that one to 0 (HF's
    ForceTokensLogitsProcessor; whisper's <|lang|><|task|><|nots|>).
    ``forced_positions`` and ``forced_ids``: int sequences of equal
    length."""
    hits = [i for p, i in zip(forced_positions, forced_ids) if p == cur_len]
    if not hits:
        return logits
    # the JAX package sums the ids of every matching position
    row = torch.full((logits.shape[-1],), NEG_INF, dtype=logits.dtype,
                     device=logits.device)
    row[sum(hits)] = 0.0
    return row.expand_as(logits).clone()


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


# XLA's CPU backend sums a reduced dimension longer than this in windows of
# this many (its tree-reduction rewrite), level by level; the JAX package's
# sequence bias sums its per-entry deltas so
_XLA_REDUCE_WINDOW = 32


def _xla_sum_tree(n: int):
    """The order in which XLA's CPU backend sums ``n`` terms over a reduced
    dimension: a nested list of term indices. A group is summed from 0 in
    order; while more than 32 terms remain, they are cut into windows of
    32, the padding (to a multiple of 32) split half before and half after,
    and the windows' sums become the next level's terms."""
    groups = list(range(n))
    while len(groups) > _XLA_REDUCE_WINDOW:
        w = _XLA_REDUCE_WINDOW
        pad = -len(groups) % w
        lo = pad // 2
        groups = [groups[max(i - lo, 0):i - lo + w]
                  for i in range(0, len(groups) + pad, w)]
    return groups


def _sums_exactly(biases: Sequence[float]) -> bool:
    """True when every partial sum of ``biases`` (f32 values), in any
    order, is sure to be an f32 number: they are multiples of one power of
    two 2^-e whose magnitudes add up to at most 2^24 of it, as the CLI's
    -1.0 are. Then no order of summation can change a bit."""
    if not all(math.isfinite(b) for b in biases):
        return False
    ratios = [b.as_integer_ratio() for b in biases]
    scale = max(d for _, d in ratios)
    return sum(abs(n) * (scale // d) for n, d in ratios) <= 2 ** 24


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceBiasSpec:
    """Padded sequence-bias table (HF SequenceBiasLogitsProcessor), the
    JAX package's ``SequenceBiasSpec`` with CPU tensors:

    seqs: [S, Lmax] int32, left-padded with -1
    lengths: [S] int32
    biases: [S] float32, added to the last token's score when the tokens
    before it in the entry equal the trailing generated tokens.
    """

    seqs: torch.Tensor
    lengths: torch.Tensor
    biases: torch.Tensor
    _tables: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)

    @staticmethod
    def build(bias_map) -> Optional["SequenceBiasSpec"]:
        """bias_map: {tuple(token_ids): bias}; entries keep its order."""
        if not bias_map:
            return None
        lmax = max(len(k) for k in bias_map)
        seqs, lens, biases = [], [], []
        for k, v in bias_map.items():
            seqs.append([-1] * (lmax - len(k)) + list(k))
            lens.append(len(k))
            biases.append(float(v))
        return SequenceBiasSpec(
            torch.tensor(seqs, dtype=torch.int32),
            torch.tensor(lens, dtype=torch.int32),
            torch.tensor(biases, dtype=torch.float32),
        )

    def tables(self, device) -> tuple:
        """The spec on ``device``, made once per device: the entries'
        prefixes reversed (column j = the token j + 1 back from the scored
        position) [S, Lmax - 1] with the mask of the columns an entry does
        not have, the biases, each entry's last token, and the sum plan
        (`_sum_plan`), or None when the biases sum exactly in any order
        (`_sums_exactly`)."""
        key = str(device)
        if key not in self._tables:
            seqs = self.seqs.long()
            prefix = seqs[:, :-1].flip(1)
            free = (torch.arange(prefix.shape[1])[None, :]
                    >= self.lengths.long()[:, None] - 1)
            lasts = seqs[:, -1]
            plan = (None if _sums_exactly(self.biases.tolist())
                    else _sum_plan(lasts.tolist(), device))
            self._tables[key] = (prefix.to(device), free.to(device),
                                 self.biases.to(device), lasts.to(device),
                                 plan)
        return self._tables[key]


def _sum_plan(lasts: List[int], device):
    """The per-token sum of the entries' terms in `_xla_sum_tree`'s order,
    as a plan: the distinct last tokens (the sum's columns), the number of
    groups of entries (the tree's leaves), the tree with each leaf
    replaced by its group's index, and the rounds. Round r holds, for each
    (group, column) with more than r entries, its r-th entry in entry
    order: its (group, column) pairs are distinct, so a round adds at most
    once to each partial sum."""
    tokens = list(dict.fromkeys(lasts))
    column = {t: i for i, t in enumerate(tokens)}
    groups: List[List[int]] = []

    def shape(node):
        if not node or not isinstance(node[0], list):
            groups.append(node)
            return len(groups) - 1
        return [shape(child) for child in node]

    top = shape(_xla_sum_tree(len(lasts)))
    rank: Dict[Tuple[int, int], int] = {}
    rounds: List[list] = []
    for g, group in enumerate(groups):
        for s in group:
            c = column[lasts[s]]
            r = rank[g, c] = rank.get((g, c), -1) + 1
            if r == len(rounds):
                rounds.append([])
            rounds[r].append((g, c, s))
    return (torch.tensor(tokens, dtype=torch.long, device=device),
            len(groups), top,
            [tuple(torch.tensor(col, dtype=torch.long, device=device)
                   for col in zip(*rnd)) for rnd in rounds])


def _run_plan(plan, w):
    """[B, columns]: the per-token sums of the entries' terms ``w`` [S, B]
    by `_sum_plan`: each group's partial summed from 0 in entry order,
    then the partials summed from 0 in the tree's order, as XLA sums
    them."""
    tokens, n_groups, top, rounds = plan
    part = torch.zeros((n_groups, w.shape[1], tokens.shape[0]),
                       dtype=w.dtype, device=w.device)
    for group, col, ent in rounds:
        part[group, :, col] += w[ent]

    def combine(node):
        if isinstance(node, int):
            return part[node]
        acc = torch.zeros_like(part[0])
        for child in node:
            acc = acc + combine(child)
        return acc

    return combine(top)


def sequence_bias(logits, tokens, cur_len: int,
                  spec: Optional[SequenceBiasSpec]):
    """Add each entry's bias to its last token's score in the rows whose
    trailing tokens ``tokens[:, :cur_len]`` end with the entry's prefix
    (an entry of length 1 always applies). The JAX package sums per-entry
    [S, B, V] deltas and adds the sum to the scores; here the matched
    biases are summed per last token into a [B, V] delta that is then
    added once: the same f32 bits without the [S, B, V] tensor. Biases
    that sum exactly (`_sums_exactly`, the CLI's) are summed in one
    ``index_add_``; others in the order XLA sums the deltas
    (`_xla_sum_tree`), where the order decides the rounding."""
    if spec is None:
        return logits
    prefix, free, biases, lasts, plan = spec.tables(logits.device)
    n = prefix.shape[1]
    if n:
        # tail[:, j] = the token j + 1 back from cur_len, -2 before the
        # start, which no prefix token equals
        tail = tokens[:, max(cur_len - n, 0):cur_len].long().flip(1)
        if tail.shape[1] < n:
            tail = torch.nn.functional.pad(tail, (0, n - tail.shape[1]),
                                           value=-2)
        hit = (tail[None] == prefix[:, None]) | free[:, None]    # [S, B, n]
        matched = hit.all(dim=-1)                                # [S, B]
    else:
        matched = torch.ones((biases.shape[0], logits.shape[0]),
                             dtype=torch.bool, device=logits.device)
    w = torch.where(matched, biases[:, None], 0.0)               # [S, B]
    delta = torch.zeros_like(logits)
    if plan is None:
        delta.index_add_(1, lasts, w.t())
    else:
        delta[:, plan[0]] = _run_plan(plan, w)
    return logits + delta


def temperature_warp(logits, temperature: float):
    """HF TemperatureLogitsWarper: scores / temperature (an f32 divisor, as
    the JAX package's)."""
    if temperature == 1.0:
        return logits
    return logits / torch.tensor(temperature, dtype=torch.float32)


def top_k_warp(logits, k: int, min_tokens_to_keep: int = 1):
    """HF TopKLogitsWarper: every score strictly below the k-th largest is
    banned; ties with it stay. k <= 0 disables; ``min_tokens_to_keep``
    floors k (beam-sample passes 2, so that a non-eos continuation always
    survives)."""
    if k <= 0:
        return logits
    k = max(k, min_tokens_to_keep)
    if k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_warp(logits, p: float, min_tokens_to_keep: int = 1):
    """HF TopPLogitsWarper as the JAX package computes it: sort ascending,
    take the cumulative softmax, mark ``cum <= 1 - p`` as removed except the
    ``min_tokens_to_keep`` largest, then ban by value every score at or
    below the largest removed one (ties share a fate)."""
    if p >= 1.0:
        return logits
    v = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1).values
    e = torch.exp(sorted_logits - sorted_logits[..., -1:])
    cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    remove = cum <= (1.0 - p)
    remove[..., v - min_tokens_to_keep:] = False
    thresh = torch.where(remove, sorted_logits, -math.inf).amax(
        dim=-1, keepdim=True)
    return torch.where(logits <= thresh, NEG_INF, logits)
