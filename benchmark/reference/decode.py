"""The reference's reading of served beam-search tokens.

For each checked clip it runs the model in float32 without TF32 over the
prompt and the tokens the program served (teacher forcing), and at every
step of the decode takes the log-softmax of the logits with the beam
search's processors applied: the repetition penalty on every token seen so
far, prompt included (a log-probability is multiplied by the penalty), and
the ban of every token that would repeat an n-gram (-1e9). Three
readings come of it.

Token gaps. A beam keeps only the 2K best tokens of each of its rows, so
every served token must lie among the 2K best of its row's processed
log-probabilities; its gap is how far it lies below the 2K-th best. At the
last step every candidate finishes and the best of them is served, so a
hypothesis that runs to the last position took there its row's best
token: its gap at that position is how far it lies below the row's best,
as a greedy token's is. Positions after a served eos are padding and are
not read.

Greedy share. A five-beam search's best hypothesis leaves its rows' best
token somewhere before the last position, by a step worth the detour:
the share of hypotheses that never do by `DETOUR` or more is the greedy
share. Greedy tokens follow their rows' best throughout, but for rounding
flips of a few hundredths.

Score gaps (read by ``tools/readings.py``, not compared: at random
weights they do not tell the served beam from greedy tokens; PERF.md). A
served hypothesis's score is the sum of its processed
log-probabilities, eos included, over its generated length (length
penalty 1.0, as the eval serves). `beam_search` is a plain beam search of
the same rules (HF's: the 2K best candidates over all beams, those that
hit eos or the last position among the first K finish, the K best others
run on, a row stops once its finished set is full and no running beam can
beat it), run in float32 over the same clips; the score gap of a clip is
how far the served hypothesis's score lies below the reference search's
best.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as ref

NEG = -1e9
# a step this far or farther below its row's best is a beam's detour, not
# a rounding flip
DETOUR = 0.02
# the eval serves HF's default: a hypothesis's summed log-probability over
# its generated length
LENGTH_PENALTY = 1.0


def processed_logp(logits, tokens, cur_len: int, penalty: float,
                   ngram: int):
    """[n, V] log-probs at step ``cur_len`` of rows ``tokens`` [n, L]."""
    logp = logits.float().log_softmax(-1)
    seen = torch.zeros_like(logp, dtype=torch.bool)
    seen.scatter_(1, tokens[:, :cur_len], True)
    if penalty != 1.0:
        logp = torch.where(seen, torch.where(logp > 0, logp / penalty,
                                             logp * penalty), logp)
    if ngram > 0 and cur_len >= ngram:
        ban = torch.zeros_like(seen)
        tail = tokens[:, cur_len - ngram + 1:cur_len]
        for s in range(cur_len - ngram + 1):
            hit = (tokens[:, s:s + ngram - 1] == tail).all(dim=1)
            rows = hit.nonzero()[:, 0]
            ban[rows, tokens[rows, s + ngram - 1]] = True
        logp = logp.masked_fill(ban, NEG)
    return logp


def _best(x, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(tree: dict, config: dict, traffic: dict, signals,
                prompt: list) -> tuple:
    """(tokens [n, prompt + new], scores [n]): the best finished hypothesis
    of each clip of ``signals`` [n, ch, S] (a tensor on the device) and its
    score, by a plain beam search over the reference model. Runs under the
    caller's precision."""
    k = traffic["num_beams"]
    p = len(prompt)
    length = p + traffic["new_tokens"]
    eos = config["model"]["eot_id"]
    n = signals.shape[0]
    dev = signals.device
    cross = ref.cross_kv(tree, config, ref.encoder(tree, config, signals))
    tokens = torch.full((n, k, length), eos, dtype=torch.long, device=dev)
    tokens[:, :, :p] = torch.as_tensor(prompt, device=dev)
    alive = torch.full((n, k), NEG, device=dev)
    alive[:, 0] = 0.0
    fin_tokens = tokens.clone()
    fin_scores = torch.full((n, k), NEG, device=dev)
    fin_has = torch.zeros((n, k), dtype=torch.bool, device=dev)
    still_open = torch.ones(n, dtype=torch.bool, device=dev)
    first_k = torch.arange(2 * k, device=dev)[None, :] < k
    for cur in range(p, length):
        rows = tokens.view(n * k, length)
        logits = ref.decoder(tree, config, rows[:, :cur], cross=cross,
                             last=True)[:, -1]
        logp = processed_logp(logits, rows, cur,
                              traffic["repetition_penalty"],
                              traffic["no_repeat_ngram_size"])
        vocab = logp.shape[-1]
        total = (alive[:, :, None] + logp.view(n, k, vocab)).view(n, -1)
        vals, flat = _best(total, 2 * k)
        beam, tok = flat // vocab, flat % vocab
        last = cur + 1 == length
        hit = torch.ones_like(first_k).expand_as(tok) if last else tok == eos
        seq = tokens.gather(1, beam[..., None].expand(-1, -1, length))
        seq[:, :, cur] = tok
        norm = float(cur + 1 - p) ** LENGTH_PENALTY
        new = hit & first_k & still_open[:, None]
        has = torch.cat([fin_has, new], dim=1)
        scores = torch.cat([fin_scores, torch.where(new, vals / norm, NEG)],
                           dim=1)
        fin_scores, keep = _best(torch.where(has, scores, NEG), k)
        fin_has = has.gather(1, keep)
        fin_tokens = torch.cat([fin_tokens, seq], dim=1).gather(
            1, keep[..., None].expand(-1, -1, length))
        alive, pick = _best(vals + hit.float() * NEG, k)
        tokens = seq.gather(1, pick[..., None].expand(-1, -1, length))
        still_open &= torch.where(
            fin_has.all(dim=1),
            alive.amax(dim=1) / norm > fin_scores.amin(dim=1), True)
        if last or not bool(still_open.any()) or bool(hit.all()):
            break
    return fin_tokens[:, 0], fin_scores[:, 0]


def token_gaps(tree: dict, config: dict, traffic: dict, signals: np.ndarray,
               tokens: np.ndarray, device, control: bool = False) -> tuple:
    """(gaps, below_best [n, new_tokens], scores [n]) of the served
    ``tokens`` [n, prompt + new] for ``signals`` [n, ch, S] f32,
    ``reference_rows`` clips at a time: each position's gap (0 inside the
    2K best, or at the last position 0 for the row's best), how far each
    token lies below its row's best (both NaN past a served eos), and each
    hypothesis's score. With ``control`` the token read at each position
    is the one the reference in fp8 puts first there, on the same prefix:
    the control's readings."""
    p = tokens.shape[1] - traffic["new_tokens"]
    k2 = 2 * traffic["num_beams"]
    eos = config["model"]["eot_id"]
    out = np.full((tokens.shape[0], traffic["new_tokens"]), np.nan)
    below_best = out.copy()
    scores = np.zeros(tokens.shape[0])
    rows = traffic["reference_rows"]
    with ref.exact_f32(), torch.no_grad():
        for lo in range(0, tokens.shape[0], rows):
            x = torch.as_tensor(signals[lo:lo + rows], device=device)
            toks = torch.as_tensor(tokens[lo:lo + rows], device=device)
            enc = ref.encoder(tree, config, x)
            logits = ref.decoder(tree, config, toks[:, :-1], enc)
            if control:
                with ref.precision("fp8"):
                    low = ref.decoder(tree, config, toks[:, :-1],
                                      ref.encoder(tree, config, x))
            done = torch.zeros(toks.shape[0], dtype=torch.bool, device=device)
            total = torch.zeros(toks.shape[0], device=device)
            count = torch.zeros(toks.shape[0], device=device)
            for cur in range(p, toks.shape[1]):
                logp = processed_logp(logits[:, cur - 1], toks, cur,
                                      traffic["repetition_penalty"],
                                      traffic["no_repeat_ngram_size"])
                best = logp.topk(k2, dim=-1).values
                kth = best[:, -1]
                if cur == toks.shape[1] - 1:
                    kth = best[:, 0]
                pick = toks[:, cur:cur + 1]
                served = logp.gather(1, pick)[:, 0]
                total += torch.where(done, 0.0, served)
                count += (~done).float()
                if control:
                    pick = processed_logp(
                        low[:, cur - 1], toks, cur,
                        traffic["repetition_penalty"],
                        traffic["no_repeat_ngram_size"]).argmax(-1,
                                                                keepdim=True)
                    served = logp.gather(1, pick)[:, 0]
                below_best[lo:lo + rows, cur - p] = torch.where(
                    done, torch.nan, best[:, 0] - served).cpu().numpy()
                gap = (kth - served).clamp(min=0.0)
                gap = torch.where(done, torch.nan, gap)
                out[lo:lo + rows, cur - p] = gap.cpu().numpy()
                done |= toks[:, cur] == eos
            scores[lo:lo + rows] = (total / count ** LENGTH_PENALTY
                                    ).cpu().numpy()
    return out, below_best, scores


def greedy_share(below_best: np.ndarray) -> float:
    """The share of hypotheses (rows of `token_gaps`'s ``below_best``) that
    never lie `DETOUR` or more below their row's best before the last
    position."""
    return float(np.mean(~(np.nan_to_num(below_best[:, :-1]) >= DETOUR).any(
        axis=1)))


def searched(tree: dict, config: dict, traffic: dict, signals: np.ndarray,
             prompt: list, device, precision=None) -> tuple:
    """(scores [n], tokens [n, L]) of `beam_search`'s best hypothesis over
    each clip of ``signals``, ``reference_rows`` clips at a time, in float32
    without TF32, or with ``precision`` ('fp8') for the control."""
    scores, found = [], []
    rows = traffic["reference_rows"]
    with ref.exact_f32(), torch.no_grad(), ref.precision(precision):
        for lo in range(0, signals.shape[0], rows):
            x = torch.as_tensor(signals[lo:lo + rows], device=device)
            toks, best = beam_search(tree, config, traffic, x, prompt)
            scores.append(best.cpu().numpy())
            found.append(toks.cpu().numpy())
    return np.concatenate(scores), np.concatenate(found)
