"""Greedy decoding and beam search with the KV cache: the port of the greedy
and beam paths of ``neuspeech1_tpu/decode/generate.py``.

The loops run eagerly, one cached decoder step per token. Greedy stops when
every row has emitted eos or ``max_length`` is reached, finished rows padded
with ``pad_id``. Beam search follows transformers 4.57's ``_beam_search``
as the JAX package does (see `beam_search`). Each loop waits for the device
once per step, to read its stop condition. The JAX package's length buckets
only bound XLA's fixed buffer shapes; tokens are the same without them, so
they are not ported. `generate` also dispatches self-speculative greedy
decoding (``spec_gamma >= 2``, ``decode/spec.py``). Sampling, beam-sample and
contrastive search raise here until they are ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from neuspeech1_tpu_torch.config import WhisperConfig
from neuspeech1_tpu_torch.decode import logits_process as lp
from neuspeech1_tpu_torch.models import whisper as tw

NEG = lp.NEG_INF  # the score of a banned token, a hit's demotion, an empty slot


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode settings; the fields and defaults of the JAX package's
    ``GenerationConfig`` that the greedy and beam paths read, plus the mode
    fields `generate` dispatches on. ``length_penalty`` and
    ``early_stopping`` keep the JAX function's parameters: the serving
    entry points leave them at 1.0 and False."""

    max_length: int = 448            # prompt + generated
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = False
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    suppress_ids: Tuple[int, ...] = ()
    begin_suppress_ids: Tuple[int, ...] = ()
    min_new_tokens: int = 0
    eos_id: int = 50257
    pad_id: int = 50257
    # the decode cross cache in int8 with per-channel scales
    # (models/whisper.py::init_cache(int8_cross=True))
    int8_kv_cache: bool = False
    do_sample: bool = False
    top_k: int = 0
    penalty_alpha: float = 0.0
    spec_gamma: int = 0

    @staticmethod
    def for_model(config: WhisperConfig, tokenizer=None,
                  **kw) -> "GenerationConfig":
        """Defaults from the model config; with ``tokenizer``, the HF
        whisper suppress / begin-suppress lists derived from its vocab.
        Explicit kwargs win."""
        kw.setdefault("eos_id", config.eot_id)
        kw.setdefault("pad_id", config.eot_id)
        kw.setdefault("max_length", config.max_target_positions)
        if tokenizer is not None:
            kw.setdefault("suppress_ids",
                          tuple(tokenizer.default_suppress_ids()))
            kw.setdefault("begin_suppress_ids",
                          tuple(tokenizer.default_begin_suppress_ids()))
        return GenerationConfig(**kw)


def _process_logits(logits, tokens, cur_len: int, gen: GenerationConfig,
                    prompt_len: int, seen):
    """The processor chain in HF's order. ``seen`` is the loop's
    incrementally kept seen-token set (None when there is no repetition
    penalty)."""
    logits = logits.float()
    logits = lp.suppress_tokens(logits, gen.suppress_ids)
    logits = lp.suppress_tokens_at_begin(logits, cur_len, prompt_len,
                                         gen.begin_suppress_ids)
    logits = lp.apply_min_new_tokens(logits, cur_len, prompt_len,
                                     gen.min_new_tokens, gen.eos_id)
    logits = lp.repetition_penalty_from_seen(logits, seen,
                                             gen.repetition_penalty)
    return lp.no_repeat_ngram(logits, tokens, cur_len,
                              gen.no_repeat_ngram_size)


@torch.no_grad()
def greedy_decode(model: tw.Whisper, features, prompt_ids,
                  gen: GenerationConfig):
    """features [B, ch, T], prompt_ids [B, P] -> tokens [B, max_length]
    (prompt, generated tokens, then ``pad_id``)."""
    enc = tw.encoder_apply(model, features)
    b, p = prompt_ids.shape
    length = gen.max_length
    cache = tw.init_cache(model, enc, max_len=length,
                          int8_cross=gen.int8_kv_cache)
    tokens = torch.full((b, length), gen.pad_id, dtype=torch.long,
                        device=enc.device)
    tokens[:, :p] = prompt_ids
    logits, cache = tw.decoder_apply(model, tokens[:, :p], enc, cache=cache,
                                     cache_index=0)
    last = logits[:, -1]
    seen = (lp.seen_from_tokens(tokens, p, last.shape[-1])
            if gen.repetition_penalty != 1.0 else None)
    finished = torch.zeros(b, dtype=torch.bool, device=enc.device)
    for cur_len in range(p, length):
        scores = _process_logits(last, tokens, cur_len, gen, p, seen)
        nxt = torch.where(finished, gen.pad_id, scores.argmax(dim=-1))
        tokens[:, cur_len] = nxt
        finished |= nxt == gen.eos_id
        if seen is not None:
            lp.update_seen(seen, nxt)
        # the step after the last position, or after every row finished,
        # would only feed logits nobody reads
        if cur_len + 1 == length or bool(finished.all()):
            break
        logits, cache = tw.decoder_apply(model, nxt[:, None], enc,
                                         cache=cache, cache_index=cur_len)
        last = logits[:, -1]
    return tokens


def _top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    in descending order, ties in ascending index order: ``lax.top_k``'s
    order, which the beam rules depend on (``torch.topk`` promises no order
    among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(layers: List[dict], beam_idx, batch: int, k: int):
    """Every self-cache leaf (rows b*K + j) reordered by the per-utterance
    beam indices ``beam_idx`` [B, K] (values in [0, K))."""
    rows = (beam_idx + k * torch.arange(batch, device=beam_idx.device)[:, None]
            ).reshape(-1)
    return [{name: x.index_select(0, rows) for name, x in layer.items()}
            for layer in layers]


@torch.no_grad()
def beam_search(model: tw.Whisper, features, prompt_ids,
                gen: GenerationConfig):
    """HF-semantics beam search (transformers 4.57 ``_beam_search``), the
    port of the JAX package's ``beam_search`` without sampling. Returns
    (tokens [B, max_length], scores [B]) of the best hypothesis per
    utterance.

    Per step: log_softmax of the logits, then the processors on the
    log-probs; the running scores plus the log-probs give [B, K, V]
    candidates, of which the 2K best per utterance come from a per-row
    top-2K and a merge over the [B, K*2K] pool (the same set and order as a
    flat top-2K: beam-major, then vocabulary id, on ties). A candidate hits
    when it emits eos or reaches max_length; the K alive beams are the top
    K of the 2K with hits demoted additively by -1e9; only the first K
    candidate positions may finalize, the finalized sequence includes its
    hitting token, and its score is divided by the generated length (the
    prompt excluded) to the power ``length_penalty``. The loop stops when
    the sticky per-utterance improvement bit is false everywhere, when
    every candidate hit, or (``early_stopping``) when every slot is
    finished. There is no post-loop alive fold: running beams finalize
    through the max-length hit of the last step, as in HF."""
    b, p = prompt_ids.shape
    k = gen.num_beams
    length = gen.max_length
    if length <= p:
        # degenerate budget: the loop never runs and no beam finalizes;
        # the JAX package returns the (truncated) prompt
        return (prompt_ids[:, :length].clone(),
                torch.zeros(b, dtype=torch.float32, device=prompt_ids.device))
    enc = tw.encoder_apply(model, features)
    dev = enc.device
    # one cross cache per utterance; the self cache holds B*K rows
    cache = tw.init_cache(model, enc, max_len=length,
                          int8_cross=gen.int8_kv_cache, self_batch=b * k)
    tokens = torch.full((b, k, length), gen.pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, :, :p] = prompt_ids[:, None, :]
    logits, cache = tw.decoder_apply(model, tokens.view(b * k, length)[:, :p],
                                     enc, cache=cache, cache_index=0)
    last = logits[:, -1]                                  # [B*K, V]
    vocab = last.shape[-1]

    alive_logp = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
    alive_logp[:, 0] = 0.0
    fin_seq = torch.full((b, k, length), gen.pad_id, dtype=torch.long,
                         device=dev)
    fin_scores = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
    fin_exists = torch.zeros((b, k), dtype=torch.bool, device=dev)
    # sticky per-utterance "running beams could still improve the finished
    # set" bit (HF's is_early_stop_heuristic_unsatisfied)
    improve_unsat = torch.ones(b, dtype=torch.bool, device=dev)
    seen = (lp.seen_from_tokens(tokens.view(b * k, length), p, vocab)
            if gen.repetition_penalty != 1.0 else None)
    offsets = k * torch.arange(b, device=dev)[:, None]
    first_k = torch.arange(2 * k, device=dev)[None, :] < k

    for cur_len in range(p, length):
        logp = torch.log_softmax(last.float(), dim=-1)
        logp = _process_logits(logp, tokens.view(b * k, length), cur_len, gen,
                               p, seen)
        total = alive_logp.reshape(b * k, 1) + logp       # [B*K, V]
        row_vals, row_ids = _top_k(total, 2 * k)          # [B*K, 2K]
        top_vals, pool_idx = _top_k(row_vals.reshape(b, 2 * k * k), 2 * k)
        top_beam = pool_idx // (2 * k)                    # [B, 2K]
        top_tok = row_ids.reshape(b, 2 * k * k).gather(1, pool_idx)
        if cur_len + 1 >= length:
            hits = torch.ones_like(top_tok, dtype=torch.bool)
        else:
            hits = top_tok == gen.eos_id

        # finished update (HF _update_finished_beams)
        cand_seq = tokens.gather(1, top_beam[..., None].expand(-1, -1, length))
        cand_seq[:, :, cur_len] = top_tok
        norm = float(cur_len + 1 - p) ** gen.length_penalty
        eligible = hits & first_k & improve_unsat[:, None]
        if gen.early_stopping:
            eligible &= ~fin_exists.all(dim=1, keepdim=True)
        all_exists = torch.cat([fin_exists, eligible], dim=1)
        all_scores = torch.cat(
            [fin_scores, torch.where(eligible, top_vals / norm, NEG)], dim=1)
        fin_scores, keep = _top_k(torch.where(all_exists, all_scores, NEG), k)
        fin_exists = all_exists.gather(1, keep)
        fin_seq = torch.cat([fin_seq, cand_seq], dim=1).gather(
            1, keep[..., None].expand(-1, -1, length))

        # alive update: hits demoted additively (HF
        # _get_running_beams_for_next_iteration)
        alive_logp, pick = _top_k(top_vals + hits.float() * NEG, k)
        new_beam = top_beam.gather(1, pick)                # [B, K]
        new_tok = top_tok.gather(1, pick)
        tokens = tokens.gather(1, new_beam[..., None].expand(-1, -1, length))
        tokens[:, :, cur_len] = new_tok

        # stopping state (HF _check_early_stop_heuristic) on the updated
        # finished set and the incremented length
        best = alive_logp.amax(dim=1) / norm
        improve_unsat &= torch.where(fin_exists.all(dim=1),
                                     best > fin_scores.amin(dim=1), True)
        go = improve_unsat.any() & ~hits.all()
        if gen.early_stopping:
            go &= ~fin_exists.all()
        # the one wait per step; the step after the last would only feed
        # logits nobody reads
        if cur_len + 1 == length or not bool(go):
            break
        rows = (new_beam + offsets).reshape(-1)
        if seen is not None:
            seen = lp.update_seen(seen.index_select(0, rows),
                                  new_tok.reshape(-1))
        cache["self"] = _gather_beams(cache["self"], new_beam, b, k)
        logits, cache = tw.decoder_apply(model, new_tok.reshape(b * k, 1), enc,
                                         cache=cache, cache_index=cur_len)
        last = logits[:, -1]
    return fin_seq[:, 0], fin_scores[:, 0]


def generate(model: tw.Whisper, features, prompt_ids, gen: GenerationConfig,
             draft_table=None):
    """Mode dispatch as in the JAX package; greedy, beam search (without
    sampling) and self-speculative greedy (``spec_gamma >= 2``, drafting
    from ``draft_table`` when given, see `decode.spec.spec_greedy_decode`)
    are ported. Returns tokens [B, max_length]."""
    if gen.spec_gamma >= 2 and (
            gen.do_sample or gen.num_beams > 1
            or (gen.penalty_alpha > 0 and gen.top_k > 1)):
        raise NotImplementedError(
            "spec_gamma only applies to plain greedy decode; unset "
            "do_sample/num_beams/penalty_alpha or spec_gamma")
    if gen.penalty_alpha > 0 and gen.top_k > 1 and not gen.do_sample:
        raise NotImplementedError(
            "contrastive search is not ported yet (ROADMAP.md queue 1)")
    if gen.do_sample:
        raise NotImplementedError(
            "sampling and beam-sample are not ported yet (ROADMAP.md queue 1)")
    if gen.num_beams > 1:
        return beam_search(model, features, prompt_ids, gen)[0]
    if gen.spec_gamma >= 2:
        # imported here: decode.spec builds on this module
        from neuspeech1_tpu_torch.decode.spec import spec_greedy_decode

        return spec_greedy_decode(model, features, prompt_ids, gen,
                                  gamma=gen.spec_gamma,
                                  draft_table=draft_table)[0]
    return greedy_decode(model, features, prompt_ids, gen)
