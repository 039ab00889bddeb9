"""Decoding with the KV cache: the port of
``neuspeech1_tpu/decode/generate.py``, every mode of it.

The loops run eagerly, one cached decoder step per token. Greedy stops when
every row has emitted eos or ``max_length`` is reached, finished rows padded
with ``pad_id``. Beam search follows transformers 4.57's ``_beam_search``
as the JAX package does (see `beam_search`); with ``do_sample`` it is HF's
beam-sample. `sample_decode` is multinomial sampling, `contrastive_search`
HF's contrastive search. Each loop waits for the device once per step, to
read its stop condition. Draws come from a ``torch.Generator`` on the
model's device as Gumbel noise (`gumbel_noise`), or from given noise
(``sample_noise``: the parity tests give both packages the same). The JAX
package's length buckets only bound XLA's fixed buffer shapes; tokens are
the same without them, so they are not ported. `generate` dispatches the
modes as the JAX package does, self-speculative greedy decoding
(``spec_gamma >= 2``, ``decode/spec.py``) included. Every mode but that
one takes a sequence bias (``bias_spec``, built by
``decode/sequence_bias.py``), applied after the other processors, and,
with ``GenerationConfig.timestamps``, whisper's timestamp grammar last
(``decode/timestamps.py``); the eval CLI's teacher forcing is
`teacher_forcing_predict`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from neuspeech1_tpu_torch.config import WhisperConfig
from neuspeech1_tpu_torch.decode import logits_process as lp
from neuspeech1_tpu_torch.decode.timestamps import timestamp_rules
from neuspeech1_tpu_torch.models import whisper as tw

NEG = lp.NEG_INF  # the score of a banned token, a hit's demotion, an empty slot


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode settings: the fields and defaults of the JAX package's
    ``GenerationConfig`` that the decode loops read. ``length_penalty`` and
    ``early_stopping`` keep the JAX function's parameters: the serving
    entry points leave them at 1.0 and False. Mode selection follows HF
    (`generate`): contrastive search when ``penalty_alpha > 0 and top_k >
    1`` without sampling; with ``do_sample``, beam-sample at ``num_beams >
    1``, else sampling; the warpers (temperature, ``top_k``, ``top_p``) run
    after the processors."""

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
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    penalty_alpha: float = 0.0
    spec_gamma: int = 0
    # whisper's timestamp grammar (decode/timestamps.py::timestamp_rules)
    timestamps: bool = False
    timestamp_begin: int = 50364
    notimestamps_id: int = 50363
    eot_id: int = 50257
    max_initial_timestamp_index: int = 50

    @staticmethod
    def for_model(config: WhisperConfig, tokenizer=None,
                  **kw) -> "GenerationConfig":
        """Defaults from the model config; with ``tokenizer``, the HF
        whisper suppress / begin-suppress lists derived from its vocab.
        Explicit kwargs win."""
        kw.setdefault("eos_id", config.eot_id)
        kw.setdefault("pad_id", config.eot_id)
        kw.setdefault("eot_id", config.eot_id)
        kw.setdefault("max_length", config.max_target_positions)
        kw.setdefault("timestamp_begin", config.timestamp_begin)
        kw.setdefault("notimestamps_id", config.notimestamps_id)
        if tokenizer is not None:
            kw.setdefault("suppress_ids",
                          tuple(tokenizer.default_suppress_ids()))
            kw.setdefault("begin_suppress_ids",
                          tuple(tokenizer.default_begin_suppress_ids()))
        return GenerationConfig(**kw)


def load_hf_generation_defaults(path: str) -> dict:
    """The suppress / begin-suppress token lists of a local HF
    ``generation_config.json`` (real whisper checkpoints ship a fixed list
    of non-speech ids there), as `GenerationConfig` kwargs."""
    with open(path) as f:
        cfg = json.load(f)
    out = {}
    if cfg.get("suppress_tokens"):
        out["suppress_ids"] = tuple(cfg["suppress_tokens"])
    if cfg.get("begin_suppress_tokens"):
        out["begin_suppress_ids"] = tuple(cfg["begin_suppress_tokens"])
    return out


def build_prompt(tokenizer, language="english", task="transcribe",
                 timestamps=False) -> np.ndarray:
    """Decoder prompt <|sot|><|lang|><|task|>[<|nots|>] as a [1, P] int32
    array; the per-sample non-English path passes labels[:, :4] instead."""
    return np.asarray([tokenizer.prefix_tokens(language, task, timestamps)],
                      dtype=np.int32)


def _process_logits(logits, tokens, cur_len: int, gen: GenerationConfig,
                    prompt_len: int, seen, bias_spec=None):
    """The processor chain in HF's order: the sequence bias after the
    others, the timestamp grammar last (under ``gen.timestamps``). ``seen``
    is the loop's incrementally kept seen-token set (None when there is no
    repetition penalty)."""
    logits = logits.float()
    logits = lp.suppress_tokens(logits, gen.suppress_ids)
    logits = lp.suppress_tokens_at_begin(logits, cur_len, prompt_len,
                                         gen.begin_suppress_ids)
    logits = lp.apply_min_new_tokens(logits, cur_len, prompt_len,
                                     gen.min_new_tokens, gen.eos_id)
    logits = lp.repetition_penalty_from_seen(logits, seen,
                                             gen.repetition_penalty)
    logits = lp.no_repeat_ngram(logits, tokens, cur_len,
                                gen.no_repeat_ngram_size)
    logits = lp.sequence_bias(logits, tokens, cur_len, bias_spec)
    if gen.timestamps:
        logits = timestamp_rules(logits, tokens, cur_len, gen, prompt_len,
                                 gen.max_initial_timestamp_index)
    return logits


def _warp(scores, gen: GenerationConfig, min_tokens_to_keep: int = 1):
    """The sampling warpers in HF's order: temperature, top-k, top-p."""
    scores = lp.temperature_warp(scores, gen.temperature)
    scores = lp.top_k_warp(scores, gen.top_k, min_tokens_to_keep)
    return lp.top_p_warp(scores, gen.top_p, min_tokens_to_keep)


# A noise source: ``noise(cur_len, shape)`` -> f32 [*shape] Gumbel noise for
# the step that writes position ``cur_len``.
Noise = Callable[[int, Tuple[int, ...]], torch.Tensor]


def gumbel_noise(generator: torch.Generator) -> Noise:
    """Standard Gumbel noise -log(-log(u)) drawn from ``generator`` (on
    its device), u uniform on [tiny, 1), as ``jax.random.gumbel`` draws it.
    ``argmax(scores + noise)`` is a categorical draw from softmax(scores)
    (``jax.random.categorical``'s rule), and the top-n of ``scores +
    noise`` a draw of n without replacement."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(cur_len: int, shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_(min=tiny)))

    return draw


def _noise_source(generator: Optional[torch.Generator], sample_noise,
                  device) -> Noise:
    """``sample_noise`` (a source, or a tensor indexed by the write
    position: [max_length, *shape]) or else Gumbel draws from
    ``generator`` (a generator seeded 0 on ``device`` when None). The
    decode loops read every draw through the source this returns."""
    if sample_noise is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return gumbel_noise(generator)
    if callable(sample_noise):
        return sample_noise
    return lambda cur_len, shape: sample_noise[cur_len].to(device).reshape(
        shape)


@torch.no_grad()
def greedy_decode(model: tw.Whisper, features, prompt_ids,
                  gen: GenerationConfig, lora=None, bias_spec=None):
    """features [B, ch, T], prompt_ids [B, P] -> tokens [B, max_length]
    (prompt, generated tokens, then ``pad_id``). ``lora``: an unmerged
    adapter tree (``models/lora.py``) applied in the encoder and in every
    decoder call; ``bias_spec``: a `logits_process.SequenceBiasSpec`."""
    enc = tw.encoder_apply(model, features, lora)
    b, p = prompt_ids.shape
    length = gen.max_length
    cache = tw.init_cache(model, enc, max_len=length,
                          int8_cross=gen.int8_kv_cache)
    tokens = torch.full((b, length), gen.pad_id, dtype=torch.long,
                        device=enc.device)
    tokens[:, :p] = prompt_ids
    logits, cache = tw.decoder_apply(model, tokens[:, :p], enc, cache=cache,
                                     cache_index=0, lora=lora)
    last = logits[:, -1]
    seen = (lp.seen_from_tokens(tokens, p, last.shape[-1])
            if gen.repetition_penalty != 1.0 else None)
    finished = torch.zeros(b, dtype=torch.bool, device=enc.device)
    for cur_len in range(p, length):
        scores = _process_logits(last, tokens, cur_len, gen, p, seen,
                                 bias_spec)
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
                                         cache=cache, cache_index=cur_len,
                                         lora=lora)
        last = logits[:, -1]
    return tokens


@torch.no_grad()
def sample_decode(model: tw.Whisper, features, prompt_ids,
                  gen: GenerationConfig, generator=None, sample_noise=None,
                  lora=None, bias_spec=None):
    """Multinomial sampling (HF ``do_sample=True`` at one beam): per step
    the processors, then the temperature, top-k and top-p warpers, then one
    draw per row, ``argmax(scores + noise)``; finished rows take
    ``pad_id``. The noise comes from ``sample_noise`` ([max_length, B, V],
    or a source, `Noise`) or else from ``generator`` (`_noise_source`).
    Returns tokens [B, max_length]; ``lora`` and ``bias_spec`` as in
    `greedy_decode`."""
    enc = tw.encoder_apply(model, features, lora)
    b, p = prompt_ids.shape
    length = gen.max_length
    noise = _noise_source(generator, sample_noise, enc.device)
    cache = tw.init_cache(model, enc, max_len=length,
                          int8_cross=gen.int8_kv_cache)
    tokens = torch.full((b, length), gen.pad_id, dtype=torch.long,
                        device=enc.device)
    tokens[:, :p] = prompt_ids
    logits, cache = tw.decoder_apply(model, tokens[:, :p], enc, cache=cache,
                                     cache_index=0, lora=lora)
    last = logits[:, -1]
    seen = (lp.seen_from_tokens(tokens, p, last.shape[-1])
            if gen.repetition_penalty != 1.0 else None)
    finished = torch.zeros(b, dtype=torch.bool, device=enc.device)
    for cur_len in range(p, length):
        scores = _warp(_process_logits(last, tokens, cur_len, gen, p, seen,
                                       bias_spec), gen)
        drawn = (scores + noise(cur_len, tuple(scores.shape))).argmax(dim=-1)
        nxt = torch.where(finished, gen.pad_id, drawn)
        tokens[:, cur_len] = nxt
        finished |= nxt == gen.eos_id
        if seen is not None:
            lp.update_seen(seen, nxt)
        if cur_len + 1 == length or bool(finished.all()):
            break
        logits, cache = tw.decoder_apply(model, nxt[:, None], enc,
                                         cache=cache, cache_index=cur_len,
                                         lora=lora)
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
                gen: GenerationConfig, lora=None, bias_spec=None,
                generator=None, sample_noise=None):
    """HF-semantics beam search (transformers 4.57 ``_beam_search``), the
    port of the JAX package's ``beam_search``. Returns (tokens [B,
    max_length], scores [B]) of the best hypothesis per utterance.

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
    through the max-length hit of the last step, as in HF. ``lora`` and
    ``bias_spec`` (applied to the log-probs of the B*K rows): as in
    `greedy_decode`.

    With ``gen.do_sample`` it is HF's beam-sample: the temperature, top-k
    and top-p warpers run per beam row after the processors and before the
    running scores are added (``min_tokens_to_keep`` 2), and the 2K
    candidates are the top 2K of the scores plus Gumbel noise [B, K*V]
    (per row, then merged over the pool, as without noise), a draw without
    replacement; their un-noised scores drive the finished and alive
    selection as above. The noise comes from ``sample_noise`` ([max_length,
    B, K*V], or a source, `Noise`) or else from ``generator``
    (`_noise_source`)."""
    b, p = prompt_ids.shape
    k = gen.num_beams
    length = gen.max_length
    if length <= p:
        # degenerate budget: the loop never runs and no beam finalizes;
        # the JAX package returns the (truncated) prompt
        return (prompt_ids[:, :length].clone(),
                torch.zeros(b, dtype=torch.float32, device=prompt_ids.device))
    enc = tw.encoder_apply(model, features, lora)
    dev = enc.device
    noise = (_noise_source(generator, sample_noise, dev) if gen.do_sample
             else None)
    # one cross cache per utterance; the self cache holds B*K rows
    cache = tw.init_cache(model, enc, max_len=length,
                          int8_cross=gen.int8_kv_cache, self_batch=b * k)
    tokens = torch.full((b, k, length), gen.pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, :, :p] = prompt_ids[:, None, :]
    logits, cache = tw.decoder_apply(model, tokens.view(b * k, length)[:, :p],
                                     enc, cache=cache, cache_index=0,
                                     lora=lora)
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
                               p, seen, bias_spec)
        if noise is None:
            total = alive_logp.reshape(b * k, 1) + logp   # [B*K, V]
            row_vals, row_ids = _top_k(total, 2 * k)      # [B*K, 2K]
            top_vals, pool_idx = _top_k(row_vals.reshape(b, 2 * k * k),
                                        2 * k)
        else:
            total = alive_logp.reshape(b * k, 1) + _warp(logp, gen, 2)
            drawn = noise(cur_len, (b, k * vocab)).reshape(b * k, vocab)
            row_noised, row_ids = _top_k(total + drawn, 2 * k)
            row_vals = total.gather(1, row_ids)           # un-noised
            _, pool_idx = _top_k(row_noised.reshape(b, 2 * k * k), 2 * k)
            top_vals = row_vals.reshape(b, 2 * k * k).gather(1, pool_idx)
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
                                         cache=cache, cache_index=cur_len,
                                         lora=lora)
        last = logits[:, -1]
    return fin_seq[:, 0], fin_scores[:, 0]


@torch.no_grad()
def contrastive_search(model: tw.Whisper, features, prompt_ids,
                       gen: GenerationConfig, lora=None, bias_spec=None):
    """HF-semantics contrastive search (``_contrastive_search`` /
    ``_ranking_fast``; the reference's ``model.generate(penalty_alpha=1,
    top_k=5)``, `utils/process_str.py:64-65`), the port of the JAX
    package's. Returns tokens [B, max_length].

    The self cache holds B*k rows and the cross cache one per utterance (the
    k candidate rows fold into the cross-attention query, as beam rows do).
    The prompt runs at B*k rows with the hidden states kept; a [B,
    max_length, d] buffer holds each row's final-LN hidden state at every
    written position. Per step: the processors on the selected row's
    logits, softmax, the top k candidates (ties in ascending id, as
    ``lax.top_k``), one decoder step on all B*k candidates (K7 at B*k rows,
    K6 at Tq = k), then each candidate's score ``(1 - alpha) p - alpha
    max_cos`` with max_cos its hidden state's largest cosine similarity to
    the buffer's positions before ``cur_len``; the argmax wins, its logits
    feed the next step, its hidden state enters the buffer, and its self
    cache row is copied to all k slots (`_gather_beams`). Finished rows
    take ``pad_id``. ``lora`` and ``bias_spec`` as in `greedy_decode`."""
    b, p = prompt_ids.shape
    k = gen.top_k
    length = gen.max_length
    enc = tw.encoder_apply(model, features, lora)
    dev = enc.device
    # f32, as the JAX package's: 1 - alpha is then rounded as there
    alpha = torch.tensor(gen.penalty_alpha, dtype=torch.float32, device=dev)
    cache = tw.init_cache(model, enc, max_len=length,
                          int8_cross=gen.int8_kv_cache, self_batch=b * k)
    tokens = torch.full((b, length), gen.pad_id, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt_ids
    logits, cache, hid = tw.decoder_apply(
        model, prompt_ids.repeat_interleave(k, dim=0), enc, cache=cache,
        cache_index=0, lora=lora, return_hidden=True)
    vocab, d = logits.shape[-1], hid.shape[-1]
    last = logits.view(b, k, p, vocab)[:, 0, -1]
    hbuf = torch.zeros((b, length, d), dtype=hid.dtype, device=dev)
    hbuf[:, :p] = hid.view(b, k, p, d)[:, 0]
    seen = (lp.seen_from_tokens(tokens, p, vocab)
            if gen.repetition_penalty != 1.0 else None)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    positions = torch.arange(length, device=dev)
    for cur_len in range(p, length):
        scores = _process_logits(last, tokens, cur_len, gen, p, seen,
                                 bias_spec)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        top_probs, top_ids = _top_k(e / e.sum(dim=-1, keepdim=True), k)
        logits_k, cache, hid_k = tw.decoder_apply(
            model, top_ids.reshape(b * k, 1), enc, cache=cache,
            cache_index=cur_len, lora=lora, return_hidden=True)
        nh = hid_k.view(b, k, d).float()
        ctx = hbuf.float()
        nh = nh / (nh * nh).sum(dim=-1, keepdim=True).sqrt()
        ctx = ctx / (ctx * ctx).sum(dim=-1, keepdim=True).sqrt()
        cos = torch.einsum("bld,bkd->bkl", ctx, nh)            # [B, k, L]
        degen = torch.where(positions < cur_len, cos, -np.inf).amax(dim=-1)
        sel = ((1.0 - alpha) * top_probs - alpha * degen).argmax(dim=-1)
        nxt = torch.where(finished, gen.pad_id, top_ids[rows, sel])
        last = logits_k.view(b, k, vocab)[rows, sel]
        tokens[:, cur_len] = nxt
        hbuf[:, cur_len] = hid_k.view(b, k, d)[rows, sel]
        finished |= nxt == gen.eos_id
        if seen is not None:
            lp.update_seen(seen, nxt)
        cache["self"] = _gather_beams(cache["self"], sel[:, None].expand(b, k),
                                      b, k)
        if bool(finished.all()):
            break
    return tokens


@torch.no_grad()
def teacher_forcing_predict(model: tw.Whisper, features, decoder_input_ids,
                            lora=None):
    """Argmax under a gold prefix (reference `evaluation.py:387-404`):
    [B, T] token ids, position t predicting the label at t."""
    return tw.forward(model, features, decoder_input_ids, lora).argmax(dim=-1)


def generate(model: tw.Whisper, features, prompt_ids, gen: GenerationConfig,
             lora=None, draft_table=None, bias_spec=None, generator=None):
    """Mode dispatch as in the JAX package (HF's mode selection):
    contrastive search when ``penalty_alpha > 0 and top_k > 1`` without
    sampling; with ``do_sample``, beam-sample at ``num_beams > 1`` and
    sampling otherwise, drawing from ``generator`` (seeded 0 when None);
    beam search at ``num_beams > 1``; self-speculative greedy at
    ``spec_gamma >= 2`` (drafting from ``draft_table`` when given, see
    `decode.spec.spec_greedy_decode`), which refuses the other modes and
    the sequence bias; else greedy. Every mode takes the unmerged adapter
    tree ``lora``, every mode but speculative greedy the sequence bias
    ``bias_spec``. Returns tokens [B, max_length]."""
    if gen.spec_gamma >= 2 and (
            gen.do_sample or gen.num_beams > 1
            or (gen.penalty_alpha > 0 and gen.top_k > 1)):
        raise NotImplementedError(
            "spec_gamma only applies to plain greedy decode; unset "
            "do_sample/num_beams/penalty_alpha or spec_gamma")
    if gen.penalty_alpha > 0 and gen.top_k > 1 and not gen.do_sample:
        return contrastive_search(model, features, prompt_ids, gen, lora,
                                  bias_spec)
    if gen.do_sample:
        if gen.num_beams > 1:
            return beam_search(model, features, prompt_ids, gen, lora,
                               bias_spec, generator=generator)[0]
        return sample_decode(model, features, prompt_ids, gen,
                             generator=generator, lora=lora,
                             bias_spec=bias_spec)
    if gen.num_beams > 1:
        return beam_search(model, features, prompt_ids, gen, lora,
                           bias_spec)[0]
    if gen.spec_gamma >= 2:
        if bias_spec is not None:
            raise NotImplementedError(
                "spec_gamma does not compose with sequence bias")
        # imported here: decode.spec builds on this module
        from neuspeech1_tpu_torch.decode.spec import spec_greedy_decode

        return spec_greedy_decode(model, features, prompt_ids, gen,
                                  gamma=gen.spec_gamma, lora=lora,
                                  draft_table=draft_table)[0]
    return greedy_decode(model, features, prompt_ids, gen, lora, bias_spec)
