"""Inference API of the PyTorch port: load a full model, transcribe brain
signals. The port of ``neuspeech1_tpu/serve.py``, every decode mode of it:
greedy decoding, beam search (the eval CLI's decode: ``num_beams=5,
repetition_penalty=5.0, no_repeat_ngram_size=2``), sampling and
beam-sample (``do_sample`` with ``temperature``, ``top_k``, ``top_p``,
drawn from a generator seeded with ``sample_seed`` once per call),
self-speculative greedy decoding (``spec_gamma``, drafting from the row's
own prefix or, with ``spec_draft_from``, from a training manifest's
sentences), int8 weights (``int8_weights``: the quantize-dequantize round
trip of the weights before they move to the device), the int8 decode cross
cache (``int8_kv_cache``) and token timestamps by cross-attention DTW
(`Transcriber.transcribe_with_timestamps`):

    from neuspeech1_tpu_torch.serve import Transcriber
    t = Transcriber("runs/gwilliams_base/full_model", tokenizer="byte",
                    device="cuda")
    texts = t.transcribe(signals)            # [B, ch, T] numpy
    rows = t.transcribe_with_timestamps(signals[0:1])

Inputs are padded to ``batch_size`` rows, as in the JAX package. With
``mesh`` (``parallel/mesh.py``: a ``DeviceMesh`` or a ``{axis: Ring}``
mapping, every rank building its own ``Transcriber``) the weights are split
over its ``fsdp`` and ``tensor`` axes (``parallel/sharding.py``), each
batch's rows over ``data`` x ``fsdp``, and every rank returns the whole
batch's texts (``decode/generate.py::generate_over_mesh``). A model whose
config names a ``seq_parallel_axis`` or a ``pipeline_axis`` of the mesh
runs its encoder pass over those axes (ring attention, GPipe stages, or
both), beside the splits; the cached decoder runs on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from neuspeech1_tpu_torch.cli import common
from neuspeech1_tpu_torch.data.manifest import read_jsonlines
from neuspeech1_tpu_torch.decode.generate import (
    GenerationConfig, generate_over_mesh, greedy_decode)
from neuspeech1_tpu_torch.decode.spec import build_draft_table
from neuspeech1_tpu_torch.decode.timestamps import word_timestamps
from neuspeech1_tpu_torch.models.quantize import (dequantize_params,
                                                  quantize_params)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.train.profiling import span


class Transcriber:
    def __init__(
        self,
        model_dir: str,
        tokenizer: str = "byte",
        batch_size: int = 8,
        num_beams: int = 1,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        max_new_tokens: int = 128,
        language: Optional[str] = "english",
        task: str = "transcribe",
        int8_weights: bool = False,
        int8_kv_cache: bool = False,
        suppress_tokens: str = "default",
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        sample_seed: int = 0,
        spec_gamma: int = 0,
        spec_draft_from: Optional[str] = None,
        device: str = "cuda",
        mesh=None,
    ):
        """``suppress_tokens``: 'default' derives the HF whisper suppress /
        begin-suppress lists from the tokenizer's vocab, 'none' disables
        both, or a comma-separated id list. ``spec_gamma >= 2`` decodes
        greedily in gamma-token draft-verify steps; ``spec_draft_from`` (a
        jsonl manifest) drafts from its ``sentence`` texts. ``do_sample``
        samples (beam-sample at ``num_beams > 1``) with the ``temperature``,
        ``top_k`` and ``top_p`` warpers, from a generator on ``device``
        seeded with ``sample_seed`` at each `transcribe` call.
        ``int8_weights`` serves the weights after an int8 round trip
        (`models/quantize.py`)."""
        params, config, stem = common.load_full_model(model_dir)
        if int8_weights:
            params = dequantize_params(quantize_params(params))
        self.device = torch.device(device)
        self.model = common.commit_params(params, config, stem, self.device)
        self.mesh = mesh
        if mesh is not None:
            from neuspeech1_tpu_torch.parallel import sharding

            sharding.shard_params(self.model, mesh)
        self.config = config
        self.stem = stem
        self.tokenizer = common.resolve_tokenizer(tokenizer, config)
        self.batch_size = batch_size
        self.language = language
        self.task = task
        self.prompt = np.asarray(
            [self.tokenizer.prefix_tokens(language, task)], np.int64)
        self.gen = GenerationConfig.for_model(
            config,
            max_length=self.prompt.shape[1] + max_new_tokens,
            num_beams=num_beams,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            int8_kv_cache=int8_kv_cache,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p,
            spec_gamma=spec_gamma,
            **common.suppress_kwargs(suppress_tokens, self.tokenizer),
        )
        if spec_gamma >= 2 and (num_beams > 1 or do_sample):
            raise ValueError(
                "spec_gamma only applies to plain greedy decode; unset "
                "num_beams/do_sample or spec_gamma")
        self._sample_seed = sample_seed
        self._draft_table = None
        if spec_draft_from:
            texts = [r["sentence"] for r in read_jsonlines(spec_draft_from)]
            table = build_draft_table(texts, self.tokenizer, config.vocab_size)
            self._draft_table = {k: torch.as_tensor(v, device=self.device)
                                 for k, v in table.items()}

    @property
    def expected_samples(self) -> int:
        return self.config.max_source_positions * 4

    def _prepare(self, signals: np.ndarray) -> np.ndarray:
        """[B, ch, T] -> clipped/padded to the model's input geometry."""
        signals = np.asarray(signals, np.float32)
        if signals.ndim == 2:
            signals = signals[None]
        b, ch, t = signals.shape
        need_ch = self.stem.in_channels
        if ch > need_ch:
            signals = signals[:, :need_ch]
        elif ch < need_ch:
            signals = np.pad(signals, ((0, 0), (0, need_ch - ch), (0, 0)))
        n = self.expected_samples
        signals = signals[:, :, :n]
        if signals.shape[-1] < n:
            signals = np.pad(
                signals, ((0, 0), (0, 0), (0, n - signals.shape[-1])))
        return signals

    def transcribe(self, signals: np.ndarray) -> List[str]:
        """Batched decode in the configured mode (`decode.generate.
        generate`); the last chunk is padded to ``batch_size`` rows by
        repeating its last signal. Sampling draws from one generator seeded
        with ``sample_seed`` for the call, so a call's texts depend only on
        the seed and the signals."""
        signals = self._prepare(signals)
        generator = (torch.Generator(device=self.device).manual_seed(
            self._sample_seed) if self.gen.do_sample else None)
        out_texts: List[str] = []
        bs = self.batch_size
        prompt = torch.as_tensor(np.repeat(self.prompt, bs, axis=0),
                                 device=self.device)
        for i in range(0, signals.shape[0], bs):
            with span("serve/batch"):
                chunk = signals[i:i + bs]
                n = chunk.shape[0]
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - n, axis=0)],
                        axis=0)
                with span("serve/upload"):
                    feats = common.upload_features(chunk, self.model.dtype,
                                                   self.device)
                with span("serve/generate"), pmesh.set_mesh(self.mesh):
                    out = generate_over_mesh(
                        self.model, feats, prompt, self.gen,
                        draft_table=self._draft_table,
                        generator=generator).cpu().numpy()
                with span("serve/detokenize"):
                    out_texts.extend(self.tokenizer.batch_decode(out[:n]))
        return out_texts

    def transcribe_with_timestamps(self, signals: np.ndarray
                                   ) -> List[List[dict]]:
        """Per-token start and end times by cross-attention DTW (an offline
        path): each clip alone, decoded greedily (one beam; the other
        settings as configured), trimmed after its first eot past the
        prompt, then `decode.timestamps.word_timestamps`. With a ``mesh``
        every rank runs it alone on the whole weights, gathered for the
        call, and its encoder on one device (a clip alone is one row, which
        a pipeline's microbatches do not split)."""
        model = self.model
        if self.mesh is not None:
            from neuspeech1_tpu_torch.parallel import sharding

            model = copy.copy(sharding.gather_params(self.model, self.mesh))
            model.config = dataclasses.replace(
                model.config, seq_parallel_axis=None, pipeline_axis=None)
        signals = self._prepare(signals)
        gen = dataclasses.replace(self.gen, num_beams=1)
        prompt = torch.as_tensor(self.prompt, device=self.device)
        p = prompt.shape[1]
        rows: List[List[dict]] = []
        for i in range(signals.shape[0]):
            feats = common.upload_features(signals[i:i + 1], model.dtype,
                                           self.device)
            out = greedy_decode(model, feats, prompt, gen)[0].tolist()
            toks = []
            for t in out:
                toks.append(t)
                if t == self.config.eot_id and len(toks) > p:
                    break
            rows.append(word_timestamps(model, feats, toks))
        return rows
