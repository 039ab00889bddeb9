"""Inference API of the PyTorch port: load a full model, transcribe brain
signals. The port of ``neuspeech1_tpu/serve.py`` for greedy decoding, beam
search (the eval CLI's decode: ``num_beams=5, repetition_penalty=5.0,
no_repeat_ngram_size=2``), self-speculative greedy decoding
(``spec_gamma``, drafting from the row's own prefix or, with
``spec_draft_from``, from a training manifest's sentences) and the int8
decode cross cache (``int8_kv_cache``):

    from neuspeech1_tpu_torch.serve import Transcriber
    t = Transcriber("runs/gwilliams_base/full_model", tokenizer="byte",
                    device="cuda")
    texts = t.transcribe(signals)            # [B, ch, T] numpy

Inputs are padded to ``batch_size`` rows, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from neuspeech1_tpu_torch.cli import common
from neuspeech1_tpu_torch.data.manifest import read_jsonlines
from neuspeech1_tpu_torch.decode.generate import GenerationConfig, generate
from neuspeech1_tpu_torch.decode.spec import build_draft_table


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
        spec_gamma: int = 0,
        spec_draft_from: Optional[str] = None,
        device: str = "cuda",
    ):
        """``suppress_tokens``: 'default' derives the HF whisper suppress /
        begin-suppress lists from the tokenizer's vocab, 'none' disables
        both, or a comma-separated id list. ``spec_gamma >= 2`` decodes
        greedily in gamma-token draft-verify steps; ``spec_draft_from`` (a
        jsonl manifest) drafts from its ``sentence`` texts. Sampling and
        int8 weights are not ported yet and raise."""
        unported = {"int8_weights": int8_weights, "do_sample": do_sample}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported yet (ROADMAP.md queue 1): {', '.join(asked)}")
        params, config, stem = common.load_full_model(model_dir)
        self.device = torch.device(device)
        self.model = common.commit_params(params, config, stem, self.device)
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
            spec_gamma=spec_gamma,
            **common.suppress_kwargs(suppress_tokens, self.tokenizer),
        )
        if spec_gamma >= 2 and num_beams > 1:
            raise ValueError(
                "spec_gamma only applies to plain greedy decode; unset "
                "num_beams/do_sample or spec_gamma")
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
        """Batched decode (greedy, speculative greedy with ``spec_gamma``, or
        beam search with ``num_beams > 1``); the last chunk is padded to ``batch_size`` rows by repeating its
        last signal."""
        signals = self._prepare(signals)
        out_texts: List[str] = []
        bs = self.batch_size
        prompt = torch.as_tensor(np.repeat(self.prompt, bs, axis=0),
                                 device=self.device)
        for i in range(0, signals.shape[0], bs):
            chunk = signals[i:i + bs]
            n = chunk.shape[0]
            if n < bs:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bs - n, axis=0)], axis=0)
            feats = common.upload_features(chunk, self.model.dtype,
                                           self.device)
            out = generate(self.model, feats, prompt, self.gen,
                           draft_table=self._draft_table).cpu().numpy()
            out_texts.extend(self.tokenizer.batch_decode(out[:n]))
        return out_texts

    def transcribe_with_timestamps(self, signals: np.ndarray):
        raise NotImplementedError(
            "timestamps (cross-attention DTW) are not ported yet "
            "(ROADMAP.md queue 1)")
