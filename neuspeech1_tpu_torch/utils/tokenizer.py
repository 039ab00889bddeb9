"""Tokenizer abstraction for the Whisper-style decoder: the port's own copy
of ``neuspeech1_tpu/utils/tokenizer.py`` (stdlib only), reading the port's
``config``.

Two implementations:

  * ``ByteTokenizer`` — fully self-contained byte-level tokenizer with the
    multilingual-Whisper special-token *layout* (text block, <|endoftext|>,
    <|startoftranscript|>, language block, task tokens, <|notimestamps|>,
    1501 timestamp tokens).  Used by tests and synthetic training so the whole
    framework runs with zero downloaded assets.

  * ``HFTokenizerAdapter`` — wraps a local `transformers` WhisperTokenizer
    directory when real checkpoints are available (the reference uses
    `WhisperProcessor.from_pretrained`, `finetune.py:70-74`).

Label construction follows the reference contract exactly:
prefix ``<|sot|><|lang|><|task|>(<|notimestamps|>)`` then text ids then
``<|endoftext|>``; timestamp labels interleave per-sentence start/end tokens
(reference `utils/reader.py:356-401`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from neuspeech1_tpu_torch.config import WhisperConfig

# Multilingual Whisper language-token ordering: <|en|> = first_language_id,
# then the codes below in sequence (OpenAI tokenizer LANGUAGES order; the
# reference relies on the HF tokenizer's copy of the same table).
WHISPER_LANGUAGE_CODES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su yue"
).split()  # yue is 100th — only valid for large-v3 configs (num_languages=100)

# Friendly names for the commonly used subset (the reference datasets are
# English and Dutch); codes always work.
LANGUAGES = {
    "english": ("en", 0),
    "chinese": ("zh", 1),
    "german": ("de", 2),
    "spanish": ("es", 3),
    "russian": ("ru", 4),
    "korean": ("ko", 5),
    "french": ("fr", 6),
    "japanese": ("ja", 7),
    "portuguese": ("pt", 8),
    "turkish": ("tr", 9),
    "polish": ("pl", 10),
    "catalan": ("ca", 11),
    "dutch": ("nl", 12),
    "arabic": ("ar", 13),
    "swedish": ("sv", 14),
    "italian": ("it", 15),
    "indonesian": ("id", 16),
    "hindi": ("hi", 17),
    "finnish": ("fi", 18),
    "vietnamese": ("vi", 19),
}
CODE_TO_INDEX = {c: i for i, c in enumerate(WHISPER_LANGUAGE_CODES)}


def language_token_id(config: WhisperConfig, language: str) -> int:
    """Id of the ``<|xx|>`` token for a language name or code."""
    lang = language.lower()
    if lang in LANGUAGES:
        idx = LANGUAGES[lang][1]
    elif lang in CODE_TO_INDEX:
        idx = CODE_TO_INDEX[lang]
    else:
        raise KeyError(f"unknown language: {language!r}")
    if idx >= config.num_languages:
        raise KeyError(
            f"language {language!r} (index {idx}) outside this config's "
            f"{config.num_languages}-language block"
        )
    return config.language_id(idx)


class Tokenizer:
    """Interface; concrete classes provide _encode_text/_decode_text."""

    def __init__(self, config: WhisperConfig):
        self.config = config

    # -- text <-> ids ------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    # -- special-token helpers --------------------------------------------
    @property
    def eot_id(self) -> int:
        return self.config.eot_id

    @property
    def sot_id(self) -> int:
        return self.config.sot_id

    @property
    def pad_id(self) -> int:
        # Whisper uses <|endoftext|> as pad at the HF level.
        return self.config.eot_id

    def prefix_tokens(
        self,
        language: Optional[str] = "english",
        task: str = "transcribe",
        timestamps: bool = False,
    ) -> List[int]:
        """``<|sot|><|lang|><|task|>[<|notimestamps|>]``.

        With ``timestamps=True`` the ``<|notimestamps|>`` token is omitted
        (reference `utils/reader.py:360`: ``prefix_tokens[:3]``).
        """
        c = self.config
        toks = [c.sot_id]
        if language is not None:
            toks.append(language_token_id(c, language))
        toks.append(c.transcribe_id if task == "transcribe" else c.translate_id)
        if not timestamps:
            toks.append(c.notimestamps_id)
        return toks

    def get_prompt_ids(self, text: str) -> List[int]:
        """``<|startofprev|>`` + tokens of ``" " + text.strip()`` — HF
        `WhisperTokenizer.get_prompt_ids` (the input to the reference
        generate's prompt path, `utils/load_model.py:1258-1294`)."""
        return [self.config.startofprev_id] + list(
            self.encode(" " + text.strip())
        )

    def prefix_tokens_with_prompt(
        self,
        prompt_text: str,
        language: Optional[str] = "english",
        task: str = "transcribe",
        timestamps: bool = False,
    ) -> List[int]:
        """Full decode prefix for `<|startofprev|>` prompt conditioning:

        ``<|startofprev|> <prompt…> <|sot|><|lang|><|task|>[<|notimestamps|>]``

        The text prompt is sliced to the LAST ``max_target_positions//2 - 1``
        tokens, matching the OpenAI/HF context-window rule the reference
        inherits (`utils/load_model.py:1264-1268`)."""
        sop, *text_ids = self.get_prompt_ids(prompt_text)
        keep = self.config.max_target_positions // 2 - 1
        text_ids = text_ids[-keep:]
        return [sop] + text_ids + self.prefix_tokens(language, task, timestamps)

    def timestamp_id(self, seconds: float) -> int:
        """Timestamp token for ``seconds`` with the reference's even-centisecond
        rounding rule (`utils/reader.py:363-365`)."""
        c = self.config
        cs = round(seconds * 100)
        tok = c.timestamp_begin + cs // 2
        last = c.vocab_size - 1
        if tok > last:
            raise ValueError(f"timestamp {seconds}s out of range")
        return tok

    def build_labels(
        self,
        text: str,
        language: Optional[str] = "english",
        task: str = "transcribe",
    ) -> List[int]:
        """Plain (no-timestamp) labels: prefix + text ids + eot."""
        return self.prefix_tokens(language, task, timestamps=False) + self.encode(
            text
        ) + [self.eot_id]

    def build_timestamp_labels(
        self,
        sentences: Sequence[dict],
        language: Optional[str] = "english",
        task: str = "transcribe",
        level: str = "sentences",
    ) -> List[int]:
        """Timestamped labels per reference `utils/reader.py:356-401`.

        ``sentences`` is the jsonl ``sentences`` list: dicts with ``text``,
        ``start``, ``end`` (and ``words`` for level='words').
        """
        labels = self.prefix_tokens(language, task, timestamps=True)
        if level == "sentences":
            units = [(s["start"], s["end"], s["text"]) for s in sentences]
        elif level == "words":
            units = [
                (w["start"], w["end"], w["word"])
                for s in sentences
                for w in s["words"]
            ]
        else:
            raise NotImplementedError(level)
        for start, end, text in units:
            # Odd centiseconds are nudged inward (reference rounding rule).
            if round(start * 100) % 2 != 0:
                start += 0.01
            if round(end * 100) % 2 != 0:
                end -= 0.01
            labels.append(self.timestamp_id(start))
            labels.extend(self.encode(text))
            labels.append(self.timestamp_id(end))
        labels.append(self.eot_id)
        return labels

    def batch_decode(
        self, batch_ids, skip_special_tokens: bool = True
    ) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]

    # -- default suppress lists -------------------------------------------
    def non_speech_token_ids(self) -> List[int]:
        """Ids of non-speech annotation tokens, derived from the live vocab.

        Pure function of ``encode`` implementing the OpenAI whisper
        ``tokenizer.non_speech_tokens`` rule (the list HF bakes into every
        downloaded generation_config.json as ``suppress_tokens`` and the
        reference consumes via its generate override,
        `utils/load_model.py:1210-1294`): bracket/annotation symbols that
        encode to a single token — tried bare and space-prefixed — plus the
        first token of the musical-note family, plus word-initial hyphen
        and apostrophe (first token of " -" / " '")."""
        return _non_speech_token_ids(self)

    def default_suppress_ids(self) -> List[int]:
        """HF-default ``suppress_tokens`` for this vocab: the non-speech
        list plus the task/special tokens OpenAI's decoder always bans
        (translate, transcribe, sot, startofprev, startoflm, nospeech) —
        the exact content of a downloaded whisper generation_config.json,
        with no file needed."""
        c = self.config
        special = {c.translate_id, c.transcribe_id, c.sot_id,
                   c.startofprev_id, c.startoflm_id, c.nocaptions_id}
        return sorted(special | set(self.non_speech_token_ids()))

    def default_begin_suppress_ids(self) -> List[int]:
        """HF whisper's ``begin_suppress_tokens``: the space token and
        ``<|endoftext|>`` (banned at the first free decode slot). Vocabs
        with no space token (word-level) keep only the eot ban."""
        space = self.encode(" ")
        return ([space[0]] if space else []) + [self.config.eot_id]


# Symbol tables for the OpenAI non-speech-token rule (public constants from
# whisper/tokenizer.py; fixed by the algorithm, not by any vocabulary).
_NON_SPEECH_SYMBOLS = (
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    + "<< >> <<< >>> -- --- -( -[ ('- (' (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
)
_NON_SPEECH_MISC = set("♩♪♫♬♭♮♯")


def _non_speech_token_ids(tok: Tokenizer) -> List[int]:
    # word-initial hyphen / apostrophe: first token of " -" and " '"
    result = {tok.encode(" -")[0], tok.encode(" '")[0]}
    for symbol in _NON_SPEECH_SYMBOLS + list(_NON_SPEECH_MISC):
        for ids in (tok.encode(symbol), tok.encode(" " + symbol)):
            # multi-token symbols are skipped EXCEPT the musical notes,
            # whose 3-byte UTF-8 forms share a first token that is safe
            # to ban wholesale
            if len(ids) == 1 or symbol in _NON_SPEECH_MISC:
                result.add(ids[0])
    return sorted(result)


class ByteTokenizer(Tokenizer):
    """UTF-8 byte-level tokenizer: text token id == byte value (0..255).

    Fully offline; pairs with ``WhisperConfig.layout_for_vocab(256, ...)``.
    """

    N_TEXT = 256

    def __init__(self, config: WhisperConfig):
        super().__init__(config)
        if config.eot_id != self.N_TEXT:
            raise ValueError(
                "ByteTokenizer requires a config built with "
                "layout_for_vocab(256); got eot_id="
                f"{config.eot_id}"
            )

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def non_speech_token_ids(self) -> List[int]:
        """The OpenAI rule minus the word-initial hyphen/apostrophe seeds:
        those are defined as the FIRST token of " -" / " '", which only
        names a distinct id under a merging (BPE) vocab — here it is the
        space byte, and banning space would cripple decoding. Single-byte
        annotation symbols and the shared note-prefix byte remain."""
        ids = set(_non_speech_token_ids(self))
        ids -= {self.encode(" ")[0]}
        return sorted(ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i < 0:
                continue  # ignore label padding (-100)
            if i < self.N_TEXT:
                out.append(i)
            elif not skip_special_tokens:
                name = self._special_name(i)
                out.extend(name.encode("utf-8"))
        return bytes(out).decode("utf-8", errors="replace")

    def _special_name(self, i: int) -> str:
        c = self.config
        if i == c.eot_id:
            return "<|endoftext|>"
        if i == c.sot_id:
            return "<|startoftranscript|>"
        if c.first_language_id <= i < c.first_language_id + c.num_languages:
            return f"<|lang{i - c.first_language_id}|>"
        if i == c.translate_id:
            return "<|translate|>"
        if i == c.transcribe_id:
            return "<|transcribe|>"
        if i == c.notimestamps_id:
            return "<|notimestamps|>"
        if i >= c.timestamp_begin:
            return f"<|{(i - c.timestamp_begin) * 0.02:.2f}|>"
        return f"<|special{i}|>"


class WordTokenizer(Tokenizer):
    """Word-level vocabulary tokenizer: text token id == index in ``vocab``.

    Offline stand-in whose token granularity matches real Whisper BPE more
    closely than bytes: repetition penalty / no-repeat-ngram operate on
    WORDS (the reference's beam-5/rp5.0/ngram-2 eval config,
    `evaluation.py:369-386`, was tuned for subword tokens — under a byte
    vocab rp punishes repeated letters, which misrepresents it). Pairs with
    ``WhisperConfig.layout_for_vocab(len(vocab))``.
    """

    def __init__(self, config: WhisperConfig, vocab: Sequence[str]):
        super().__init__(config)
        self.vocab = list(vocab)
        if config.eot_id != len(self.vocab):
            raise ValueError(
                f"WordTokenizer needs a config built with layout_for_vocab("
                f"{len(self.vocab)}); got eot_id={config.eot_id}"
            )
        self._index = {w: i for i, w in enumerate(self.vocab)}

    def encode(self, text: str) -> List[int]:
        out = []
        for w in text.split():
            if w in self._index:
                out.append(self._index[w])
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if 0 <= i < len(self.vocab):
                words.append(self.vocab[i])
        return " ".join(words)

    def non_speech_token_ids(self) -> List[int]:
        # annotation symbols are not words; nothing vocab-derived to ban
        return []


class HFTokenizerAdapter(Tokenizer):
    """Wrap a local HF WhisperTokenizer (no network access is assumed).

    The special-token LAYOUT (eot/sot/language block/task ids/timestamp
    block) is derived from the loaded vocabulary and overlaid on the given
    config: a multilingual base tokenizer reproduces the default 51865
    layout exactly, while a large-v3 tokenizer (100 languages, vocab
    51866) or a test fixture with a tiny text vocab gets correct ids
    instead of silently inheriting the default layout. Geometry fields
    (d_model, layers, ...) of the provided config are preserved — the
    analog of the reference trusting `WhisperProcessor.from_pretrained`
    (`finetune.py:70-74`) to agree with its checkpoint.
    """

    def __init__(self, path_or_tokenizer, config: Optional[WhisperConfig] = None):
        if isinstance(path_or_tokenizer, str):
            from transformers import WhisperTokenizer  # lazy

            self.hf = WhisperTokenizer.from_pretrained(
                path_or_tokenizer, local_files_only=True
            )
        else:
            self.hf = path_or_tokenizer
        layout = self._derive_layout(self.hf)
        if config is None:
            config = WhisperConfig(**layout) if layout else WhisperConfig()
        elif layout:
            import dataclasses

            config = dataclasses.replace(config, **layout)
        super().__init__(config)

    @staticmethod
    def _derive_layout(hf) -> dict:
        """Layout fields from the tokenizer's own vocab; {} when the vocab
        does not carry the canonical Whisper special tokens (then the
        caller's config is trusted as-is)."""
        unk = hf.unk_token_id

        def tid(tok):
            i = hf.convert_tokens_to_ids(tok)
            return None if i is None or (i == unk and tok != hf.unk_token) \
                else int(i)

        eot = tid("<|endoftext|>")
        sot = tid("<|startoftranscript|>")
        translate = tid("<|translate|>")
        transcribe = tid("<|transcribe|>")
        startoflm = tid("<|startoflm|>")
        startofprev = tid("<|startofprev|>")
        # the no-speech token was renamed upstream; accept either spelling
        nocap = tid("<|nospeech|>")
        if nocap is None:
            nocap = tid("<|nocaptions|>")
        notimestamps = tid("<|notimestamps|>")
        need = (eot, sot, translate, transcribe, startoflm, startofprev,
                nocap, notimestamps)
        if any(v is None for v in need):
            return {}
        first_lang = sot + 1  # canonical layout: language block follows sot
        # 1501 timestamp tokens follow <|notimestamps|>; older local
        # tokenizer files do not register them as added tokens, so take
        # the larger of the registered length and the canonical block end
        return dict(
            vocab_size=max(len(hf), notimestamps + 1 + 1501),
            eot_id=eot, sot_id=sot,
            first_language_id=first_lang,
            num_languages=translate - first_lang,
            translate_id=translate, transcribe_id=transcribe,
            startoflm_id=startoflm, startofprev_id=startofprev,
            nocaptions_id=nocap, notimestamps_id=notimestamps,
        )

    def encode(self, text: str) -> List[int]:
        return self.hf.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids if int(i) >= 0]
        return self.hf.decode(ids, skip_special_tokens=skip_special_tokens)


def make_tokenizer(spec: str, config: Optional[WhisperConfig] = None) -> Tokenizer:
    """``spec``: 'byte', 'word:<vocab.txt path>' (one word per line), or a
    local HF tokenizer directory."""
    if spec == "byte":
        if config is None:
            from neuspeech1_tpu_torch.config import tiny_config

            config = tiny_config()
        return ByteTokenizer(config)
    if spec.startswith("word:"):
        with open(spec[5:]) as f:
            vocab = [w.strip() for w in f if w.strip()]
        if config is None or config.eot_id != len(vocab):
            from neuspeech1_tpu_torch.config import WhisperConfig as _WC

            layout = _WC.layout_for_vocab(len(vocab))
            kw = {} if config is None else {
                k: getattr(config, k)
                for k in ("num_mel_bins", "d_model", "encoder_layers",
                          "decoder_layers", "encoder_heads", "decoder_heads",
                          "encoder_ffn", "decoder_ffn",
                          "max_source_positions", "max_target_positions",
                          "dtype", "remat")
            }
            config = _WC(**{**kw, **layout})
        return WordTokenizer(config, vocab)
    return HFTokenizerAdapter(spec, config)
