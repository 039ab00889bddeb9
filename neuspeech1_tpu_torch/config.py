"""Model / data configuration of the PyTorch port: the port's own copy of
``neuspeech1_tpu/config.py`` (stdlib only), with the same classes, fields
and defaults, so that a JAX config and a port config built from the same
keyword arguments compare field for field. Fields that only the JAX
package reads (sharding, remat, pipeline, scan unroll) are kept so that a
``config.json`` written by either package loads in both.

  * whisper-base geometry (6+6 layers, d_model=512, vocab 51865).
  * EEG stem replaces the mel conv1; stride budget must map 6000 samples
    (30 s @ 200 Hz) -> 1500 encoder frames so the pretrained positional table
    is reused unchanged.

Everything here is a frozen (hashable) dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StemConfig:
    """EEG/MEG -> encoder-frame projection stem.

    kind:
      'speech'  — Whisper's own mel stem: conv1(mel->d, k3, s1) (the usual path
                  when running on audio; reference `evaluation_speech.py`).
      'base'    — reference `utils/model_utils.py:10-17`: Conv(ch->d,k3,p1) +
                  GELU + Conv(d->d,k3,s2,p1); combined with whisper conv2 (s2)
                  this maps 6000 -> 1500.
      'replace' — reference `utils/model_utils.py:18-20`: single
                  Conv(ch->d,k3,s2,p1).
      'premel'  — reference `utils/load_model.py:1408-1521`
                  (MyWhisperForConditionalGeneration): Conv(ch->80,k5,s2,p2) +
                  channel dropout feeding the ORIGINAL whisper conv1; lets the
                  pretrained mel stem stay frozen.
    """

    kind: str = "base"
    in_channels: int = 208  # 208 = Gwilliams MEG, 273 = Schoffelen
    dropout: float = 0.0

    def __post_init__(self):
        if self.kind not in ("speech", "base", "replace", "premel"):
            raise ValueError(f"unknown stem kind: {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Geometry + special-token layout of a Whisper-style encoder-decoder.

    Defaults are whisper-base multilingual (reference `finetune.py:127`).
    Special-token ids follow the multilingual Whisper tokenizer layout; for
    self-contained testing the same *relative* layout is produced for small
    vocabularies by `layout_for_vocab`.
    """

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn: int = 2048
    decoder_ffn: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # --- special tokens (multilingual whisper-base values) ---
    eot_id: int = 50257            # <|endoftext|>; also pad at the HF level
    sot_id: int = 50258            # <|startoftranscript|>; decoder_start_token
    first_language_id: int = 50259  # <|en|>; languages occupy a contiguous block
    num_languages: int = 99
    translate_id: int = 50358
    transcribe_id: int = 50359
    startoflm_id: int = 50360
    startofprev_id: int = 50361
    nocaptions_id: int = 50362     # a.k.a. <|nospeech|>
    notimestamps_id: int = 50363
    # timestamp tokens run [notimestamps_id+1, vocab_size); 1501 of them for
    # 0.00..30.00 s at 0.02 s resolution (reference `utils/reader.py:363-365`).
    # --- numerics ---
    dtype: str = "bfloat16"        # activation/compute dtype on TPU
    param_dtype: str = "float32"   # master parameter dtype
    remat: bool = False            # jax.checkpoint each transformer layer
    # 'full' (recompute all) | 'flash' (save flash kernel o+lse) |
    # 'flash_qkv' (also save q/k/v; measured best: 357 ms vs 404 ms 'full'
    # at whisper-base bs64) | 'flash_mlp' | 'everything' | 'dots' | 'attn'
    remat_policy: str = "flash_qkv"
    flash_attention: str = "auto"  # 'auto'|'on'|'off' — Pallas flash kernel
    # minimum teacher-forcing query length for flash in the decoder. With
    # the BTC-layout kernels (no transposes/pads around the call) flash wins
    # even at T=64: 280.5 -> 264.8 ms/step at whisper-base bs64 (round-2
    # device measurements; the old BHTD path lost 22 ms there).
    decoder_flash_min_q: int = 1
    # minimum teacher-forcing query length for flash in the decoder's SELF
    # attention specifically (cross-attention keeps the gate above). At
    # T<=64 the [B,H,T,T] tensors are tiny and the kernel's per-instance
    # overhead dominates: XLA self-attn measured 201.8 -> 200.9 ms/step at
    # whisper-base bs64 label-len 64 (round 3b). Flash self still wins once
    # T is large enough that the T^2 intermediates matter.
    decoder_flash_self_min_q: int = 256
    # same split gate for the decoder's CROSS attention (q tiny, K/V = 1500
    # encoder frames). Kept on the kernel by default: the XLA path's
    # [B,H,Tq,1536] probs are ~100 MB/layer, so instance overhead matters
    # less than for self. A/B-able per config.
    decoder_flash_cross_min_q: int = 1
    # Sequence parallelism (opt-in, beyond the reference): mesh AXIS NAME to
    # ring-shard the encoder's self-attention over (parallel/ring_attention).
    # The enclosing jit must run under `jax.sharding.set_mesh(mesh)` so the
    # axis resolves against the ambient mesh; encoder frames (padded T) must
    # split into 128-multiple shards. Whisper's fixed 1500 frames never need
    # this — it exists for long-context encoder variants at scale.
    seq_parallel_axis: Optional[str] = None
    # Pipeline parallelism (opt-in, beyond the reference): mesh AXIS NAME to
    # GPipe-pipeline the encoder layer stack and the decoder's teacher-forcing
    # stack over (parallel/pipeline): stage s of P runs layers/P consecutive
    # layers and microbatches hop the ring. Requires the ambient mesh
    # (set_mesh) and layers % P == 0. The stages run the same attention,
    # with the same flash gates, as the unpipelined stack.
    pipeline_axis: Optional[str] = None
    # microbatches per pipeline flush; 0 = one per stage (minimum that fills
    # the pipe). Bubble fraction is (P-1)/(M+P-1) — raise M to amortize.
    pipeline_microbatches: int = 0
    # lax.scan unroll over the stacked layers. 0 = auto: FULL unroll on TPU
    # (264->250 ms/step at whisper-base bs64 — XLA drops the scan-carry
    # dynamic-update-slice stacking and schedules across layer boundaries;
    # compile ~49 s vs 14 s), scan with one compiled body elsewhere (keeps
    # CPU test compiles O(1) in depth). Partial unroll measured WORSE
    # (unroll=2: 295 ms).
    scan_unroll: int = 0

    @property
    def timestamp_begin(self) -> int:
        return self.notimestamps_id + 1

    @property
    def num_timestamps(self) -> int:
        return self.vocab_size - self.timestamp_begin

    def language_id(self, index: int) -> int:
        return self.first_language_id + index

    @staticmethod
    def layout_for_vocab(n_text: int, num_languages: int = 2, **kw) -> dict:
        """Special-token layout for a small test vocabulary.

        Mirrors the multilingual Whisper ordering: text tokens, <|endoftext|>,
        <|startoftranscript|>, languages, translate, transcribe, startoflm,
        startofprev, nocaptions, notimestamps, 1501 timestamp tokens.
        """
        eot = n_text
        sot = n_text + 1
        first_lang = n_text + 2
        translate = first_lang + num_languages
        transcribe = translate + 1
        startoflm = transcribe + 1
        startofprev = startoflm + 1
        nocaptions = startofprev + 1
        notimestamps = nocaptions + 1
        n_timestamps = kw.pop("num_timestamps", 1501)
        vocab = notimestamps + 1 + n_timestamps
        return dict(
            vocab_size=vocab,
            eot_id=eot,
            sot_id=sot,
            first_language_id=first_lang,
            num_languages=num_languages,
            translate_id=translate,
            transcribe_id=transcribe,
            startoflm_id=startoflm,
            startofprev_id=startofprev,
            nocaptions_id=nocaptions,
            notimestamps_id=notimestamps,
            **kw,
        )


# Whisper family geometries (multilingual; vocab/special tokens shared).
# The reference pins whisper-base (`finetune.py:127`) but loads any size via
# from_pretrained; these presets cover the family.
WHISPER_PRESETS = {
    "tiny":   dict(d_model=384,  encoder_layers=4,  decoder_layers=4,
                   encoder_heads=6,  decoder_heads=6,
                   encoder_ffn=1536, decoder_ffn=1536),
    "base":   dict(d_model=512,  encoder_layers=6,  decoder_layers=6,
                   encoder_heads=8,  decoder_heads=8,
                   encoder_ffn=2048, decoder_ffn=2048),
    "small":  dict(d_model=768,  encoder_layers=12, decoder_layers=12,
                   encoder_heads=12, decoder_heads=12,
                   encoder_ffn=3072, decoder_ffn=3072),
    "medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24,
                   encoder_heads=16, decoder_heads=16,
                   encoder_ffn=4096, decoder_ffn=4096),
    "large":  dict(d_model=1280, encoder_layers=32, decoder_layers=32,
                   encoder_heads=20, decoder_heads=20,
                   encoder_ffn=5120, decoder_ffn=5120, vocab_size=51866,
                   # large-v3: 128 mel bins; the extra <|yue|> language token
                   # shifts every later special id by +1
                   num_mel_bins=128, num_languages=100,
                   translate_id=50359, transcribe_id=50360,
                   startoflm_id=50361, startofprev_id=50362,
                   nocaptions_id=50363, notimestamps_id=50364),
}


def preset_config(name: str, **overrides) -> WhisperConfig:
    """WhisperConfig for a named family member ('tiny'...'large')."""
    kw = dict(WHISPER_PRESETS[name])
    kw.update(overrides)
    return WhisperConfig(**kw)


def tiny_config(n_text: int = 256, **overrides) -> WhisperConfig:
    """A small config for CPU tests: 2+2 layers, d=64."""
    layout = WhisperConfig.layout_for_vocab(n_text)
    base = dict(
        num_mel_bins=16,
        d_model=64,
        encoder_layers=2,
        decoder_layers=2,
        encoder_heads=2,
        decoder_heads=2,
        encoder_ffn=128,
        decoder_ffn=128,
        max_source_positions=100,
        max_target_positions=64,
        dtype="float32",
    )
    base.update(layout)
    base.update(overrides)
    return WhisperConfig(**base)


# Data-contract constants (reference `utils/reader.py:496-506`: 30 s * 200 Hz
# zero-padded clips).
SIGNAL_SAMPLE_RATE = 200
MAX_DURATION_S = 30.0
MIN_DURATION_S = 0.5
SIGNAL_SAMPLES = int(SIGNAL_SAMPLE_RATE * MAX_DURATION_S)  # 6000
AUDIO_SAMPLE_RATE = 16000
LABEL_IGNORE_ID = -100

# Per-dataset channel slices (reference `utils/reader.py:269-277` sniffs the
# file path; we make it an explicit argument with the same named presets).
DATASET_CHANNEL_SLICES = {
    "gwilliams": (0, 208),
    "schoffelen": (28, 301),
}


# --------------------------------------------------------------------------
# A decoder-only language model conditioned on the EEG tower
# --------------------------------------------------------------------------

TOPK_METHODS = ("noaux_tc",)
SCORING_FUNCS = ("sigmoid",)


@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    """A DeepSeek-V3-style decoder-only language model (``models/
    moe_lm.py``), under the keys of its published ``config.json``
    (defaults: Kimi-VL-A3B-Instruct's language model). Layers before
    ``first_k_dense_replace`` run a dense SwiGLU of ``intermediate_size``;
    the rest route each token to ``num_experts_per_tok`` of
    ``n_routed_experts`` SwiGLU experts of ``moe_intermediate_size`` beside
    ``n_shared_experts`` shared ones. Attention is MLA: q without
    compression (``q_lora_rank`` None), keys and values from a
    ``kv_lora_rank`` latent, one rope key of ``qk_rope_head_dim`` shared by
    the heads. ``dtype`` is the compute dtype and the dtype the frozen
    weights are held in."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.topk_method not in TOPK_METHODS:
            raise ValueError(f"topk_method {self.topk_method!r}: one of "
                             f"{TOPK_METHODS}")
        if self.scoring_func not in SCORING_FUNCS:
            raise ValueError(f"scoring_func {self.scoring_func!r}: one of "
                             f"{SCORING_FUNCS}")
        if self.n_group != 1 or self.topk_group != 1:
            raise ValueError("grouped expert selection (n_group, topk_group "
                             "other than 1) is not implemented")
        if self.q_lora_rank is not None:
            raise ValueError("q compression (q_lora_rank) is not implemented")
        if self.rope_scaling is not None:
            raise ValueError("rope_scaling is not implemented")
        if self.tie_word_embeddings:
            raise ValueError("a tied head is not implemented")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe_layer(self, i: int) -> bool:
        return (i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)


@dataclasses.dataclass(frozen=True)
class MegLMConfig:
    """The EEG tower before a decoder-only language model (``models/
    meg_lm.py``): the Whisper encoder of ``tower`` behind ``stem``, a
    projector that merges ``merge_frames`` consecutive frames into one row
    of the language model's width, and ``lm``. The projected frames are a
    soft prefix; the language model is teacher-forced on ``start_id``
    followed by the labels after it, pads read as ``pad_id``. A forward
    that records gradients runs each language-model layer under a
    checkpoint (the tower keeps ``tower.remat``)."""

    tower: WhisperConfig = WhisperConfig()
    stem: StemConfig = StemConfig()
    lm: MoELMConfig = MoELMConfig()
    merge_frames: int = 4
    start_id: int = 163584
    pad_id: int = 163839

    def __post_init__(self):
        if self.tower.max_source_positions % self.merge_frames:
            raise ValueError("the tower's frames must split into whole "
                             "groups of merge_frames")
        if self.tower.seq_parallel_axis or self.tower.pipeline_axis:
            raise ValueError("the language-model step runs the tower on one "
                             "device: no seq_parallel_axis or pipeline_axis")
        for name in ("start_id", "pad_id"):
            if not 0 <= getattr(self, name) < self.lm.vocab_size:
                raise ValueError(f"{name} lies outside the vocabulary")
