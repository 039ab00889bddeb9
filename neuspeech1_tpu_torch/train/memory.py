"""Device-memory budget arithmetic: pick the fastest remat setting that
fits. The port's copy of ``neuspeech1_tpu/train/memory.py``, with the same
arithmetic, so that for the same memory figure both packages decide alike;
only the figure comes from the CUDA device here (the JAX default, 16 GiB,
on the CPU). The activation constants below were anchored on a TPU v5e;
the finetune phase of ``chip_smoke.py`` sets the plan beside the card's
measured peak.

`remat=False` (save every activation) is the faster step, but only when
params + optimizer state + device-cached corpus + saved activations fit the
device. The finetune CLI's `--remat=auto` reads this decision.

The reference delegates memory policy entirely to torch/HF (gradient
checkpointing is never enabled there; `finetune.py:231-253` has no such
flag) — this is a TPU-native concern with no reference counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig

# The JAX package's per-chip default (a TPU v5e's 16 GiB), used for the CPU.
DEFAULT_HBM_BYTES = 16 * 1024**3

# Saved d-model-equivalent tensors per encoder layer without remat, at
# MLP ratio f/d = 4: ln out, q, k, v, flash o(+lse), attn proj, residual,
# final-ln out, fc2 out, residual (10·d) + fc1 pre-act, gelu (2·f = 8·d).
# Empirical anchor: whisper-base bs64 T=1536 -> 18·d ≈ 10.9 GB, matching
# the ~10 GB observed when remat=False first fit (BASELINE.md round 2b).
_ENC_SAVED_PER_D = 10
_DEC_EXTRA_PER_D = 7  # cross-attn block: ln, q, k, v, proj, residual, +1 slack


def device_hbm_bytes(device=None) -> int:
    """The device's memory: ``total_memory`` of a CUDA device, or
    ``DEFAULT_HBM_BYTES`` for the CPU."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return DEFAULT_HBM_BYTES


def param_count(config: WhisperConfig, stem: StemConfig) -> int:
    """Exact-enough parameter count from the config geometry."""
    d, v = config.d_model, config.vocab_size
    fe, fd = config.encoder_ffn, config.decoder_ffn
    ch = stem.in_channels

    def attn():
        return 4 * d * d + 3 * d  # q/k/v/out weights; k has no bias

    enc_layer = attn() + 2 * (2 * d) + d * fe + fe + fe * d + d
    dec_layer = 2 * attn() + 3 * (2 * d) + d * fd + fd + fd * d + d
    stem_p = 0
    if stem.kind == "base":
        stem_p = ch * d * 3 + d + d * d * 3 + d
    elif stem.kind == "replace":
        stem_p = ch * d * 3 + d
    elif stem.kind == "premel":
        stem_p = ch * config.num_mel_bins * 5 + config.num_mel_bins \
            + config.num_mel_bins * d * 3 + d
    elif stem.kind == "speech":
        stem_p = config.num_mel_bins * d * 3 + d
    conv2 = d * d * 3 + d
    return (
        v * d
        + config.max_source_positions * d
        + config.max_target_positions * d
        + stem_p + conv2
        + config.encoder_layers * enc_layer
        + config.decoder_layers * dec_layer
        + 2 * (2 * d)  # ln_post + decoder ln
    )


def trainable_count_estimate(config: WhisperConfig, stem: StemConfig,
                             ft_full: bool, lora_rank: Optional[int] = None,
                             adalora: bool = False) -> int:
    """Parameters carrying AdamW state: everything under ft_full, else the
    trainable stem + conv2 + encoder LoRA (6 target matrices/layer,
    reference `finetune.py:194-198`)."""
    if ft_full:
        return param_count(config, stem)
    d = config.d_model
    ch = stem.in_channels
    stem_p = ch * d * 3 + d + d * d * 3 + d + d * d * 3 + d
    r = lora_rank or (12 if adalora else 32)
    per_mat = r * (d + d) + (r if adalora else 0)
    lora_p = config.encoder_layers * 6 * per_mat
    return stem_p + lora_p


def activation_bytes(config: WhisperConfig, batch_size: int,
                     label_len: int = 128) -> int:
    """Saved-activation bytes for one no-remat fwd+bwd step (encoder at the
    flash-padded T, decoder at ``label_len`` teacher-forcing tokens)."""
    itemsize = getattr(torch, config.dtype).itemsize
    t_enc = -(-config.max_source_positions // 128) * 128  # q-block padded
    d = config.d_model
    enc_per_layer = (
        _ENC_SAVED_PER_D * d + 2 * config.encoder_ffn
    ) * batch_size * t_enc
    dec_per_layer = (
        (_ENC_SAVED_PER_D + _DEC_EXTRA_PER_D) * d + 2 * config.decoder_ffn
    ) * batch_size * label_len
    # stem + CE: input features, stem intermediates (~4 d-frames), f32 lse
    # row stats, and the [B, T_lab, V] logits + dlogits pair for the loss
    other = batch_size * (
        4 * d * t_enc + label_len * config.vocab_size * 2
    )
    return itemsize * (
        config.encoder_layers * enc_per_layer
        + config.decoder_layers * dec_per_layer
        + other
    )


def train_memory_plan(
    config: WhisperConfig,
    stem: StemConfig,
    batch_size: int,
    trainable_count: Optional[int] = None,
    corpus_bytes: int = 0,
    hbm_bytes: Optional[int] = None,
    label_len: int = 128,
    device=None,
) -> dict:
    """Breakdown + decision: does the fast no-remat step fit HBM?

    ``trainable_count``: parameters with AdamW state (m+v f32) and f32
    gradients; defaults to the full parameter count (ft_full — the
    conservative bound for adapter runs, pass the real count when known).
    """
    n_params = param_count(config, stem)
    if trainable_count is None:
        trainable_count = n_params
    hbm = hbm_bytes if hbm_bytes is not None else device_hbm_bytes(device)
    params_b = 4 * n_params           # f32 master copy
    opt_b = 8 * trainable_count       # AdamW m+v f32
    grads_b = 4 * trainable_count     # transient f32 grads
    act_b = activation_bytes(config, batch_size, label_len)
    total_no_remat = params_b + opt_b + grads_b + corpus_bytes + act_b
    # 92% usable (XLA scratch / fragmentation margin) — calibrated so the
    # proven-fitting whisper-base bs64 no-corpus config (BASELINE.md round
    # 2b, remat=False measured fastest) lands inside the budget while
    # whisper-small bs64 (3x the activations) lands outside
    fits = total_no_remat <= 0.92 * hbm
    return {
        "hbm_bytes": hbm,
        "params_bytes": params_b,
        "opt_bytes": opt_b,
        "grads_bytes": grads_b,
        "corpus_bytes": corpus_bytes,
        "activation_bytes": act_b,
        "total_no_remat": total_no_remat,
        "fits_no_remat": bool(fits),
    }


def resolve_remat(
    spec,
    config: WhisperConfig,
    stem: StemConfig,
    batch_size: int,
    trainable_count: Optional[int] = None,
    corpus_bytes: int = 0,
    hbm_bytes: Optional[int] = None,
    label_len: int = 128,
    device=None,
) -> bool:
    """Map a --remat flag value ('auto'/bool/str) to a concrete setting.

    'auto' picks remat=False (fastest, measured) exactly when
    `train_memory_plan` says the no-remat step fits the HBM budget.
    """
    if isinstance(spec, bool):
        return spec
    s = str(spec).lower()
    if s != "auto":
        from neuspeech1_tpu_torch.utils.args import strtobool

        return strtobool(s)
    plan = train_memory_plan(
        config, stem, batch_size, trainable_count=trainable_count,
        corpus_bytes=corpus_bytes, hbm_bytes=hbm_bytes, label_len=label_len,
        device=device,
    )
    return not plan["fits_no_remat"]
