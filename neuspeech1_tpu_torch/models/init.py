"""Seeded random parameters with the JAX package's tree, shapes and
distributions (``neuspeech1_tpu/models/init.py``): linear, conv and
embedding weights ~ N(0, 0.02), zero biases, layer norms at identity,
sinusoidal encoder positions, learned decoder positions ~ N(0, 0.02).

The numbers come from a ``torch.Generator`` and differ from ``jax.random``'s
for the same seed; tests that compare the two packages hand both the same
tree instead.
"""

from __future__ import annotations

import math

import torch

from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig

INIT_STD = 0.02


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """OpenAI Whisper's fixed sinusoidal table [length, channels]."""
    if channels % 2:
        raise ValueError(f"channels={channels} must be even")
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([t.sin(), t.cos()], dim=1).float()


def init_stem(config: WhisperConfig, stem: StemConfig, seed: int = 0,
              generator=None):
    """The projection stem's tree alone: convs ~ N(0, 0.02), zero biases,
    drawn from ``generator`` (or a new CPU one seeded with ``seed``), on its
    device. The stem swap of a stock speech checkpoint (`cli/common.py::
    load_base_params`) takes it; `init_params` draws its stem through it
    first."""
    gen = generator or torch.Generator().manual_seed(seed)
    d = config.d_model

    def conv(c_out, c_in, k):
        return {"w": torch.randn((c_out, c_in, k), generator=gen,
                                 device=gen.device) * INIT_STD,
                "b": torch.zeros(c_out, device=gen.device)}

    if stem.kind == "speech":
        return {"conv1": conv(d, config.num_mel_bins, 3)}
    if stem.kind == "base":
        return {"conv_a": conv(d, stem.in_channels, 3),
                "conv_b": conv(d, d, 3)}
    if stem.kind == "replace":
        return {"conv": conv(d, stem.in_channels, 3)}
    if stem.kind == "premel":
        return {"pre_conv": conv(config.num_mel_bins, stem.in_channels, 5),
                "conv1": conv(d, config.num_mel_bins, 3)}
    raise ValueError(stem.kind)


def init_params(config: WhisperConfig, stem: StemConfig, seed: int = 0,
                device="cpu"):
    """The full tree of float32 tensors on ``device``, layers stacked on
    dim 0, drawn from a generator on that device (so the numbers depend on
    the device; a large model's tree is drawn in a fraction of the CPU's
    time on the card)."""
    gen = torch.Generator(device).manual_seed(seed)
    d = config.d_model
    stem_p = init_stem(config, stem, generator=gen)

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device) * INIT_STD

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def linear(d_in, d_out, n, bias=True):
        p = {"w": nrm(n, d_in, d_out)}
        if bias:
            p["b"] = zeros(n, d_out)
        return p

    def ln(n):
        return {"scale": torch.ones(n, d, device=device),
                "bias": zeros(n, d)}

    def conv(c_out, c_in, k):
        return {"w": nrm(c_out, c_in, k), "b": zeros(c_out)}

    def attn(n):
        return {"q": linear(d, d, n), "k": linear(d, d, n, bias=False),
                "v": linear(d, d, n), "out": linear(d, d, n)}

    ne, nd = config.encoder_layers, config.decoder_layers
    encoder = {
        "stem": stem_p,
        "conv2": conv(d, d, 3),
        "pos_embed": sinusoids(config.max_source_positions, d).to(device),
        "layers": {
            "self_attn": attn(ne),
            "self_attn_ln": ln(ne),
            "fc1": linear(d, config.encoder_ffn, ne),
            "fc2": linear(config.encoder_ffn, d, ne),
            "final_ln": ln(ne),
        },
        "ln_post": {"scale": torch.ones(d, device=device), "bias": zeros(d)},
    }
    decoder = {
        "token_embed": nrm(config.vocab_size, d),
        "pos_embed": nrm(config.max_target_positions, d),
        "layers": {
            "self_attn": attn(nd),
            "self_attn_ln": ln(nd),
            "cross_attn": attn(nd),
            "cross_attn_ln": ln(nd),
            "fc1": linear(d, config.decoder_ffn, nd),
            "fc2": linear(config.decoder_ffn, d, nd),
            "final_ln": ln(nd),
        },
        "ln": {"scale": torch.ones(d, device=device), "bias": zeros(d)},
    }
    return {"encoder": encoder, "decoder": decoder}
