"""Operations and bytes counted from the shapes: the yardstick of the mfu
and roofline metrics.

`fwd_flops_per_sample` is a frozen copy of
``neuspeech1_tpu_torch/bench.py::fwd_flops_per_sample`` (the JAX package's
root bench.py's count), taking the configuration file's ``model`` and
``stem`` instead of the program's config objects. Peaks: one NVIDIA H100
SXM, NVIDIA's data sheet, dense bf16 and HBM3.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2
F32 = 4


def fwd_flops_per_sample(config: dict, label_len: int) -> float:
    """Analytic forward FLOPs per sample (matmuls and convs, 2 per MAC):
    the 'base' stem, the encoder layers (q/k/v/out, QK^T and PV, MLP), the
    decoder layers (self-attention, cross K/V over the encoder frames,
    cross q/out and attention, MLP) and the tied logits; LoRA deltas
    (about 1%) ignored."""
    m = config["model"]
    t = m["max_source_positions"]
    t_in = t * 4
    d, f_enc, f_dec = m["d_model"], m["encoder_ffn"], m["decoder_ffn"]
    n = label_len
    in_channels = config["stem"]["in_channels"]
    stem = (t_in * in_channels * d * 3 * 2 + (t_in // 2) * d * d * 3 * 2
            + t * d * d * 3 * 2)
    enc_layer = 4 * t * d * d * 2 + 2 * t * t * d * 2 + 2 * t * d * f_enc * 2
    dec_layer = (4 * n * d * d * 2 + 2 * n * n * d * 2 + 2 * t * d * d * 2
                 + 2 * n * d * d * 2 + 2 * n * t * d * 2
                 + 2 * n * d * f_dec * 2)
    logits = n * d * m["vocab_size"] * 2
    return float(stem + m["encoder_layers"] * enc_layer
                 + m["decoder_layers"] * dec_layer + logits)


def attention_bwd(batch: int, heads: int, t_q: int, t_k: int,
                  head_dim: int) -> tuple:
    """(FLOPs, bytes) that one flash attention backward needs: the scores
    recomputed, dV, dP, dQ and dK (5 products of 2 B H Tq Tk D), reading
    q, k, v, o, dO (bf16) and lse (f32) once and writing dq, dk, dv once."""
    flops = 10.0 * batch * heads * t_q * t_k * head_dim
    hd = heads * head_dim
    nbytes = (batch * BF16 * hd * (4 * t_q + 4 * t_k)
              + batch * heads * t_q * F32)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def train_step_attention_bwd(config: dict, batch: int, label_len: int
                             ) -> float:
    """Least seconds of one training step's flash attention backward:
    every encoder layer's self-attention and every decoder layer's
    cross-attention (the decoder's self-attention at these lengths runs
    outside the kernels)."""
    m = config["model"]
    t = m["max_source_positions"]
    enc = least_seconds(*attention_bwd(batch, m["encoder_heads"], t, t,
                                       m["d_model"] // m["encoder_heads"]))
    cross = least_seconds(*attention_bwd(batch, m["decoder_heads"],
                                         label_len, t,
                                         m["d_model"] // m["decoder_heads"]))
    return m["encoder_layers"] * enc + m["decoder_layers"] * cross


def decode_cross_bytes(config: dict, batch: int, q_rows: int) -> float:
    """Bytes one cross-attention call of the cached decoder needs: the bf16
    cross cache K and V [batch, H, T, Dh] read once, the queries read and
    the output written once ([batch, q_rows, H, Dh])."""
    m = config["model"]
    hd = m["d_model"]
    t = m["max_source_positions"]
    return batch * BF16 * hd * (2 * t + 2 * q_rows)


def decode_request_flops(config: dict, clips: int, beams: int,
                         prompt_len: int, new_tokens: int) -> float:
    """Model FLOPs of one beam request: the stem and encoder over every
    clip, the cross K/V projections once per clip, and per beam row and
    decoder position the decoder's products (self q/k/v/out, cross q/out,
    MLP), its self-attention over the positions so far, its
    cross-attention over the encoder frames, and the logits. Positions:
    the prompt's, then one per new token but the last, whose logits no
    step reads."""
    m = config["model"]
    d, t, f = m["d_model"], m["max_source_positions"], m["decoder_ffn"]
    enc = fwd_flops_per_sample(config, 0) - m["decoder_layers"] * (
        2 * t * d * d * 2)                      # stem + encoder, no cross K/V
    cross_kv = m["decoder_layers"] * 2 * t * d * d * 2
    positions = prompt_len + new_tokens - 1
    per_pos = 0.0
    for pos in range(positions):
        ctx = pos + 1
        per_pos += m["decoder_layers"] * (
            6 * d * d * 2                        # self q/k/v/out, cross q/out
            + 2 * d * f * 2                      # MLP
            + 2 * ctx * d * 2                    # self-attention
            + 2 * t * d * 2)                     # cross-attention
        per_pos += d * m["vocab_size"] * 2       # logits
    return clips * (enc + cross_kv + beams * per_pos)
