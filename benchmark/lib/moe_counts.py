"""Operations and bytes of the language-model configurations (``configs/
kimi-vl-a3b-lm-meg208.json``), counted from the shapes: the yardstick of
``moe_gemm_roofline`` and ``llm_train_mfu``. Peaks as ``lib/counts.py``'s.
Imports nothing of the program.
"""

from __future__ import annotations

from benchmark.lib import counts

BF16 = counts.BF16


def routed_layers(c: dict) -> int:
    return sum(1 for i in range(c["num_hidden_layers"])
               if i >= c["first_k_dense_replace"]
               and i % c["moe_layer_freq"] == 0)


def sequence(c: dict, label_len: int) -> int:
    """Positions a sample runs through the language model: the prefix's
    and the text's."""
    t = c["tower"]["model"]["max_source_positions"]
    return t // c["projector"]["merge_frames"] + label_len


def routed_gemms(c: dict, rows: int) -> list:
    """(FLOPs, bytes) of each routed-expert product of one layer over
    ``rows`` routed rows, forward and input gradient: gate-up (hidden -> 2
    x width), down (width -> hidden), then down's and gate-up's input
    gradients. Each reads its rows and every expert's weights once and
    writes its output once, in bf16."""
    d, w, e = c["hidden_size"], c["moe_intermediate_size"], \
        c["n_routed_experts"]
    out = []
    for k, n in ((d, 2 * w), (w, d), (d, w), (2 * w, d)):
        out.append((2.0 * rows * k * n,
                    BF16 * (rows * k + e * k * n + rows * n)))
    return out


def routed_least_seconds(c: dict, batch: int, label_len: int) -> float:
    """Least seconds of one step's routed-expert products, forward and
    input gradient, in every routed layer: each product's larger of FLOPs
    over the bf16 peak and bytes over the HBM bandwidth. Rows: batch x
    positions x experts per token. Remat's recompute is not counted."""
    rows = batch * sequence(c, label_len) * c["num_experts_per_tok"]
    layer = sum(counts.least_seconds(f, b) for f, b in routed_gemms(c, rows))
    return routed_layers(c) * layer


def lm_fwd_flops_per_sample(c: dict, label_len: int) -> float:
    """Forward FLOPs of the language model for one sample (2 per MAC):
    per position MLA's projections (q, kv_a, kv_b, o), the causal
    attention's two products over the positions so far, the dense SwiGLU
    or the router, the experts per token's SwiGLUs and the shared one; the
    head at the text positions."""
    d, heads = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    vd, lora = c["v_head_dim"], c["kv_lora_rank"]
    t = sequence(c, label_len)
    pairs = t * (t + 1) // 2
    proj = 2 * d * (heads * qk + lora + c["qk_rope_head_dim"]) \
        + 2 * lora * heads * (c["qk_nope_head_dim"] + vd) \
        + 2 * heads * vd * d
    attn = 2 * pairs * heads * (qk + vd)
    dense = 3 * 2 * d * c["intermediate_size"]
    w = c["moe_intermediate_size"]
    routed = (2 * d * c["n_routed_experts"]
              + c["num_experts_per_tok"] * 3 * 2 * d * w
              + 3 * 2 * d * w * c["n_shared_experts"])
    n_routed = routed_layers(c)
    n_dense = c["num_hidden_layers"] - n_routed
    per_layer_pos = t * proj
    return float(c["num_hidden_layers"] * (per_layer_pos + attn)
                 + t * (n_dense * dense + n_routed * routed)
                 + label_len * 2 * d * c["vocab_size"])


def tower_fwd_flops_per_sample(c: dict) -> float:
    """Forward FLOPs of the tower (the stem and the Whisper encoder, as
    ``lib/counts.py`` counts them, without the decoder's) and the
    projector for one sample."""
    tw = c["tower"]
    m = tw["model"]
    t, d = m["max_source_positions"], m["d_model"]
    enc = counts.fwd_flops_per_sample(tw, 0) - m["decoder_layers"] * (
        2 * t * d * d * 2)
    rows = t // c["projector"]["merge_frames"]
    k = d * c["projector"]["merge_frames"]
    h = c["hidden_size"]
    return float(enc + 2 * rows * (k * h + h * h))


def train_flops_per_sample(c: dict, label_len: int) -> float:
    """A training step's model FLOPs per sample: the frozen language
    model's forward and input gradient (2 x forward), the tower's and the
    projector's forward and both gradients (3 x forward); recompute not
    counted."""
    return (2 * lm_fwd_flops_per_sample(c, label_len)
            + 3 * tower_fwd_flops_per_sample(c))
