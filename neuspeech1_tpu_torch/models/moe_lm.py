"""A DeepSeek-V3-style decoder-only language model (Kimi-VL-A3B's language
model at ``config.MoELMConfig``'s defaults): MLA attention, a dense SwiGLU
in the first ``first_k_dense_replace`` layers and routed experts beside
shared ones in the rest, RMSNorm, interleaved RoPE and an untied head.

Parameters follow the published checkpoint's names (``layers.1.self_attn.
kv_a_proj_with_mqa.weight``, ``layers.1.mlp.gate.weight``, ...) except the
routed experts, held fused per layer: ``mlp.experts.gate_up`` [E, hidden,
2 x moe_intermediate] (each expert's gate and up projections side by side,
as ``x @ W``) and ``mlp.experts.down`` [E, moe_intermediate, hidden]. The
router's ``e_score_correction_bias`` is a buffer. The model is frozen and
held in ``config.dtype``: it passes gradients to its input embeddings and
takes none itself (`GroupedExperts` returns none for the expert weights).

The equations (the published modeling code's):

- MLA, with q uncompressed: q = x W_q [H, nope + rope]; kv_a = x W_kva
  [kv_lora_rank + rope]; c_kv = RMSNorm(kv_a[:kv_lora_rank]); k_pe =
  RoPE(kv_a[kv_lora_rank:]), one key shared by the heads; [k_nope, v] = c_kv
  W_kvb; q's last ``qk_rope_head_dim`` dims roped; causal softmax at scale
  (nope + rope)^-0.5 through ``F.scaled_dot_product_attention``; out W_o.
- RoPE pairs adjacent dims: each rope slice is de-interleaved (dims 0, 2,
  4, ... then 1, 3, 5, ...) and rotated by halves, cos and sin of
  positions x theta^(-2i/d) in the compute dtype.
- The router: logits and sigmoid scores in f32; the top-k of scores +
  ``e_score_correction_bias`` chosen; weights the unbiased scores of the
  chosen, over their sum (``norm_topk_prob``), times
  ``routed_scaling_factor``. Dropless: every chosen (token, expert) pair
  runs.
- The routed experts: the pairs sorted by expert (`route`), each expert's
  rows through its SwiGLU on the grouped GEMM (``ops/moe_gemm.py``), the
  outputs weighted in f32 and summed back per token, plus the shared
  experts as one SwiGLU of n_shared x moe_intermediate.

Spans (``train/profiling.py``): ``mla/attention``, ``moe/route``,
``moe/permute``, ``moe/experts``, ``moe/combine``; counters ``moe.rows``
(routed rows), ``moe.max_expert_rows`` and ``moe.empty_experts`` (summed
over the routed layers' calls, remat's recompute included), counted while
tracing without a sync. `recording_routes` collects each routed layer's
expert choices (for a check that follows them, as a decode's check reads
its served tokens).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuspeech1_tpu_torch.config import MoELMConfig
from neuspeech1_tpu_torch.ops.moe_gemm import grouped_gemm
from neuspeech1_tpu_torch.train import profiling
from neuspeech1_tpu_torch.train.profiling import span


# The list each routed layer's call appends its expert choices to, while
# `recording_routes` is open on this thread.
_ROUTES = contextvars.ContextVar("moe_routes", default=None)


@contextlib.contextmanager
def recording_routes():
    """Yields a list to which each routed layer's call on this thread
    appends its expert choices (int64 [tokens, k]): a forward's routed
    layers in order, then any recompute of them on this thread."""
    routes: list = []
    token = _ROUTES.set(routes)
    try:
        yield routes
    finally:
        _ROUTES.reset(token)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        """In f32, the result cast back before the weight, as published."""
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


class MLA(nn.Module):
    def __init__(self, c: MoELMConfig):
        super().__init__()
        h, d = c.num_attention_heads, c.hidden_size
        self.n_heads = h
        self.q_proj = nn.Linear(d, h * c.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(
            d, c.kv_lora_rank + c.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(h * c.v_head_dim, d, bias=False)
        self.dims = (c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                     c.kv_lora_rank)

    def forward(self, x, rope):
        with span("mla/attention"):
            nope, rot, vd, lora = self.dims
            b, t, _ = x.shape
            h = self.n_heads
            q = F.linear(x, self.q_proj.weight).view(b, t, h, nope + rot)
            kv_a = F.linear(x, self.kv_a_proj_with_mqa.weight)
            c_kv, k_pe = kv_a.split([lora, rot], dim=-1)
            kv = F.linear(self.kv_a_layernorm(c_kv), self.kv_b_proj.weight)
            k_nope, v = kv.view(b, t, h, nope + vd).split([nope, vd], dim=-1)
            q_nope, q_pe = q.split([nope, rot], dim=-1)
            q = torch.cat([q_nope, apply_rope(q_pe, *rope)], dim=-1)
            k_pe = apply_rope(k_pe[:, :, None], *rope).expand(b, t, h, rot)
            k = torch.cat([k_nope, k_pe], dim=-1)
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=(nope + rot) ** -0.5)
            o = o.transpose(1, 2).reshape(b, t, h * vd)
            return F.linear(o, self.o_proj.weight)


class SwiGLU(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x):
        return F.linear(F.silu(F.linear(x, self.gate_proj.weight))
                        * F.linear(x, self.up_proj.weight),
                        self.down_proj.weight)


class Router(nn.Module):
    def __init__(self, c: MoELMConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts,
                                               c.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(c.n_routed_experts))


class Experts(nn.Module):
    def __init__(self, c: MoELMConfig):
        super().__init__()
        e, d, w = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate_up = nn.Parameter(torch.empty(e, d, 2 * w))
        self.down = nn.Parameter(torch.empty(e, w, d))


class MoE(nn.Module):
    def __init__(self, c: MoELMConfig):
        super().__init__()
        self.top_k = c.num_experts_per_tok
        self.scale = c.routed_scaling_factor
        self.norm_topk = c.norm_topk_prob
        self.gate = Router(c)
        self.experts = Experts(c)
        self.shared_experts = SwiGLU(
            c.hidden_size, c.moe_intermediate_size * c.n_shared_experts)

    def forward(self, x):
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        with span("moe/route"):
            idx, weight = select(xf, self.gate.weight,
                                 self.gate.e_score_correction_bias,
                                 self.top_k, self.norm_topk, self.scale)
            routes = _ROUTES.get()
            if routes is not None:
                routes.append(idx.detach())
        with span("moe/permute"):
            r = route(idx, self.experts.gate_up.shape[0])
            x_perm = Dispatch.apply(xf, r.token, r.inverse)
        with span("moe/experts"):
            out = GroupedExperts.apply(x_perm, r.offs, self.experts.gate_up,
                                       self.experts.down)
        with span("moe/combine"):
            y = Combine.apply(out, weight, r.inverse, r.order)
            y = y + self.shared_experts(xf)
        return y.view(b, t, d)


class DecoderLayer(nn.Module):
    def __init__(self, c: MoELMConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.mlp = (MoE(c) if c.is_moe_layer(i)
                    else SwiGLU(c.hidden_size, c.intermediate_size))

    def forward(self, h, cos, sin):
        h = h + self.self_attn(self.input_layernorm(h), (cos, sin))
        return h + self.mlp(self.post_attention_layernorm(h))


class MoELM(nn.Module):
    def __init__(self, c: MoELMConfig):
        super().__init__()
        self.config = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(c, i)
                                    for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, bias=False)


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

def rope_tables(c: MoELMConfig, t: int, device, dtype):
    """(cos, sin) [t, qk_rope_head_dim] of positions 0..t-1, in ``dtype``
    (computed in f32)."""
    d = c.qk_rope_head_dim
    inv = 1.0 / (c.rope_theta ** (torch.arange(0, d, 2, device=device,
                                               dtype=torch.float32) / d))
    freqs = torch.outer(torch.arange(t, device=device, dtype=torch.float32),
                        inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x, cos, sin):
    """x [b, t, heads, d] with adjacent dims paired: de-interleaved, then
    rotated by halves (the published ``apply_rotary_pos_emb``)."""
    b, t, h, d = x.shape
    x = x.view(b, t, h, d // 2, 2).transpose(-1, -2).reshape(b, t, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[:, None] + half * sin[:, None]


def select(x, gate_w, bias, top_k: int, norm_topk: bool, scale: float):
    """(expert ids [T, k], weights f32 [T, k]) of tokens ``x`` [T, d]: f32
    sigmoid scores, the top-k of score + ``bias`` chosen, weighted by the
    unbiased scores (over their sum where ``norm_topk``) times ``scale``.
    The weights pass gradients to ``x``."""
    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    idx = torch.topk(scores.detach() + bias.float(), top_k, dim=-1,
                     sorted=False).indices
    weight = scores.gather(1, idx)
    if norm_topk and top_k > 1:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return idx, weight * scale


class Route(NamedTuple):
    """The routed rows sorted by expert: ``token`` [R] (each row's token),
    ``offs`` int32 [E + 1] (expert e's rows at offs[e]..offs[e+1]),
    ``inverse`` [T, k] (the sorted row of each (token, choice)) and
    ``order`` [R] (the (token, choice) pair, flat, of each sorted row)."""

    token: torch.Tensor
    offs: torch.Tensor
    inverse: torch.Tensor
    order: torch.Tensor


def route(idx, n_experts: int) -> Route:
    """The dropless permutation of ``idx`` [T, k]: a stable sort of the
    (token, choice) pairs by expert, the offsets found in the sorted ids
    (no host sync)."""
    t, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, device=idx.device, dtype=flat.dtype)
    offs = torch.searchsorted(flat[order], bounds).to(torch.int32)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    profiling.count("moe.rows", flat.numel())
    if profiling.tracing():
        counts = offs[1:] - offs[:-1]
        profiling.count_device("moe.max_expert_rows", counts.max())
        profiling.count_device("moe.empty_experts", (counts == 0).sum())
    return Route(order // k, offs, inverse.view(t, k), order)


class Dispatch(torch.autograd.Function):
    """The tokens' rows ``x`` [T, d] in sorted order, ``x[token]`` [R, d];
    the backward sums each token's k rows back (a gather and a sum over k,
    in place of a scatter-add)."""

    @staticmethod
    def forward(ctx, x, token, inverse):
        ctx.save_for_backward(inverse)
        return x[token]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return grad[inverse].sum(1), None, None


class Combine(torch.autograd.Function):
    """Each token's expert outputs ``out`` [R, d] (sorted rows) weighted by
    ``weight`` f32 [T, k] and summed, in f32, rounded to ``out``'s dtype.
    The backward gives ``out`` the weighted gradient in the compute dtype,
    back in sorted order by ``order`` (a gather, in place of a
    scatter-add), and ``weight`` each output's dot with the gradient."""

    @staticmethod
    def forward(ctx, out, weight, inverse, order):
        ctx.save_for_backward(out, weight, inverse, order)
        y = torch.bmm(weight.unsqueeze(1), out[inverse].float())
        return y.squeeze(1).to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        out, weight, inverse, order = ctx.saved_tensors
        e = out[inverse]
        dweight = torch.bmm(e, dy.unsqueeze(-1)).squeeze(-1).float()
        de = dy.unsqueeze(1) * weight.unsqueeze(-1).to(dy.dtype)
        return de.reshape(-1, dy.shape[-1])[order], dweight, None, None


def swiglu_grad(gu, dact):
    """d(silu(g) * u) / d[g, u] for ``gu`` = [g, u] and the output's
    gradient ``dact``, in ``gu``'s dtype as autograd takes it: du = dact *
    silu(g), dg = silu's backward of dact * u."""
    g, u = gu.chunk(2, dim=-1)
    return torch.cat([torch.ops.aten.silu_backward(dact * u, g),
                      dact * F.silu(g)], dim=-1)


class GroupedExperts(torch.autograd.Function):
    """The routed experts' SwiGLU over rows sorted by expert: silu(x Wg) *
    (x Wu) then W_down, every product on the grouped GEMM. Saves the
    gate-up product; the backward runs the two input-gradient products and
    returns no gradient for the (frozen) weights."""

    @staticmethod
    def forward(ctx, x, offs, gate_up, down):
        gu = grouped_gemm(x, gate_up, offs)
        g, u = gu.chunk(2, dim=-1)
        y = grouped_gemm(F.silu(g) * u, down, offs)
        ctx.save_for_backward(gu, offs, gate_up, down)
        return y

    @staticmethod
    def backward(ctx, dy):
        gu, offs, gate_up, down = ctx.saved_tensors
        dact = grouped_gemm(dy.contiguous(), down, offs, trans_w=True)
        dx = grouped_gemm(swiglu_grad(gu, dact), gate_up, offs, trans_w=True)
        return dx, None, None, None


def lm_apply(lm: MoELM, h, head_from: int, remat: bool = False):
    """Logits [b, t - head_from, vocab] of input embeddings ``h`` [b, t,
    hidden] (causal over all t), the head at positions head_from.. only.
    ``remat``: each layer under a non-reentrant checkpoint."""
    cos, sin = rope_tables(lm.config, h.shape[1], h.device, h.dtype)
    for layer in lm.layers:
        if remat:
            h = checkpoint(layer, h, cos, sin, use_reentrant=False)
        else:
            h = layer(h, cos, sin)
    return F.linear(lm.norm(h[:, head_from:]), lm.lm_head.weight)
