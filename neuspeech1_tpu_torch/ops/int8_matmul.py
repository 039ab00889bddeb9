"""AQT-style int8 quantized matmuls for training (opt-in): the port of
``neuspeech1_tpu/ops/int8_matmul.py``. XLA computes them in the JAX
package, so they are plain PyTorch here: the integer products run on
``torch._int_mm`` (int32 accumulation), the quantization and the scales in
tensor code.

Dynamic symmetric per-vector int8 quantization along the contraction axis
of a dot, the standard AQT int8-training recipe:

    y = (q(x) @ q(w)) * sx * sw        q(v) = round(v / (absmax(v) / 127))

with absmax taken per contraction vector, the integer product accumulated
in int32 and the scales applied as a rank-1 outer product on the way out.
Gradients use the straight-through estimator: the backward differentiates
the EXACT dot (d/dx [x W^T] = dy W), optionally itself computed with
quantized operands ('full' mode), quantizing dy along its contraction axis
the same way.

Modes (`int8_mode`, the training step's ``int8_matmul``):
  'off'  — exact dots (default).
  'fwd'  — forward dots quantized; backward dx/dw exact.
  'full' — forward AND backward dots quantized (dx = q(dy) @ q(W),
           dW = q(dy^T) @ q(x), both over their contraction axes).

Weights are ``nn.Linear``'s [out, in], where the JAX package's ``w`` is
[in, out]: the quantization axis of a weight is its contraction axis,
``in`` in the forward and ``out`` in 'full''s dx. ``torch._int_mm`` takes
its fast path on the card when the left operand is row-major and the right
one column-major (the transpose of a row-major [n, k]); every call here
hands it that layout, made once by the quantization that writes the
operand.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

MODES = ("off", "fwd", "full")

# Set by `int8_mode` (the training step's ``int8_matmul``) and read where a
# dot runs: `models/whisper.py::linear` and `models/lora.py::folded_linear`.
# A context variable, as the fold flag (the ranks of a LocalRing are
# threads).
_MODE = contextvars.ContextVar("int8_matmul", default="off")


def mode() -> str:
    return _MODE.get()


@contextlib.contextmanager
def int8_mode(m: str):
    """Route `models.whisper.linear` and the folded-LoRA dots through
    quantized matmuls ('fwd' or 'full') while the context is open."""
    if m not in MODES:
        raise ValueError(f"int8 matmul mode {m!r}: one of {MODES}")
    token = _MODE.set(m)
    try:
        yield
    finally:
        _MODE.reset(token)


def _quant(v: torch.Tensor, dim: int):
    """Symmetric per-vector int8 quantization along ``dim``: (q int8, scale
    f32 with ``dim`` kept at size 1). ``s = absmax * (1/127)``, 1 for a zero
    vector (q = 0, exact), then ``round(v / s)`` half to even."""
    v = v.float()
    a = v.abs().amax(dim, keepdim=True)
    s = torch.where(a > 0, a * (1.0 / 127.0), torch.ones_like(a))
    return torch.round(v / s).to(torch.int8), s


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b_t^T`` for int8 row-major a [m, k] and b_t [n, k].
    The card's ``_int_mm`` wants m > 16 and k, n multiples of 8: other
    shapes are zero-padded up to them (zeros add nothing to the sums)."""
    m, k = a.shape
    n = b_t.shape[0]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pn or pk:
        b_t = F.pad(b_t, (0, pk, 0, pn))
    y = torch._int_mm(a, b_t.t())
    return y[:m, :n] if pm or pn else y


def qdot(a: torch.Tensor, b_t: torch.Tensor, out_dtype) -> torch.Tensor:
    """Quantized a [m, k] @ b_t [n, k]^T -> [m, n] in ``out_dtype``: both
    operands quantized along k, ``y * sa * sb`` in f32 (the JAX package's
    ``_qdot2(a, b_t.T)``)."""
    aq, sa = _quant(a, 1)
    bq, sb = _quant(b_t, 1)
    return (_int_mm(aq, bq).float() * sa * sb.view(1, -1)).to(out_dtype)


def qdot_tokens(x2: torch.Tensor, dy2: torch.Tensor, out_dtype
                ) -> torch.Tensor:
    """'full''s weight gradient dW = dy2^T x2 [out, in] with both operands
    quantized along the N tokens they contract over (the JAX package's
    ``_qdot2(x2.T, dy2).T``, with its scales applied in its order). The
    int32 sums stay exact up to N = 133,144 tokens (N * 127^2 < 2^31), as
    in the JAX package; whisper-base at batch 64 has 96,000."""
    xq, sx = _quant(x2, 0)    # [N, in], sx [1, in]
    dq, sd = _quant(dy2, 0)   # [N, out], sd [1, out]
    y = _int_mm(dq.t().contiguous(), xq.t().contiguous())  # [out, in]
    return (y.float() * sx * sd.view(-1, 1)).to(out_dtype)


class QuantizedDot(torch.autograd.Function):
    """``x W^T`` with int8 compute and straight-through gradients; the mode
    rides as an argument, read when the forward runs."""

    @staticmethod
    def forward(ctx, x, w, m: str):
        ctx.save_for_backward(x, w)
        ctx.mode = m
        x2 = x.reshape(-1, x.shape[-1])
        return qdot(x2, w, x.dtype).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        full = ctx.mode == "full"
        dx = dw = None
        # a frozen weight (the decoder's, a base weight beside a LoRA
        # delta) takes no product
        if ctx.needs_input_grad[0]:
            dx = (qdot(dy2, w.t().contiguous(), x.dtype) if full
                  else (dy2 @ w.to(dy2.dtype)).to(x.dtype)).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (qdot_tokens(x2, dy2, torch.float32) if full
                  else dy2.t() @ x2).to(w.dtype)
        return dx, dw, None


def quantized_dot(x: torch.Tensor, w: torch.Tensor, m: str | None = None
                  ) -> torch.Tensor:
    """Drop-in for ``x @ w.T`` on [..., in] x [out, in] with int8 compute
    and straight-through gradients; ``m`` defaults to the active mode."""
    return QuantizedDot.apply(x, w, mode() if m is None else m)
