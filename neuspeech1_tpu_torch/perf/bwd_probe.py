"""Flash backward probe on the card: the counterpart of
``perf/bwd_probe.py``: the backward from a given lse with bf16 or f32 dot
operands (f32 accumulation either way), through ``ops/probe_bwd.py``.

    python -m neuspeech1_tpu_torch.perf.bwd_probe

prints the TPU probe's ``{"k": tag, "ms": ...}`` lines (CUDA-event times).
lse is [B*H, TK] (the TPU layout's 8 replicated rows per head are not
kept). Nothing runs at import.
"""

from __future__ import annotations

import numpy as np
import torch

from neuspeech1_tpu_torch.ops.probe_bwd import probe_bwd
from neuspeech1_tpu_torch.perf.common import bwd_rows, normal, timeit

B, H, T, D = 64, 8, 1500, 64
TK = 1536


def make_bwd(block_q: int, *, bf16_ops: bool, t_valid: int):
    """run(q, k, v, o, do [B*H, TK, 64], lse [B*H, TK]) -> (dq, dk, dv)."""
    rows = bwd_rows(block_q)
    ops = "bf16" if bf16_ops else "f32"

    def run(q, k, v, o, do, lse):
        return probe_bwd(q, k, v, o, do, lse, t_valid, ops=ops, rows=rows)
    return run


def main() -> None:
    rng = np.random.default_rng(0)
    q0, k0, v0, o0, do0 = (normal(rng, (B * H, TK, D)) for _ in range(5))
    lse0 = normal(rng, (B * H, TK), dtype=torch.float32, loc=8.0, scale=0.1)
    for bq in (256, 512):
        for bf16_ops in (False, True):
            f = make_bwd(bq, bf16_ops=bf16_ops, t_valid=T)
            timeit(f"bwd_bq{bq}_{'bf16' if bf16_ops else 'f32'}ops",
                   lambda f=f: f(q0, k0, v0, o0, do0, lse0))


if __name__ == "__main__":
    main()
