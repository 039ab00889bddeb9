"""[B, T, H*D]-layout flash probe on the card: the counterpart of
``perf/btc_probe.py``: the full-row forward reading heads in place and
returning o and lse (``make_fwd_btc``, ``make_fwd_btc_sem``, through
``ops/probe_fwd.py``) and the f32-operand backward from a given lse
(``make_bwd_btc``, through ``ops/probe_bwd.py``).

    python -m neuspeech1_tpu_torch.perf.btc_probe [sem]

prints the forward's error against its plain version at B = 2, then the
TPU probe's ``{"k": tag, "ms": ...}`` lines (CUDA-event times); ``sem``
adds the grid-order variants. lse is [B, H, TK] (the TPU layout's 8
replicated rows per head are not kept). Nothing runs at import.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from neuspeech1_tpu_torch.ops.probe_bwd import probe_bwd
from neuspeech1_tpu_torch.ops.probe_fwd import probe_fwd, probe_fwd_plain
from neuspeech1_tpu_torch.perf.common import (bwd_rows, fwd_rows, normal,
                                              sem_order, timeit)

B, H, T, D = 64, 8, 1500, 64
TK = 1536
C = H * D
SEMS = (("parallel", "parallel", "arbitrary"),
        ("parallel", "arbitrary", "arbitrary"),
        ("arbitrary", "arbitrary", "arbitrary"))


def make_fwd_btc(block_q: int, *, t_valid: int):
    """run(q, k, v [B, TK, H*64]) -> (o [B, TK, H*64], lse [B, H, TK])."""
    rows = fwd_rows(block_q)

    def run(q, k, v):
        return probe_fwd(q, k, v, t_valid, rows=rows, btc=True,
                         want_lse=True)
    return run


def make_bwd_btc(block_q: int, *, t_valid: int):
    """run(q, k, v, o, do [B, TK, H*64], lse [B, H, TK]) -> (dq, dk, dv),
    f32 operands."""
    rows = bwd_rows(block_q)

    def run(q, k, v, o, do, lse):
        return probe_bwd(q, k, v, o, do, lse, t_valid, ops="f32", rows=rows,
                         btc=True)
    return run


def make_fwd_btc_sem(block_q: int, sem, *, t_valid: int):
    """`make_fwd_btc` under the grid raster ``sem`` maps to."""
    rows, order = fwd_rows(block_q), sem_order(sem)

    def run(q, k, v):
        return probe_fwd(q, k, v, t_valid, rows=rows, order=order, btc=True,
                         want_lse=True)
    return run


def main(argv) -> None:
    rng = np.random.default_rng(0)
    q0, k0, v0 = (normal(rng, (B, TK, C)) for _ in range(3))
    o, _ = make_fwd_btc(512, t_valid=T)(q0[:2], k0[:2], v0[:2])
    ref, _ = probe_fwd_plain(q0[:2], k0[:2], v0[:2], T, btc=True)
    err = (o.float() - ref.float())[:, :T].abs().max().item()
    print(json.dumps({"k": "fwd_btc_maxerr", "v": err}), flush=True)
    for bq in (512, 256):
        f = make_fwd_btc(bq, t_valid=T)
        timeit(f"fwd_btc_bq{bq}", lambda f=f: f(q0, k0, v0))
    o0, do0 = normal(rng, (B, TK, C)), normal(rng, (B, TK, C))
    lse0 = normal(rng, (B, H, TK), dtype=torch.float32, loc=8.0, scale=0.1)
    for bq in (512, 256, 192):
        f = make_bwd_btc(bq, t_valid=T)
        timeit(f"bwd_btc_bq{bq}", lambda f=f: f(q0, k0, v0, o0, do0, lse0))
    if "sem" in argv:
        for sem in SEMS:
            f = make_fwd_btc_sem(512, sem, t_valid=T)
            timeit(f"fwd_sem_{'_'.join(s[:3] for s in sem)}",
                   lambda f=f: f(q0, k0, v0))


if __name__ == "__main__":
    main(sys.argv)
