"""Matrix-rate probe on the card: the counterpart of ``perf/mxu_probe.py``:
the batched dot at contraction 64..512 (``make_dot``, through
``ops/probe_dot.py``) and the full-row forward with its q block split into
sub-tiles whose QK products all issue before any softmax (``make_fwd``,
through ``ops/probe_fwd.py``).

    python -m neuspeech1_tpu_torch.perf.mxu_probe

prints the TPU probe's ``{"k": tag, "ms": ...}`` lines (CUDA-event times).
At this shape the dot's bf16 output (256 x 512 x 1536 x 2 B) makes every
K bytes-bound on an H100. Nothing runs at import.
"""

from __future__ import annotations

import numpy as np

from neuspeech1_tpu_torch.ops.probe_dot import probe_dot
from neuspeech1_tpu_torch.ops.probe_fwd import probe_fwd
from neuspeech1_tpu_torch.perf.common import fwd_rows, normal, timeit

B, H, T, D = 64, 8, 1500, 64
TK = 1536
N_GRID = 256
DOT_M = 512


def make_dot(kdim: int, n_grid: int):
    """run(a [n_grid, 512, kdim], b [n_grid, kdim, N]) -> bf16 a @ b."""
    def run(a, b):
        if a.shape[0] != n_grid or a.shape[2] != kdim:
            raise ValueError(f"make_dot({kdim}, {n_grid}) got a "
                             f"{tuple(a.shape)}")
        return probe_dot(a, b)
    return run


def make_fwd(block_q: int, n_sub: int, *, t_valid: int):
    """The 'base' forward with the TPU block's ``n_sub`` sub-tiles mapped
    to turns of the CTA's warpgroups on the tensor cores
    (``perf/common.py``)."""
    rows = fwd_rows(block_q)

    def run(q, k, v):
        return probe_fwd(q, k, v, t_valid, rows=rows, n_sub=n_sub)
    return run


def main() -> None:
    rng = np.random.default_rng(0)
    for kdim in (64, 128, 256, 512):
        a0 = normal(rng, (N_GRID, DOT_M, kdim))
        b0 = normal(rng, (N_GRID, kdim, TK))
        flops = N_GRID * 2 * DOT_M * kdim * TK
        f = make_dot(kdim, N_GRID)
        ms = timeit(f"dot_k{kdim}", lambda f=f, a=a0, b=b0: f(a, b))
        print(f'{{"k": "dot_k{kdim}_rate", "tflops": {flops / ms / 1e9}}}',
              flush=True)
        del a0, b0
    q0, k0, v0 = (normal(rng, (B * H, TK, D)) for _ in range(3))
    for n_sub in (1, 2, 4):
        f = make_fwd(512, n_sub, t_valid=T)
        timeit(f"fwd_bq512_sub{n_sub}", lambda f=f: f(q0, k0, v0))


if __name__ == "__main__":
    main()
