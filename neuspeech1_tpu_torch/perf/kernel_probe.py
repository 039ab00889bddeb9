"""Flash forward variant probe on the card: the counterpart of
``perf/kernel_probe.py`` (full-row forward: mask, exp and bf16-exp costs;
online softmax over column blocks; grid-order hints), through the kernel of
``ops/probe_fwd.py``.

    python -m neuspeech1_tpu_torch.perf.kernel_probe

prints one ``{"k": tag, "ms": ...}`` line per variant of the TPU probe's
sweep (CUDA-event times, not chained host times). Its two library
yardsticks, ``xla_batched_2dots`` (two batched products) and
``official_tuned`` (a library flash kernel), are library calls and not
part of the port: ``chip_smoke.py`` times their counterparts (two
``torch.bmm``, SDPA) beside these kernels. Nothing runs at import.
"""

from __future__ import annotations

import numpy as np

from neuspeech1_tpu_torch.ops.probe_fwd import probe_fwd
from neuspeech1_tpu_torch.perf.common import (fwd_rows, normal, sem_order,
                                              timeit)

# the TPU probe's geometry (the sweep's; the functions read the tensors)
B, H, T, D = 64, 8, 1500, 64
TK = 1536
MODES = ("base", "noexp", "bf16exp", "nomask")


def make_kernel(mode: str, block_q: int, *, t_valid: int):
    """The full-row forward in ``mode`` on [B*H, TK, 64]: run(q, k, v) -> o."""
    rows = fwd_rows(block_q)

    def run(q, k, v):
        return probe_fwd(q, k, v, t_valid, mode=mode, rows=rows)
    return run


def make_online(block_q: int, n_kb: int, *, t_valid: int):
    """The 'base' forward with an online softmax over ``n_kb`` column
    blocks of TK / n_kb keys."""
    rows = fwd_rows(block_q)

    def run(q, k, v):
        return probe_fwd(q, k, v, t_valid, rows=rows, n_kb=n_kb)
    return run


def make_semantics(block_q: int, sem, *, t_valid: int):
    """The 'base' forward under the grid raster that ``sem`` (Mosaic's
    dimension_semantics of the (head, q block) grid) maps to."""
    rows, order = fwd_rows(block_q), sem_order(sem)

    def run(q, k, v):
        return probe_fwd(q, k, v, t_valid, rows=rows, order=order)
    return run


def main() -> None:
    rng = np.random.default_rng(0)
    q0, k0, v0 = (normal(rng, (B * H, TK, D)) for _ in range(3))
    for bq in (256, 512):
        for mode in MODES:
            timeit(f"{mode}_bq{bq}", lambda f=make_kernel(mode, bq, t_valid=T):
                   f(q0, k0, v0))
    for n_kb in (2, 4):
        f = make_online(512, n_kb, t_valid=T)
        timeit(f"online_bq512_kb{n_kb}", lambda f=f: f(q0, k0, v0))
    for sem in (("parallel", "parallel"), ("parallel", "arbitrary")):
        for bq in (512, 256):
            f = make_semantics(bq, sem, t_valid=T)
            timeit(f"sem_{'_'.join(sem)}_bq{bq}", lambda f=f: f(q0, k0, v0))


if __name__ == "__main__":
    main()
