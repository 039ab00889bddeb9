"""What the probe modules share: the map from a TPU probe's ``block_q``,
``n_sub`` and ``dimension_semantics`` to the card's schedule, seeded
inputs, and the sweep's timer; and what the flash kernels' variant scripts
share: a source with its substitutions applied, built on its own.

- Forward (csrc/probe_fwd.cu, redesigned for Hopper: wgmma fed by a TMA
  ring, scores in registers, two sweeps over K). A TPU block of
  ``block_q`` rows held its whole score row in VMEM; a Hopper CTA holds
  its q rows in whole consumer warpgroups of 64, each with its scores in
  registers, one K tile at a time. rows = block_q / 4: 512 -> 128 (two
  warpgroups, one CTA an SM), 256 -> 64 (one warpgroup, two CTAs an SM).
  This replaces R = block_q / 16 (f32 scores of R rows over all 1536
  columns in shared memory, 192 KB at R = 32: one 4-warp CTA an SM, 11.5
  ms at bq512); the new forward is bound by its exponentials (PERF.md
  §6).
- ``n_sub`` (``perf/mxu_probe.py::make_fwd``: the q block in sub-tiles
  whose QK products all issue before any softmax, so that the MXU and the
  VPU overlap) becomes how the consumer warpgroups take turns on the
  tensor cores: 1, free-running (no order between them); 2, ping-pong
  (each warpgroup issues a K tile's products in its turn and hands the
  turn on by a named barrier, so one warpgroup's softmax runs under the
  other's products); 4, ping-pong on 64-column K tiles (four turns per
  128 columns). With one warpgroup (rows 64) only n_sub = 1 exists.
- Backward: R = the q rows of a dq CTA and of each q tile the dk/dv CTA
  walks, block_q / 8 rounded up to the 16-row mma fragment: 512 -> 64,
  256 -> 32, 192 -> 32.
- ``dimension_semantics`` told Mosaic which grid axes it may split across
  cores or reorder; on the card its counterpart is the order of the work
  items. The last entry names the q-block axis: 'arbitrary' (kept in
  order per head) maps to the head-major walk ('head': a head's q tiles in
  consecutive items, so the persistent CTAs in flight share its K/V in
  L2), 'parallel' to the q-block-major one ('qblock').
- ``btc`` ([B, TK, H*64]) reads each head in place: the TMA maps view the
  array as B*TK rows of H*64 elements and take a head's 64 columns.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from neuspeech1_tpu_torch.ops import _build


def fwd_rows(block_q: int) -> int:
    return block_q // 4


def bwd_rows(block_q: int) -> int:
    return 16 * -(-block_q // 128)


def sem_order(sem) -> str:
    return "qblock" if sem[-1] == "parallel" else "head"


def normal(rng: np.random.Generator, shape, dtype=torch.bfloat16,
           loc: float = 0.0, scale: float = 1.0):
    """N(loc, scale^2) drawn by numpy (as the TPU probes draw theirs), in
    ``dtype`` on the card."""
    x = rng.standard_normal(shape, dtype=np.float32) * scale + loc
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events, after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timeit(tag: str, fn) -> float:
    """Times ``fn`` and prints the probe's line ``{"k": tag, "ms": ...}``."""
    ms = cuda_ms(fn)
    print(json.dumps({"k": tag, "ms": ms}), flush=True)
    return ms


def variant_source(source: str, name: str, substitutions) -> str:
    """``csrc/<source>.cu`` with the headers it includes from ``csrc/``
    written in (so that a variant may change them too and builds from the
    build directory), and each (old, new) of ``substitutions`` applied; an
    ``old`` must match exactly once."""
    src = (_build.SRC_DIR / f"{source}.cu").read_text()
    for header in _build.sources(source)[1:]:
        src = src.replace(f'#include "{header.name}"', header.read_text())
    for old, new in substitutions:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variant(source: str, name: str, text: str):
    """Builds ``text`` as ``<source>_<name>`` in the build directory with
    the flags of ``_build``; returns (the library, nvcc's output)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{source}_{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{source}_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr
