"""What the probe modules share: the map from a TPU probe's ``block_q`` and
``dimension_semantics`` to the card's schedule, seeded inputs, and the
sweep's timer; and what the flash kernels' variant scripts share: a
source with its substitutions applied, built on its own.

- Forward: a TPU block of ``block_q`` rows held its whole score row in
  VMEM; a Hopper CTA keeps R rows of f32 scores in shared memory, 192 KB
  at R = 32 over 1536 columns. R = block_q / 16: 512 -> 32, 256 -> 16.
  These are the only R the full row fits in 16-row mma fragments (R = 64
  would need 394 KB), so the sweep covers every R the card can run there.
- Backward: R = the q rows of a dq CTA and of each q tile the dk/dv CTA
  walks, block_q / 8 rounded up to the 16-row mma fragment: 512 -> 64,
  256 -> 32, 192 -> 32.
- ``dimension_semantics`` told Mosaic which grid axes it may split across
  cores or reorder; on the card its counterpart is the grid's raster. The
  last entry names the q-block axis: 'arbitrary' (kept in order per head)
  maps to the head-major raster, 'parallel' to the q-block-major one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from neuspeech1_tpu_torch.ops import _build


def fwd_rows(block_q: int) -> int:
    return block_q // 16


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
