"""The serving input's host cost on the card's host: the zero tail's scan,
the cast and the whole upload of one beam request's clips.

    python -m neuspeech1_tpu_torch.perf.upload_probe [--repeats 15]

A request is 128 clips of 208 channels x 6000 samples in f32, 2-10 s of
signal at 200 Hz and zeros after, a slice of a pool of 1024 such clips, as
the benchmark's beam cell sends it. One JSON line each, with the median and
the least host ms over ``repeats`` calls:

- ``scan/<variant>``: ``serial`` tests each block with ``np.any`` on one
  thread (the JAX package's `feature_true_len`), ``bits_threads`` is the
  port's (an OR over the samples' bits on slabs of clips in threads),
  ``torch_any`` tests each block with torch's intra-op ``any``;
- ``cast/<variant>`` into bf16: ``fresh`` makes a contiguous f32 copy, a
  fresh bf16 tensor and its pinned copy (the cast before the staging
  buffer), ``staged`` is one ``copy_`` into a pinned buffer kept across
  calls;
- ``upload/<variant>``: the whole call and the copy's wait,
  ``fresh`` the scan, cast and pin above with ``serial``'s scan,
  ``staged`` the port's `upload_features`.

The last line names the card, its power limit and the host's threads.
Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from neuspeech1_tpu_torch.cli import common

BATCH, CHANNELS, SAMPLES, POOL = 128, 208, 6000, 1024


def pool(seed: int = 0) -> np.ndarray:
    """POOL zero-tailed clips of 400-2000 samples of signal."""
    rng = np.random.default_rng(seed)
    out = np.zeros((POOL, CHANNELS, SAMPLES), np.float32)
    for i, n in enumerate(rng.integers(400, 2001, POOL)):
        out[i, :, :n] = rng.standard_normal((CHANNELS, n), np.float32)
    return out


def serial_len(feats: np.ndarray, n_blocks: int = 8) -> int:
    t = feats.shape[-1]
    block = max(1, t // n_blocks)
    n = t
    while n > block and not np.any(feats[..., n - block:n]):
        n -= block
    return n


def torch_any_len(feats: np.ndarray, n_blocks: int = 8) -> int:
    x = torch.from_numpy(feats)
    t = feats.shape[-1]
    block = max(1, t // n_blocks)
    n = t
    while n > block and not bool(x[..., n - block:n].any()):
        n -= block
    return n


def fresh_cast(feats: np.ndarray, n: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        feats[..., :n], dtype=np.float32)).to(torch.bfloat16).pin_memory()


def fresh_upload(feats: np.ndarray) -> torch.Tensor:
    n = serial_len(feats)
    out = fresh_cast(feats, n).to("cuda", non_blocking=True)
    return F.pad(out, (0, feats.shape[-1] - n))


def timed(fn, requests, repeats: int) -> dict:
    """Host ms of ``fn(request)`` over ``repeats`` calls, the requests in
    turn, after one warm call."""
    fn(requests[0])
    ms = []
    for i in range(repeats):
        t0 = time.perf_counter()
        fn(requests[i % len(requests)])
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(ms), "min_ms": min(ms)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    clips = pool()
    requests = [clips[lo:lo + BATCH] for lo in range(0, POOL, BATCH)]
    lens = {serial_len(r) for r in requests}
    for name, fn in (("serial", serial_len),
                     ("bits_threads", common.feature_true_len),
                     ("torch_any", torch_any_len)):
        assert {fn(r) for r in requests} == lens, name
        print(json.dumps({"k": f"scan/{name}", **timed(fn, requests,
                                                       args.repeats)}))
    n = max(lens)
    staging = torch.empty((BATCH, CHANNELS, n), dtype=torch.bfloat16,
                          pin_memory=True)
    for name, fn in (("fresh", lambda r: fresh_cast(r, n)),
                     ("staged", lambda r: staging.copy_(
                         torch.from_numpy(r[..., :n])))):
        print(json.dumps({"k": f"cast/{name}", **timed(fn, requests,
                                                       args.repeats)}))
    for name, fn in (("fresh", fresh_upload),
                     ("staged", lambda r: common.upload_features(
                         r, torch.bfloat16, "cuda"))):
        assert all(torch.equal(fn(r).cpu(), fresh_upload(r).cpu())
                   for r in requests[:2]), name
        print(json.dumps({"k": f"upload/{name}", **timed(
            lambda r: (fn(r), torch.cuda.synchronize()), requests,
            args.repeats)}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch_threads": torch.get_num_threads(),
                      "cpu_count": os.cpu_count(),
                      "affinity": len(os.sched_getaffinity(0)),
                      "lengths": sorted(lens)}))


if __name__ == "__main__":
    main()
