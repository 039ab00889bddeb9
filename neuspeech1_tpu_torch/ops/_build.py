"""Builds the CUDA sources under ``neuspeech1_tpu_torch/csrc/`` on first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``neuspeech1_tpu_torch/_build/lib<name>-<hash>.so``, then loaded with
``ctypes``. The hash covers the source, the headers it includes from
``csrc/`` (``#include "..."``, followed through headers) and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded as it
is. This takes seconds per file, where ``torch.utils.cpp_extension.load`` (which compiles PyTorch's
headers) takes minutes. ``nvcc``'s resource report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside the library as ``.log``.

Nothing here runs at import: callers build when they first launch a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of neuspeech1_tpu_torch are built from source on first use")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` that it includes,
    directly or through another header, in the order first met."""
    found, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo.extend(SRC_DIR / inc
                        for inc in _INCLUDE.findall(path.read_text()))
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, named by the hash of its sources
    and the flags."""
    data = b"".join(path.read_bytes() for path in sources(name))
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """``nvcc``'s output from the build of the current ``<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()
