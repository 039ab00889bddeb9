"""ctypes wrapper for the C++ clip loader: the port's copy of
``neuspeech1_tpu/data/native_loader.py``, over its own copy of the source,
``neuspeech1_tpu_torch/csrc/clip_loader.cc``.

The shared library is compiled with ``g++`` on first use into the port's
git-ignored build directory, ``neuspeech1_tpu_torch/_build/``, named by the
hash of the source and the flags (an edited source is rebuilt, an unchanged
one is loaded as it is). It loads batches of .npy signal clips straight into
one [B, modal_ch, n_samples] float32 array: a thread pool reads the files,
converts f8 to f4 and slices and pads, outside the interpreter lock. It is
host code, not a device kernel. Without a toolchain the build raises
ImportError and ``native_available()`` is False; `DataLoader` keeps working
through the Python path then. Output is byte-exact against the Python path
(``EEGDataset._load_signal`` + ``_pad_time``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "clip_loader.cc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_LIB_CACHE: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the source is built, named by the hash of it and the flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libcliploader-{digest.hexdigest()[:16]}.so"


def _build_lib() -> ctypes.CDLL:
    global _LIB_CACHE
    with _LOCK:
        if _LIB_CACHE is not None:
            return _LIB_CACHE
        if not _SRC.exists():
            raise ImportError(f"native source not found: {_SRC}")
        out = library_path()
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise ImportError("native loader build: g++ not found") from e
            if proc.returncode != 0:
                raise ImportError(
                    f"native loader build failed:\n{proc.stderr[:2000]}"
                )
            os.replace(tmp, out)  # atomic: another process sees all or none
        lib = ctypes.CDLL(str(out))
        lib.clip_loader_create.restype = ctypes.c_void_p
        lib.clip_loader_create.argtypes = [ctypes.c_int]
        lib.clip_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.clip_loader_load_batch.restype = ctypes.c_int
        lib.clip_loader_load_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB_CACHE = lib
        return lib


class NativeClipLoader:
    """Threaded batch .npy loader with channel slice/pad + time clip/pad
    (parity with `EEGDataset._load_signal` + `_pad_time`)."""

    def __init__(self, num_threads: int = 4):
        self._lib = _build_lib()
        self._pool = self._lib.clip_loader_create(num_threads)

    def load_batch(
        self,
        paths: Sequence[str],
        modal_ch: int,
        n_samples: int,
        channel_slice=None,
    ) -> np.ndarray:
        n = len(paths)
        out = np.zeros((n, modal_ch, n_samples), dtype=np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        if channel_slice is None:
            ch_start, ch_stop = 0, -1
        else:
            ch_start, ch_stop = channel_slice
        rc = self._lib.clip_loader_load_batch(
            self._pool, arr, n, ch_start, ch_stop, modal_ch,
            n_samples, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise IOError(f"native loader failed on {paths[rc - 1]!r}")
        return out

    def close(self):
        if self._pool:
            self._lib.clip_loader_destroy(self._pool)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def native_available() -> bool:
    try:
        _build_lib()
        return True
    except ImportError:
        return False
