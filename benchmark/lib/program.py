"""What the benchmark takes from the program, ``neuspeech1_tpu_torch``:
its configuration objects built from a configuration file, and its kernel
libraries built (or found built) before the first step.

The program builds each CUDA source once per checkout into
``neuspeech1_tpu_torch/_build/``, a fixed directory inside the checkout, so
only a checkout's first run compiles.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor


def whisper_config(config: dict):
    """(WhisperConfig, StemConfig) of the program for a configuration
    file."""
    from neuspeech1_tpu_torch.config import StemConfig, WhisperConfig

    return (WhisperConfig(**config["model"], dtype=config["dtype"],
                          param_dtype=config["param_dtype"],
                          remat=config["remat"],
                          remat_policy=config["remat_policy"]),
            StemConfig(**config["stem"]))


def build_kernels() -> float:
    """Builds or loads every kernel library of the main path, one nvcc per
    source, all started together; returns the seconds it took."""
    from neuspeech1_tpu_torch.ops import decode_cross, decode_step
    from neuspeech1_tpu_torch.ops import flash_attention, lora_bwd

    loaders = (flash_attention._library, flash_attention._bwd_library,
               lora_bwd._library, decode_cross._library,
               decode_step._library)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        for future in [pool.submit(f) for f in loaders]:
            future.result()
    return time.perf_counter() - t0
