"""Signal ops of the PyTorch port: its copy of what it needs from
``neuspeech1_tpu/ops/signal.py``.

``add_gaussian_noise`` is the numpy noise of the per-item augmentation
(``ops/augment.py::augment_sample``), copied as is so that the same
``np.random.Generator`` gives the same arrays. ``preprocess_eeg`` is
``preprocess_eeg_jnp`` on tensors, on the batch's device.

Reference: `utils/utils.py:12-30` (preprocess_eeg_data), `:33-60`
(add_gaussian_noise).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def add_gaussian_noise(
    signal: np.ndarray,
    snr_range: Tuple[float, float],
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Per-channel additive Gaussian noise at a random SNR (dB).

    Divergence from reference `utils/utils.py:55-58` (noted in SURVEY §7):
    the reference accidentally adds ``signal + (signal + noise)`` which
    doubles the signal; here the noise is added once, which is the intended
    behavior implied by the SNR computation.
    """
    rng = rng or np.random.default_rng()
    ch, length = signal.shape
    snr = rng.uniform(snr_range[0], snr_range[1], size=(ch, 1))
    power = np.mean(signal**2, axis=1, keepdims=True)
    noise_std = np.sqrt(power / (10.0 ** (snr / 10.0)))
    noise = rng.standard_normal((ch, length)) * noise_std
    return (signal + noise).astype(signal.dtype)


def _quantile_sorted(s: torch.Tensor, q: float, midpoint: bool = False):
    """``jnp.quantile`` along the last axis of the sorted ``s`` (keepdims):
    position q (n - 1) in f32, then ``low * (1 - w) + high * w`` ('linear')
    or ``(low + high) * 0.5`` ('midpoint', ``jnp.median``'s method)."""
    n = s.shape[-1]
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = int(torch.floor(pos)), int(torch.ceil(pos))
    lo, hi = s[..., low:low + 1], s[..., high:high + 1]
    if midpoint:
        return (lo + hi) * 0.5
    w = (pos - low).to(s.dtype)
    return lo * (1 - w) + hi * w


def preprocess_eeg(data: torch.Tensor, threshold: float = 10.0,
                   baseline_samples: int = 500) -> torch.Tensor:
    """Baseline-correct, robust-scale, clip and normalize [..., ch, T]
    signals along T: ``preprocess_eeg_jnp`` on tensors. The quartiles and
    the median take ``jnp.percentile``'s 'linear' and ``jnp.median``'s
    'midpoint' interpolation over one sort (``torch.quantile`` caps its
    input's size, and ``torch.median`` takes the lower middle value)."""
    data = data - data[..., :baseline_samples].mean(-1, keepdim=True)
    s = data.sort(-1).values
    med = _quantile_sorted(s, 0.5, midpoint=True)
    q1 = _quantile_sorted(s, 0.25)
    q3 = _quantile_sorted(s, 0.75)
    iqr = torch.where(q3 - q1 == 0, torch.ones_like(q1), q3 - q1)
    return torch.clamp((data - med) / iqr, -threshold, threshold) / threshold
