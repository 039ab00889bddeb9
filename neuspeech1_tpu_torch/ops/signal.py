"""Signal ops of the PyTorch port: its copy of
``neuspeech1_tpu/ops/signal.py``.

The numpy and scipy functions are copied as they are, so that the same
inputs (and the same ``np.random.Generator``) give the same arrays:
``robust_scale`` and ``preprocess_eeg_data``, the per-item augmentation's
``add_gaussian_noise`` (``ops/augment.py::augment_sample``), and the
filters and resampler of the offline preprocessing (``data/preprocess.py``),
which raise when scipy is absent. ``preprocess_eeg`` is
``preprocess_eeg_jnp`` on tensors, on the batch's device.

Reference: `utils/utils.py:12-30` (preprocess_eeg_data), `:33-60`
(add_gaussian_noise), `:62-72` (lowpass_filter).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

try:  # the offline filters need scipy; everything else works without it
    import scipy.signal as _scipy_signal
except ImportError:  # pragma: no cover
    _scipy_signal = None


def robust_scale(data: np.ndarray, axis: int = -1) -> np.ndarray:
    """Per-channel (median, IQR) scaling == sklearn RobustScaler defaults.

    ``data`` is [channels, time]; statistics are computed along ``axis``.
    sklearn uses interpolated quartiles (numpy 'linear' percentile), and
    leaves zero-IQR features unscaled.
    """
    med = np.median(data, axis=axis, keepdims=True)
    q1 = np.percentile(data, 25.0, axis=axis, keepdims=True)
    q3 = np.percentile(data, 75.0, axis=axis, keepdims=True)
    iqr = q3 - q1
    iqr = np.where(iqr == 0, 1.0, iqr)
    return (data - med) / iqr


def preprocess_eeg_data(
    data: np.ndarray, threshold: float = 10.0, baseline_samples: int = 500
) -> Tuple[np.ndarray, float]:
    """Baseline-correct + robust-scale + clip + normalize a [ch, T] clip.

    Parity with reference `utils/utils.py:12-30`: baseline = mean of the first
    ``baseline_samples`` samples per channel; RobustScaler over the full
    clip; clip to ±threshold; divide by threshold. Returns (data, clipped
    ratio) where the ratio counts post-scaling |x| > 1 (i.e. clipped) points.
    """
    data = np.asarray(data, dtype=np.float64)
    baseline = data[:, :baseline_samples].mean(axis=1, keepdims=True)
    data = data - baseline
    data = robust_scale(data, axis=-1)
    clipped = np.abs(data) > threshold
    clipped_ratio = float(clipped.sum()) / data.size
    data = np.clip(data, -threshold, threshold) / threshold
    return data.astype(np.float32), clipped_ratio


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


def lowpass_filter(
    signal: np.ndarray, cutoff_freq: float, sample_freq: float, axis: int = -1
) -> np.ndarray:
    """4th-order Butterworth low-pass (reference `utils/utils.py:62-72`).

    Divergence: the reference filters along axis=0, which for [ch, T] data
    filters across channels; the default here is the time axis.
    """
    if _scipy_signal is None:
        raise RuntimeError("scipy is required for lowpass_filter")
    nyq = sample_freq / 2.0
    b, a = _scipy_signal.butter(4, cutoff_freq / nyq, btype="low")
    return _scipy_signal.lfilter(b, a, signal, axis=axis)


def bandpass_filter(
    signal: np.ndarray,
    low_hz: float,
    high_hz: float,
    sample_freq: float,
    order: int = 4,
    axis: int = -1,
) -> np.ndarray:
    """Zero-phase Butterworth band-pass, used by the offline preprocessing
    CLIs in place of MNE's filter (reference filters 1-58 Hz via
    `raw.filter`, `process_dataset/gwilliams2023_process.py:144`)."""
    if _scipy_signal is None:
        raise RuntimeError("scipy is required for bandpass_filter")
    nyq = sample_freq / 2.0
    sos = _scipy_signal.butter(
        order, [low_hz / nyq, high_hz / nyq], btype="band", output="sos"
    )
    return _scipy_signal.sosfiltfilt(sos, signal, axis=axis)


def notch_filter(
    signal: np.ndarray, freq_hz: float, sample_freq: float, q: float = 30.0,
    axis: int = -1,
) -> np.ndarray:
    """50/60 Hz notch (reference `process_dataset/schoffelen_process.py:154`)."""
    if _scipy_signal is None:
        raise RuntimeError("scipy is required for notch_filter")
    b, a = _scipy_signal.iirnotch(freq_hz, q, fs=sample_freq)
    return _scipy_signal.filtfilt(b, a, signal, axis=axis)


def resample(signal: np.ndarray, orig_sr: int, target_sr: int, axis: int = -1) -> np.ndarray:
    """Polyphase resampling (MNE/librosa replacement for the offline CLIs)."""
    if orig_sr == target_sr:
        return signal
    if _scipy_signal is None:
        raise RuntimeError("scipy is required for resample")
    from math import gcd

    g = gcd(int(orig_sr), int(target_sr))
    return _scipy_signal.resample_poly(
        signal, int(target_sr) // g, int(orig_sr) // g, axis=axis
    )


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
