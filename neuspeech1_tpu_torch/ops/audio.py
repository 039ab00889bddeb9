"""Whisper-compatible log-mel spectrogram front end (the speech modality):
the port's copy of ``neuspeech1_tpu/ops/audio.py``.

Self-contained replacement for librosa/WhisperFeatureExtractor (the reference
computes features via `WhisperProcessor(audio=...)`, `utils/reader.py:466`).
Numerics follow OpenAI Whisper: 16 kHz, n_fft=400, hop=160, 80 slaney-scale
mel bins, log10 clamp to (max - 8), then (x + 4) / 4.

``mel_filterbank``, ``pad_or_trim`` and the numpy ``log_mel_spectrogram``
are copied as they are (the same bits as the JAX package's on one machine);
``SpeechDataset`` runs the numpy version on the host, as the JAX package
does. ``log_mel_spectrogram_torch`` is the JAX package's jnp version in
plain PyTorch, on a batch on any device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from neuspeech1_tpu_torch.config import AUDIO_SAMPLE_RATE

N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH_S = 30
N_SAMPLES = AUDIO_SAMPLE_RATE * CHUNK_LENGTH_S  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )


@lru_cache(maxsize=4)
def mel_filterbank(
    sr: int = AUDIO_SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS
) -> np.ndarray:
    """[n_mels, n_fft//2+1] slaney-normalized triangular filterbank
    (librosa.filters.mel defaults, which Whisper uses)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_min = _hz_to_mel_slaney(0.0)
    mel_max = _hz_to_mel_slaney(sr / 2.0)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalization: constant energy per band
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = N_MELS, pad_to_chunk: bool = True) -> np.ndarray:
    """numpy log-mel. ``audio``: [T] float in [-1, 1] at 16 kHz.

    Returns [n_mels, n_frames] float32 (n_frames = 3000 for a 30 s chunk).
    """
    audio = np.asarray(audio, dtype=np.float32)
    if pad_to_chunk:
        audio = pad_or_trim(audio)
    # center=True reflect padding, matching torch.stft in Whisper
    padded = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    n_frames = 1 + (padded.shape[-1] - N_FFT) // HOP_LENGTH
    idx = np.arange(N_FFT)[None, :] + HOP_LENGTH * np.arange(n_frames)[:, None]
    frames = padded[idx] * window[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    magnitudes = np.abs(spec[:-1]) ** 2  # whisper drops the final frame
    mel = mel_filterbank(n_mels=n_mels) @ magnitudes.T.astype(np.float32)
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def log_mel_spectrogram_torch(audio, n_mels: int = N_MELS,
                              device=None) -> torch.Tensor:
    """Log-mel of a batch [B, N_SAMPLES] (already padded or trimmed) in
    f32 on ``device`` (the audio's own device when None): reflect padding,
    the Hann window, ``torch.fft.rfft``, the filterbank product, log10 and
    the clamp at each item's max - 8, as ``log_mel_spectrogram_jnp``.
    Returns [B, n_mels, N_FRAMES]."""
    audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
    device = audio.device
    half = N_FFT // 2
    padded = F.pad(audio[:, None, :], (half, half), mode="reflect")[:, 0]
    window = torch.as_tensor(np.hanning(N_FFT + 1)[:-1], dtype=torch.float32,
                             device=device)
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH) * window
    magnitudes = torch.fft.rfft(frames, dim=-1)[:, :-1].abs() ** 2
    fb = torch.as_tensor(mel_filterbank(n_mels=n_mels), device=device)
    mel = torch.einsum("mf,btf->bmt", fb, magnitudes)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    maxv = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, maxv - 8.0)
    return (log_spec + 4.0) / 4.0
