"""The port's log-mel front end (neuspeech1_tpu_torch/ops/audio.py) and wav
reader (data/synthetic.py::read_wav) against the JAX package's, in f32 on
the CPU: the filterbank, ``pad_or_trim``, the numpy log-mel and the read
samples bit for bit; ``log_mel_spectrogram_torch`` within rtol 1e-3 / atol
1e-4 of ``log_mel_spectrogram_jnp`` (the bound the JAX package holds
between its own two versions, tests/test_signal_ops.py:80)."""

import wave

import numpy as np
import pytest
import torch

from neuspeech1_tpu.data import synthetic as jsyn
from neuspeech1_tpu.ops import audio as ja
from neuspeech1_tpu_torch.data import synthetic as tsyn
from neuspeech1_tpu_torch.ops import audio as ta

torch.set_num_threads(1)

MEL_RTOL, MEL_ATOL = 1e-3, 1e-4


def _clip(seconds, seed=0, sr=16000):
    """A chirp plus noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    return np.clip(sig + 0.05 * rng.standard_normal(t.shape), -1, 1
                   ).astype(np.float32)


def test_constants_equal_jax_package():
    for name in ("N_FFT", "HOP_LENGTH", "N_MELS", "CHUNK_LENGTH_S",
                 "N_SAMPLES", "N_FRAMES"):
        assert getattr(ta, name) == getattr(ja, name), name


@pytest.mark.parametrize("sr,n_fft,n_mels", [
    (16000, 400, 80), (16000, 400, 128), (8000, 256, 40), (22050, 512, 64)])
def test_mel_filterbank_equals_jax_package(sr, n_fft, n_mels):
    got = ta.mel_filterbank(sr, n_fft, n_mels)
    ref = ja.mel_filterbank(sr, n_fft, n_mels)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,length", [
    ((1000,), 4000), ((5000,), 4000), ((2, 300), 500), ((3, 900), 500),
    ((4000,), 4000)])
def test_pad_or_trim_equals_jax_package(shape, length):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got, ref = ta.pad_or_trim(x, length), ja.pad_or_trim(x, length)
    assert got.shape == shape[:-1] + (length,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seconds,n_mels,pad", [
    (2.0, 80, True), (7.5, 80, True), (31.0, 80, True), (1.0, 128, True),
    (1.5, 80, False)])
def test_numpy_log_mel_equals_jax_package(seconds, n_mels, pad):
    a = _clip(seconds, seed=int(seconds * 10))
    got = ta.log_mel_spectrogram(a, n_mels=n_mels, pad_to_chunk=pad)
    ref = ja.log_mel_spectrogram(a, n_mels=n_mels, pad_to_chunk=pad)
    assert got.dtype == np.float32
    if pad:
        assert got.shape == (n_mels, ta.N_FRAMES)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_torch_log_mel_matches_jnp(n_mels):
    """A batch of two clips (3 s and 11 s, padded to 30 s): the torch
    log-mel against the JAX package's jnp one, and against the numpy one
    item by item (the clamp is at each item's own max)."""
    batch = np.stack([ta.pad_or_trim(_clip(3.0, seed=1)),
                      ta.pad_or_trim(0.1 * _clip(11.0, seed=2))])
    got = ta.log_mel_spectrogram_torch(torch.from_numpy(batch), n_mels,
                                       device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == (2, n_mels, ta.N_FRAMES)
    ref = np.asarray(ja.log_mel_spectrogram_jnp(batch, n_mels=n_mels))
    np.testing.assert_allclose(got.numpy(), ref, rtol=MEL_RTOL,
                               atol=MEL_ATOL)
    for i in range(2):
        np.testing.assert_allclose(
            got[i].numpy(), ta.log_mel_spectrogram(batch[i], n_mels=n_mels),
            rtol=MEL_RTOL, atol=MEL_ATOL)
    # the items' floors differ: each is clamped at its own max - 8
    assert got[0].min() != got[1].min()


def test_torch_log_mel_takes_numpy_and_silence():
    """A numpy batch goes to the given device; a silent clip is the mel
    floor everywhere (log10 of 1e-10, clamped at its own max)."""
    batch = np.zeros((1, ta.N_SAMPLES), np.float32)
    got = ta.log_mel_spectrogram_torch(batch, device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ja.log_mel_spectrogram_jnp(batch)),
                               rtol=MEL_RTOL, atol=MEL_ATOL)
    assert torch.all(got == (-10.0 + 4.0) / 4.0)


def _write_pcm(path, samples, width, channels, sr):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(samples.tobytes())


WAV_CASES = {
    "pcm16_mono": (2, 1, 16000, "<i2"),
    "pcm16_stereo": (2, 2, 22050, "<i2"),
    "pcm32_mono": (4, 1, 44100, "<i4"),
    "pcm8_mono": (1, 1, 8000, np.uint8),
}


@pytest.mark.parametrize("case", sorted(WAV_CASES))
def test_read_wav_equals_jax_package(tmp_path, case):
    width, channels, sr, dtype = WAV_CASES[case]
    info = np.iinfo(dtype)
    samples = np.random.default_rng(2).integers(
        info.min, int(info.max) + 1, 1000 * channels, dtype=np.int64
    ).astype(dtype)
    path = str(tmp_path / f"{case}.wav")
    _write_pcm(path, samples, width, channels, sr)
    got, got_sr = tsyn.read_wav(path)
    ref, ref_sr = jsyn.read_wav(path)
    assert got_sr == ref_sr == sr
    assert got.dtype == ref.dtype and got.shape == (1000,)
    np.testing.assert_array_equal(got, ref)


def test_read_wav_refuses_24_bit(tmp_path):
    path = str(tmp_path / "pcm24.wav")
    _write_pcm(path, np.zeros(300, np.uint8), 3, 1, 16000)
    with pytest.raises(ValueError, match="sample width 3"):
        tsyn.read_wav(path)


def test_write_then_read_wav_round_trip(tmp_path):
    """Both packages' writers give the same file, and the port reads back
    its 16-bit samples: written as x * 32767 truncated, read as n / 32768,
    within one step of truncation and one of the scales' difference."""
    a = _clip(0.5, seed=3)
    paths = [str(tmp_path / f"{n}.wav") for n in ("jax", "port")]
    jsyn.write_wav(paths[0], a)
    tsyn.write_wav(paths[1], a)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    got, sr = tsyn.read_wav(paths[1])
    assert sr == 16000
    np.testing.assert_allclose(got, a, rtol=0, atol=2.0 / 32768)
