"""Waveform file I/O without librosa/soundfile.

A copy of the JAX package's ``ops/io.py``: WAV I/O goes through
``scipy.io.wavfile`` with soundfile-compatible float normalization (PCM16
-> float in [-1, 1))."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def load_wav_with_rate(path: str) -> tuple[np.ndarray, int]:
    """Read a wav file into float32 in [-1, 1) plus its own sample rate."""
    sr, data = wavfile.read(path)
    return _normalize_pcm(data), int(sr)


def load_wav(path: str, expected_sample_rate: int | None = None) -> np.ndarray:
    """Read a wav file into float32 in [-1, 1); assert sample rate matches."""
    sr, data = wavfile.read(path)
    if expected_sample_rate is not None:
        assert sr == expected_sample_rate, (
            f"Sample rate mismatch: expected {expected_sample_rate}, got {sr}"
        )
    return _normalize_pcm(data)


def _normalize_pcm(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # downmix multi-channel
        data = data.mean(axis=1)
    return data


def save_wav(data: np.ndarray, path: str, sample_rate: int) -> None:
    """Write float waveform to 16-bit PCM wav."""
    data = np.asarray(data, dtype=np.float32)
    peak = np.max(np.abs(data))
    if peak > 1.0:
        data = data / peak
    wavfile.write(path, sample_rate, (data * 32767.0).astype(np.int16))


def load(path: str, hp) -> np.ndarray:
    """Read a wav at ``hp.sample_rate``."""
    return load_wav(path, hp.sample_rate)


def save(data: np.ndarray, path: str, hp) -> None:
    """Write a wav at ``hp.sample_rate``."""
    save_wav(data, path, hp.sample_rate)
