"""Audio DSP on the card: spectrograms, Griffin-Lim vocoding, MFCCs.

Port of the JAX package's ``ops/audio.py`` (librosa semantics in
``ops/stft.py`` and ``ops/mel.py``).  Each function takes numpy and ``hp``,
runs its transforms on ``device`` (the card unless the caller passes
``"cpu"``; ``device.resolve_device``) and returns numpy, as the JAX
functions do.  De-emphasis, a first-order IIR filter, runs on the host with
``scipy.signal.lfilter`` (float64 inside), where the waveform goes anyway.

Griffin-Lim draws its initial phases from a ``torch.Generator`` on the
device seeded with ``seed``; ``angles`` (complex, the magnitudes' shape)
replaces that draw, which is how a comparison with the JAX package feeds
in its ``jax.random`` phases.  The mel cepstral distortion takes its MFCCs
on the device and aligns them on the host (``ops.dtw``).
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import scipy.signal
import torch

from multilingual_text_to_speech_tpu_torch.device import (
    DeviceLike,
    resolve_device,
)
from multilingual_text_to_speech_tpu_torch.ops import mel as mel_ops
from multilingual_text_to_speech_tpu_torch.ops.dtw import dtw_path
from multilingual_text_to_speech_tpu_torch.ops import stft as stft_ops
from multilingual_text_to_speech_tpu_torch.ops.io import (  # noqa: F401
    load,
    save,
)


def ms_to_frames(ms: float, hp) -> int:
    """Milliseconds -> samples."""
    return int(hp.sample_rate * ms / 1000)


def duration(data, hp) -> float:
    """Duration of a waveform in seconds."""
    return len(data) / hp.sample_rate


def _stft_sizes(hp):
    return (hp.num_fft, ms_to_frames(hp.stft_shift_ms, hp),
            ms_to_frames(hp.stft_window_ms, hp))


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# pre/de-emphasis
# ---------------------------------------------------------------------------

def preemphasis(y, coef: float = 0.97):
    """FIR ``y[n] = x[n] - coef * x[n-1]`` along the last axis
    (``scipy.signal.lfilter([1, -coef], [1], y)``), in float32; a tensor
    in gives a tensor out on its device, anything else numpy."""
    if isinstance(y, torch.Tensor):
        return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], -1)
    y = np.asarray(y, dtype=np.float32)
    return np.concatenate(
        [y[..., :1], y[..., 1:] - np.float32(coef) * y[..., :-1]], -1)


def deemphasis(y, coef: float = 0.97) -> np.ndarray:
    """IIR ``y[n] = x[n] + coef * y[n-1]`` along the last axis, on the host
    (``scipy.signal.lfilter``), float32 out."""
    y = np.asarray(y, dtype=np.float32)
    return scipy.signal.lfilter([1.0], [1.0, -coef], y, axis=-1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# spectrograms
# ---------------------------------------------------------------------------

def spectrogram(y, hp, mel: bool = False,
                device: DeviceLike = None) -> np.ndarray:
    """Waveform -> log-magnitude (optionally mel) spectrogram [bins, T] in
    dB against its own maximum."""
    n_fft, hop, win = _stft_sizes(hp)
    y = _tensor(y, resolve_device(device))
    if hp.use_preemphasis:
        y = preemphasis(y, float(hp.preemphasis))
    S = stft_ops.stft(y, n_fft, hop, win).abs()
    if mel:
        S = mel_ops.linear_to_mel_spec(S, hp.sample_rate, n_fft, hp.num_mels)
    return mel_ops.amplitude_to_db(S).cpu().numpy()


def mel_spectrogram(y, hp, device: DeviceLike = None) -> np.ndarray:
    return spectrogram(y, hp, mel=True, device=device)


def linear_to_mel(S_db, hp, device: DeviceLike = None) -> np.ndarray:
    """dB linear spectrogram -> dB mel spectrogram (through amplitudes, so
    not identical to the direct mel path)."""
    S = mel_ops.db_to_amplitude(_tensor(S_db, resolve_device(device)))
    M = mel_ops.linear_to_mel_spec(S, hp.sample_rate, hp.num_fft,
                                   hp.num_mels)
    return mel_ops.amplitude_to_db(M).cpu().numpy()


def _griffin_lim_batch(s_db, hp, mel: bool, seed: int,
                       angles: Optional[torch.Tensor],
                       device: DeviceLike) -> np.ndarray:
    """dB spectrograms ``[..., bins, F]`` -> Griffin-Lim waveforms (numpy,
    before de-emphasis): dB -> amplitude, the mel NNLS inverse when
    ``mel``, ``S ** hp.griffin_lim_power``, ``hp.griffin_lim_iters``
    iterations."""
    dev = resolve_device(device)
    n_fft, hop, win = _stft_sizes(hp)
    S = mel_ops.db_to_amplitude(_tensor(s_db, dev))
    if mel:
        S = mel_ops.mel_to_linear_nnls(S, hp.sample_rate, n_fft, hp.num_mels)
    y = stft_ops.griffin_lim(
        S ** hp.griffin_lim_power, n_fft, hop, win,
        n_iter=hp.griffin_lim_iters,
        generator=torch.Generator(dev).manual_seed(seed), angles=angles)
    return y.cpu().numpy()


def inverse_spectrogram(s_db, hp, mel: bool = False, seed: int = 0,
                        angles: Optional[torch.Tensor] = None,
                        device: DeviceLike = None) -> np.ndarray:
    """Log-magnitude spectrogram [bins, F] -> waveform by Griffin-Lim, then
    de-emphasis (``hp.use_preemphasis``) and ``y / max(y)``."""
    y = _griffin_lim_batch(s_db, hp, mel, seed, angles, device)
    if hp.use_preemphasis:
        y = deemphasis(y, hp.preemphasis)
    return y / np.max(y)


def inverse_mel_spectrogram(s_db, hp, seed: int = 0,
                            angles: Optional[torch.Tensor] = None,
                            device: DeviceLike = None) -> np.ndarray:
    return inverse_spectrogram(s_db, hp, mel=True, seed=seed, angles=angles,
                               device=device)


def inverse_spectrogram_batch(s_db_batch, hp, mel: bool = False,
                              seed: int = 0,
                              angles: Optional[torch.Tensor] = None,
                              device: DeviceLike = None) -> np.ndarray:
    """Batched Griffin-Lim: ``[B, bins, F]`` -> waveforms ``[B, samples]``
    in one batch of transforms, each normalized by its own maximum.  Pad
    the spectrograms to a common frame count first, and crop each waveform
    to ``hop * (F_i - 1)`` after."""
    y = _griffin_lim_batch(s_db_batch, hp, mel, seed, angles, device)
    if hp.use_preemphasis:
        y = deemphasis(y, hp.preemphasis)
    return y / np.max(y, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def _norm_constants(hp, is_mel: bool):
    stats = hp.mel_normalization() if is_mel else hp.lin_normalization()
    if stats is None:
        kind = "mel" if is_mel else "lin"
        raise ValueError(
            f"hp.{kind}_normalize_mean/variance are unset; compute them from "
            "the training set or load them with the model's hyper-parameters "
            "before normalizing or denormalizing spectrograms.")
    return stats


def normalize_spectrogram(S, hp, is_mel: bool):
    """Per-channel ``(S - mean) / variance`` of a [bins, frames] numpy
    spectrogram."""
    mean, var = _norm_constants(hp, is_mel)
    return (S - mean) / var


def denormalize_spectrogram(S, hp, is_mel: bool):
    """Per-channel ``S * variance + mean`` of a [bins, frames] numpy
    spectrogram."""
    mean, var = _norm_constants(hp, is_mel)
    return S * var + mean


# ---------------------------------------------------------------------------
# MFCC
# ---------------------------------------------------------------------------

def get_spectrogram_mfcc(S, hp, device: DeviceLike = None) -> np.ndarray:
    """MFCCs of a dB mel spectrogram (``librosa.feature.mfcc(S=S/10)``)."""
    S = _tensor(S, resolve_device(device)) / 10.0
    return mel_ops.mfcc_from_db_mel(S, hp.num_mfcc).cpu().numpy()


def get_mfcc(y, hp, device: DeviceLike = None) -> np.ndarray:
    """MFCCs of a waveform."""
    return get_spectrogram_mfcc(mel_spectrogram(y, hp, device), hp, device)


def mel_cepstral_distortion(
    S1, S2, hp, mode: Literal["cut", "stretch", "dtw"] = "dtw",
    device: DeviceLike = None,
) -> float:
    """MCD between two dB mel spectrograms [bins, F1] and [bins, F2]: the
    mean over aligned frames of the Euclidean distance between their MFCCs
    without c0.  ``mode`` "cut" truncates the longer sequence, "stretch"
    resamples the shorter one by nearest index, "dtw" aligns them by exact
    DTW on the host."""

    def mcd(a: np.ndarray, b: np.ndarray) -> float:
        diff = a - b
        return float(np.mean(np.sqrt(np.sum(diff * diff, axis=0))))

    x = get_spectrogram_mfcc(S1, hp, device)[1:]  # drop c0
    y = get_spectrogram_mfcc(S2, hp, device)[1:]

    if mode == "cut":
        n = min(x.shape[1], y.shape[1])
        x, y = x[:, :n], y[:, :n]
    elif mode == "stretch":
        if x.shape[1] > y.shape[1]:
            m = x.shape[1]
            y = y[:, [i * y.shape[1] // m for i in range(m)]]
        else:
            m = y.shape[1]
            x = x[:, [i * x.shape[1] // m for i in range(m)]]
    elif mode == "dtw":
        px, py = dtw_path(x.T, y.T)
        x, y = x[:, px], y[:, py]
    else:
        raise ValueError(f"unknown MCD mode: {mode}")

    return mcd(x, y)


# the reference's spelling, kept as an alias
mel_cepstral_distorision = mel_cepstral_distortion


# ---------------------------------------------------------------------------
# silence trimming
# ---------------------------------------------------------------------------

def trim_silence(data: np.ndarray, window_ms: float, hop_ms: float, hp,
                 top_db: float = 50, margin_ms: float = 0):
    """Trim leading and trailing silence (``librosa.effects.trim``: frame
    RMS power in dB against the signal's peak, threshold ``top_db``), on
    the host.  Returns the trimmed signal and its ``(start, end)``."""
    wf = ms_to_frames(window_ms, hp)
    hf = ms_to_frames(hop_ms, hp)
    mf = ms_to_frames(margin_ms, hp)
    if mf != 0:
        data = data[mf:-mf]

    data = np.asarray(data, dtype=np.float32)
    if len(data) < wf:
        return data, (0, len(data))

    # frame RMS (librosa.feature.rms with center=True pads by wf//2)
    padded = np.pad(data, wf // 2)
    n_frames = 1 + (len(padded) - wf) // hf
    idx = np.arange(n_frames)[:, None] * hf + np.arange(wf)[None, :]
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=1))

    power_db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(np.max(rms), 1e-10))
    non_silent = power_db > -top_db

    if not non_silent.any():
        return data[0:0], (0, 0)
    nz = np.flatnonzero(non_silent)
    start = int(nz[0] * hf)
    end = min(len(data), int((nz[-1] + 1) * hf))
    return data[start:end], (start, end)
