"""Mel filterbanks, dB scaling and DCT, librosa-compatible, in PyTorch.

Port of the JAX package's ``ops/mel.py``: the Slaney mel scale with area
normalization (``librosa.filters.mel``'s defaults),
``amplitude_to_db(ref=np.max, top_db=None)`` and orthonormal type-II DCT
MFCCs.  The filterbank and DCT matrices are built once on the host
(numpy, float32; the same code as the JAX package's); the projections run
as matrix products on the tensors' device, in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_AMIN = 1e-5  # librosa.amplitude_to_db amin


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney (htk=False) Hz->mel: linear below 1 kHz, log above."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Slaney mel->Hz inverse."""
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(
        log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank ``[n_mels, 1 + n_fft//2]``
    (librosa.filters.mel with default htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sample_rate / 2.0

    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)

    mel_pts = np.linspace(hz_to_mel(np.array(fmin)), hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~constant energy.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal type-II DCT matrix ``[n_out, n_in]``
    (scipy.fftpack.dct(type=2, norm='ortho') as used by librosa.feature.mfcc)."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n[None, :] + 1.0) / (2.0 * n_in))
    scale = np.empty((n_out, 1))
    scale[0] = np.sqrt(1.0 / (4.0 * n_in))
    scale[1:] = np.sqrt(1.0 / (2.0 * n_in))
    return (mat * scale).astype(np.float32)


def _const(matrix: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(matrix, device=like.device)


def amplitude_to_db(x: torch.Tensor, ref=None) -> torch.Tensor:
    """``librosa.amplitude_to_db(x, ref=np.max, top_db=None)``:
    ``20 log10(max(amin, |x|)) - 20 log10(max(amin, ref))``, ``ref`` the
    largest ``|x|`` of the whole input unless given."""
    x = x.abs()
    if ref is None:
        ref = x.max()
    ref = torch.as_tensor(ref, dtype=x.dtype, device=x.device)
    log_spec = 20.0 * torch.log10(torch.clamp(x, min=_AMIN))
    return log_spec - 20.0 * torch.log10(torch.clamp(ref, min=_AMIN))


def db_to_amplitude(x: torch.Tensor) -> torch.Tensor:
    """``librosa.db_to_amplitude``: ``10 ** (x / 20)``."""
    return torch.pow(10.0, x / 20.0)


def linear_to_mel_spec(S: torch.Tensor, sample_rate: int, n_fft: int,
                       n_mels: int) -> torch.Tensor:
    """Magnitudes ``[..., bins, T]`` onto mel ``[..., n_mels, T]``
    (``librosa.feature.melspectrogram`` with ``S=`` given: no squaring)."""
    fb = _const(mel_filterbank(sample_rate, n_fft, n_mels), S)
    return torch.matmul(fb, S)


def mel_to_linear_nnls(M: torch.Tensor, sample_rate: int, n_fft: int,
                       n_mels: int, n_iter: int = 50) -> torch.Tensor:
    """Approximate inverse mel projection ``[..., n_mels, T]`` ->
    ``[..., bins, T]`` by the multiplicative-update NNLS
    ``x <- x * (A^T b) / (A^T A x)`` from ``max(A^T b, 1e-10)``, as the
    JAX package runs it (a sequence of matrix products)."""
    A = _const(mel_filterbank(sample_rate, n_fft, n_mels), M)  # [m, bins]
    At_b = torch.matmul(A.T, M)                                 # [bins, T]
    AtA = A.T @ A                                               # [bins, bins]
    x = torch.clamp(At_b, min=1e-10)
    for _ in range(n_iter):
        x = x * At_b / torch.clamp(torch.matmul(AtA, x), min=1e-10)
    return x


def mfcc_from_db_mel(S_db_mel: torch.Tensor, n_mfcc: int) -> torch.Tensor:
    """MFCCs ``[..., n_mfcc, T]`` of a dB mel spectrogram ``[..., n_mels,
    T]`` (``librosa.feature.mfcc(S=...)``: the ortho DCT-II over mels)."""
    D = _const(dct_matrix(n_mfcc, S_db_mel.shape[-2]), S_db_mel)
    return torch.matmul(D, S_db_mel)
