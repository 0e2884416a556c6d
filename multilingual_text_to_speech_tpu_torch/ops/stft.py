"""Short-time Fourier transform, its inverse and Griffin-Lim, in PyTorch.

Port of the JAX package's ``ops/stft.py`` with its semantics kept exactly
(those of ``librosa.stft``/``istft``): a periodic Hann window zero-padded
to ``n_fft`` at its centre, ``center=True`` reflect padding, an overlap-add
inverse normalized by the squared-window sum wherever that sum exceeds
1e-9.  Every function takes a batch in its leading dimensions and runs on
the tensors' device (cuFFT on the card).

The frames are one gather whose index folds in the reflect padding (the
padding of a signal shorter than ``n_fft // 2`` reflects again, as numpy's
does); the overlap-add is ``F.fold``, which sums each output sample over
its frames in one pass with no atomics, so a run on the card repeats bit
for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic (fftbins=True) Hann window, as
    ``scipy.signal.get_window('hann', n)``."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def pad_center(window: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad a window symmetrically up to ``size``
    (``librosa.util.pad_center``)."""
    n = window.shape[0]
    lpad = (size - n) // 2
    return F.pad(window, (lpad, size - n - lpad))


def num_frames(length: int, n_fft: int, hop_length: int,
               center: bool = True) -> int:
    """Number of STFT frames for a signal of ``length`` samples."""
    if center:
        length = length + n_fft  # n_fft//2 padding on both sides
    return 1 + (length - n_fft) // hop_length


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices into a signal of ``n`` samples reflected at both ends
    without repeating the edge, periodically past one reflection (numpy's
    ``mode="reflect"``)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True, pad_mode: str = "reflect"
                 ) -> torch.Tensor:
    """Overlapping frames ``[..., frames, n_fft]`` of signals ``[..., n]``."""
    n = y.shape[-1]
    pad = n_fft // 2 if center else 0
    frames = 1 + (n + 2 * pad - n_fft) // hop_length
    idx = (torch.arange(frames, device=y.device)[:, None] * hop_length
           + torch.arange(n_fft, device=y.device)[None, :] - pad)
    if center:
        if pad_mode != "reflect":
            raise ValueError(f"unsupported pad_mode {pad_mode!r}")
        idx = _reflect(idx, n)
    return y[..., idx]


def stft(y: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT ``[..., 1 + n_fft//2, frames]`` (librosa layout)."""
    if win_length is None:
        win_length = n_fft
    window = pad_center(hann_window(win_length, y.dtype, y.device), n_fft)
    frames = frame_signal(y, n_fft, hop_length, center, pad_mode)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1).transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """``[B, frames, n_fft]`` -> ``[B, n_fft + hop * (frames - 1)]``, each
    frame added in at offset ``i * hop``."""
    b, count, n_fft = frames.shape
    total = n_fft + hop_length * (count - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(b, total)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add with squared-window
    normalization: ``[..., bins, frames]`` complex -> ``[..., samples]``."""
    if win_length is None:
        win_length = n_fft
    window = pad_center(hann_window(win_length, torch.float32, spec.device),
                        n_fft)
    lead, count = spec.shape[:-2], spec.shape[-1]
    ytmp = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    y = _overlap_add(ytmp.reshape(-1, count, n_fft), hop_length)
    norm = _overlap_add((window * window).expand(1, count, n_fft),
                        hop_length)[0]
    ok = norm > 1e-9
    y = torch.where(ok, y / torch.where(ok, norm, torch.ones_like(norm)), y)
    total = y.shape[-1]
    if center:
        y = y[:, n_fft // 2: total - n_fft // 2]
    if length is not None:
        y = y[:, :length]
    return y.reshape(*lead, y.shape[-1])


def random_angles(shape, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """Unit phases ``exp(2 pi i u)``, ``u`` uniform in [0, 1) drawn from
    ``generator`` (a generator on ``device``), complex64."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.exp(2j * math.pi * u.to(torch.complex64))


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None, n_iter: int = 60,
                momentum: float = 0.99,
                generator: Optional[torch.Generator] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction with momentum (``librosa.
    griffinlim``'s update): ``[..., bins, frames]`` magnitudes ->
    ``[..., samples]``.

    The initial phases are ``angles`` (complex, the magnitudes' shape) when
    given, else drawn by ``random_angles`` from ``generator``, which must
    live on the magnitudes' device (a generator seeded 0 there when None).
    A torch generator cannot reproduce the JAX package's keys, so a
    comparison with it passes the JAX draw in as ``angles``."""
    if win_length is None:
        win_length = n_fft
    magnitude = magnitude.to(torch.float32)
    if angles is None:
        if generator is None:
            generator = torch.Generator(magnitude.device).manual_seed(0)
        angles = random_angles(magnitude.shape, generator, magnitude.device)
    angles = angles.to(device=magnitude.device, dtype=torch.complex64)
    rebuilt_prev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(magnitude * angles, n_fft, hop_length, win_length)
        rebuilt = stft(inverse, n_fft, hop_length, win_length)
        angles = rebuilt - (momentum / (1.0 + momentum)) * rebuilt_prev
        angles = angles / (angles.abs() + 1e-16)
        rebuilt_prev = rebuilt
    return istft(magnitude * angles, n_fft, hop_length, win_length)


def spectral_convergence(y: torch.Tensor, magnitude: torch.Tensor,
                         n_fft: int, hop_length: int,
                         win_length: Optional[int] = None) -> torch.Tensor:
    """``|| g |STFT(y)| - S || / || S ||`` of each signal ``[..., n]``
    against its target magnitudes ``S`` ``[..., bins, frames]``, with ``g``
    the least-squares gain (so a rescaled output scores as the output):
    how far a Griffin-Lim result is from consistency with its target."""
    x = stft(y, n_fft, hop_length, win_length).abs()
    s = magnitude.to(x.dtype)
    frames = min(x.shape[-1], s.shape[-1])
    x, s = x[..., :frames], s[..., :frames]
    dims = (-2, -1)
    g = (x * s).sum(dims, keepdim=True) / (x * x).sum(dims, keepdim=True)
    return (g * x - s).norm(dim=dims) / s.norm(dim=dims)
