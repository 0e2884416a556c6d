"""The port's DSP (``ops/{stft,mel,io,audio}.py``) against the JAX
package's, on the CPU, at the flagship's audio settings (22,050 Hz, n_fft
1102, window 1102, hop 275, 80 mels, Griffin-Lim power 1.5, pre-emphasis
0.97) on at most 2 s of numpy-seeded signal.

Bounds:
- transforms (``stft``, ``istft``, the mel projections, NNLS, MFCCs):
  within 1e-5 of each output's largest magnitude;
- ``spectrogram``: its amplitudes ``10 ** (dB / 20)`` within 1e-5 of the
  largest (1, the dB reference): two float32 FFTs differ by about 1e-7 of
  the peak, which is a tenth of a dB in bins 100 dB down;
- Griffin-Lim (``griffin_lim``, ``inverse_spectrogram``,
  ``inverse_spectrogram_batch``) on the JAX package's initial phases:
  element-wise within ``GL_TOL`` (1e-3, ``chip_smoke.py``, which holds the
  card against the CPU by the same bounds) of the peak at 0, 2 and 10
  iterations
  (float32 differences grow through the momentum: measured up to 7.3e-5
  at 10); at 60 iterations, where they reach a few 1e-3, by spectral
  convergence, each output's within ``SC_TOL`` (1e-4) of the other's
  (measured 1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from chip_smoke import GL_TOL, SC_TOL
from multilingual_text_to_speech_tpu.config import HParams
from multilingual_text_to_speech_tpu.ops import audio as jax_audio
from multilingual_text_to_speech_tpu.ops import io as jax_io
from multilingual_text_to_speech_tpu.ops import mel as jax_mel
from multilingual_text_to_speech_tpu.ops import stft as jax_stft
from multilingual_text_to_speech_tpu_torch.config import HParams as PortHParams
from multilingual_text_to_speech_tpu_torch.ops import audio, io, mel, stft

N_FFT, HOP, WIN = 1102, 275, 1102
REL_TOL = 1e-5      # transforms: of each output's largest magnitude


def _hp(**over):
    hp, php = HParams(), PortHParams()
    for k, v in over.items():
        setattr(hp, k, v)
        setattr(php, k, v)
    return hp, php


@functools.lru_cache(maxsize=None)
def _signal(seconds=1.5, seed=0):
    """Two chirping tones and noise at 22,050 Hz."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 22050)) / 22050
    y = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 1330 * t * (1 + 0.1 * t))
         + 0.05 * rng.randn(len(t)))
    return y.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) / scale if ref.size else 0.0
    assert err <= tol, f"max error {err:.3g} of the largest > {tol}"


def _jax_angles(key, shape):
    return np.asarray(jnp.exp(2j * jnp.pi * jax.random.uniform(key, shape))
                      .astype(jnp.complex64))


# ---------------------------------------------------------------------------
# ops/stft.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win", [1102, 800, 7])
def test_window_and_padding(win):
    np.testing.assert_allclose(stft.hann_window(win).numpy(),
                               np.asarray(jax_stft.hann_window(win)),
                               rtol=0, atol=1e-7)
    w = stft.pad_center(stft.hann_window(win), N_FFT).numpy()
    np.testing.assert_allclose(
        w, np.asarray(jax_stft.pad_center(jax_stft.hann_window(win), N_FFT)),
        rtol=0, atol=1e-7)


@pytest.mark.parametrize("n", [1, 5, 300, 551, 552, 1102, 33075])
def test_frames(n):
    """Framing with centred reflect padding, also of signals shorter than
    the padding (numpy's reflect repeats)."""
    y = np.random.RandomState(n).randn(n).astype(np.float32)
    ref = np.asarray(jax_stft.frame_signal(jnp.asarray(y), N_FFT, HOP))
    got = stft.frame_signal(_t(y), N_FFT, HOP).numpy()
    np.testing.assert_array_equal(got, ref)
    assert stft.num_frames(n, N_FFT, HOP) == jax_stft.num_frames(
        n, N_FFT, HOP) == ref.shape[0]
    if n >= 64:
        got = stft.frame_signal(_t(y), 64, 16, center=False).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jax_stft.frame_signal(jnp.asarray(y), 64, 16, center=False)))


@pytest.mark.parametrize("n,win", [(300, 1102), (2205, 1102),
                                   (33075, 1102), (22050, 900)])
def test_stft_istft(n, win):
    y = _signal()[:n]
    ref = np.asarray(jax_stft.stft(jnp.asarray(y), N_FFT, HOP, win))
    got = stft.stft(_t(y), N_FFT, HOP, win).numpy()
    assert got.dtype == np.complex64
    _close(got, ref)
    ref_y = np.asarray(jax_stft.istft(jnp.asarray(ref), N_FFT, HOP, win))
    got_y = stft.istft(_t(ref), N_FFT, HOP, win).numpy()
    _close(got_y, ref_y)
    got_l = stft.istft(_t(ref), N_FFT, HOP, win, length=n // 2).numpy()
    _close(got_l, np.asarray(jax_stft.istft(jnp.asarray(ref), N_FFT, HOP,
                                            win, length=n // 2)))


def test_stft_istft_batched():
    """A batch of signals is each signal alone."""
    y = np.stack([_signal()[:5000], _signal(seed=1)[:5000]])
    spec = stft.stft(_t(y), N_FFT, HOP)
    for i in range(2):
        torch.testing.assert_close(spec[i], stft.stft(_t(y[i]), N_FFT, HOP))
    back = stft.istft(spec, N_FFT, HOP)
    for i in range(2):
        torch.testing.assert_close(back[i], stft.istft(spec[i], N_FFT, HOP))


def _magnitudes(frames=120, seed=3):
    return np.abs(np.random.RandomState(seed).randn(
        N_FFT // 2 + 1, frames)).astype(np.float32)


@pytest.mark.parametrize("n_iter", [0, 2, 10])
def test_griffin_lim_elementwise(n_iter):
    mag = _magnitudes()
    key = jax.random.PRNGKey(n_iter)
    ref = np.asarray(jax_stft.griffin_lim(jnp.asarray(mag), key, N_FFT, HOP,
                                          WIN, n_iter=n_iter))
    got = stft.griffin_lim(_t(mag), N_FFT, HOP, WIN, n_iter=n_iter,
                           angles=_t(_jax_angles(key, mag.shape))).numpy()
    _close(got, ref, GL_TOL)


def test_griffin_lim_spectral_convergence():
    """60 iterations: each output's spectral convergence within SC_TOL of
    the other's, and better than after 10."""
    mag = _magnitudes()
    key = jax.random.PRNGKey(60)
    ref = np.asarray(jax_stft.griffin_lim(jnp.asarray(mag), key, N_FFT, HOP,
                                          WIN, n_iter=60))
    angles = _t(_jax_angles(key, mag.shape))
    got = stft.griffin_lim(_t(mag), N_FFT, HOP, WIN, n_iter=60,
                           angles=angles)
    sc = [float(stft.spectral_convergence(y, _t(mag), N_FFT, HOP, WIN))
          for y in (got, _t(ref))]
    assert abs(sc[0] - sc[1]) <= SC_TOL, sc
    early = stft.griffin_lim(_t(mag), N_FFT, HOP, WIN, n_iter=10,
                             angles=angles)
    assert sc[0] < float(stft.spectral_convergence(early, _t(mag), N_FFT,
                                                   HOP, WIN))


def test_griffin_lim_draws_from_its_generator():
    """The initial phases come from the generator: one seed, one result;
    another seed, another."""
    mag = _t(_magnitudes(frames=20))

    def run(seed):
        return stft.griffin_lim(mag, N_FFT, HOP, n_iter=2,
                                generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(4), run(4), rtol=0, atol=0)
    assert not torch.equal(run(4), run(5))


# ---------------------------------------------------------------------------
# ops/mel.py
# ---------------------------------------------------------------------------

def test_mel_tables_are_the_jax_packages():
    f = np.linspace(0, 11025, 97)
    np.testing.assert_array_equal(mel.hz_to_mel(f), jax_mel.hz_to_mel(f))
    m = np.linspace(0, 40, 97)
    np.testing.assert_array_equal(mel.mel_to_hz(m), jax_mel.mel_to_hz(m))
    for args in ((22050, N_FFT, 80), (16000, 512, 40, 50.0, 7000.0)):
        np.testing.assert_array_equal(mel.mel_filterbank(*args),
                                      jax_mel.mel_filterbank(*args))
    np.testing.assert_array_equal(mel.dct_matrix(13, 80),
                                  jax_mel.dct_matrix(13, 80))


def test_mel_projections():
    rng = np.random.RandomState(5)
    S = np.abs(rng.randn(N_FFT // 2 + 1, 40)).astype(np.float32)
    M = np.asarray(jax_mel.linear_to_mel_spec(jnp.asarray(S), 22050, N_FFT,
                                              80))
    _close(mel.linear_to_mel_spec(_t(S), 22050, N_FFT, 80).numpy(), M)
    ref = np.asarray(jax_mel.mel_to_linear_nnls(jnp.asarray(M), 22050,
                                                N_FFT, 80))
    _close(mel.mel_to_linear_nnls(_t(M), 22050, N_FFT, 80).numpy(), ref)
    db = np.asarray(jax_mel.amplitude_to_db(jnp.asarray(M)))
    _close(mel.amplitude_to_db(_t(M)).numpy(), db)
    _close(mel.amplitude_to_db(_t(M), ref=3.0).numpy(),
           np.asarray(jax_mel.amplitude_to_db(jnp.asarray(M), ref=3.0)))
    _close(mel.db_to_amplitude(_t(db)).numpy(),
           np.asarray(jax_mel.db_to_amplitude(jnp.asarray(db))))
    _close(mel.mfcc_from_db_mel(_t(db), 13).numpy(),
           np.asarray(jax_mel.mfcc_from_db_mel(jnp.asarray(db), 13)))


# ---------------------------------------------------------------------------
# ops/audio.py
# ---------------------------------------------------------------------------

def test_frames_and_emphasis():
    hp, php = _hp()
    assert audio.ms_to_frames(12.5, php) == jax_audio.ms_to_frames(12.5, hp)
    assert audio.duration(_signal(), php) == jax_audio.duration(_signal(), hp)
    y = _signal()
    ref = np.asarray(jax_audio.preemphasis(jnp.asarray(y), 0.97))
    np.testing.assert_allclose(audio.preemphasis(y, 0.97), ref, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(audio.preemphasis(_t(y), 0.97).numpy(), ref,
                               rtol=0, atol=1e-7)


def test_deemphasis():
    """``scipy.signal.lfilter`` on 2 s (the closed form through
    ``coef ** -n`` would overflow there), against the JAX package's
    associative scan, batched, and inverting the pre-emphasis."""
    y = np.concatenate([_signal(), _signal(seed=1)[:11025]])
    got = audio.deemphasis(y, 0.97)
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, scipy.signal.lfilter([1.0], [1.0, -0.97], y).astype(np.float32),
        rtol=0, atol=1e-7)
    scan = jax.jit(jax_audio.deemphasis, static_argnums=1)
    _close(got, np.asarray(scan(jnp.asarray(y), 0.97)))
    both = audio.deemphasis(np.stack([y, 2 * y]), 0.97)
    np.testing.assert_array_equal(both[0], got)
    _close(audio.deemphasis(audio.preemphasis(y)), y)


@pytest.mark.parametrize("use_preemphasis", [True, False])
@pytest.mark.parametrize("kind", ["linear", "mel"])
def test_spectrogram(kind, use_preemphasis):
    hp, php = _hp(use_preemphasis=use_preemphasis)
    y = _signal()
    if kind == "mel":
        ref, got = (jax_audio.mel_spectrogram(y, hp),
                    audio.mel_spectrogram(y, php, device="cpu"))
    else:
        ref, got = (jax_audio.spectrogram(y, hp),
                    audio.spectrogram(y, php, device="cpu"))
    assert got.shape == ref.shape and got.dtype == np.float32
    _close(10 ** (got / 20), 10 ** (ref / 20))


def test_linear_to_mel_and_mfcc():
    hp, php = _hp()
    y = _signal()
    lin = jax_audio.spectrogram(y, hp)
    _close(audio.linear_to_mel(lin, php, device="cpu"),
           jax_audio.linear_to_mel(lin, hp))
    M = jax_audio.mel_spectrogram(y, hp)
    _close(audio.get_spectrogram_mfcc(M, php, device="cpu"),
           jax_audio.get_spectrogram_mfcc(M, hp))
    _close(audio.get_mfcc(y, php, device="cpu"), jax_audio.get_mfcc(y, hp),
           1e-4)


def test_normalization():
    hp, php = _hp(mel_normalize_mean=list(np.linspace(-3, 1, 80)),
                  mel_normalize_variance=list(np.linspace(0.5, 2, 80)))
    S = np.random.RandomState(2).randn(80, 30).astype(np.float32)
    np.testing.assert_array_equal(
        audio.normalize_spectrogram(S, php, True),
        jax_audio.normalize_spectrogram(S, hp, True))
    np.testing.assert_array_equal(
        audio.denormalize_spectrogram(S, php, True),
        jax_audio.denormalize_spectrogram(S, hp, True))
    with pytest.raises(ValueError):
        audio.normalize_spectrogram(S, php, False)


@pytest.mark.parametrize("margin_ms", [0, 10])
def test_trim_silence(margin_ms):
    hp, php = _hp()
    y = np.concatenate([np.zeros(5000, np.float32), _signal()[:8000],
                        1e-6 * np.ones(7000, np.float32)])
    got, span = audio.trim_silence(y, 50, 12.5, php, margin_ms=margin_ms)
    ref, ref_span = jax_audio.trim_silence(y, 50, 12.5, hp,
                                           margin_ms=margin_ms)
    np.testing.assert_array_equal(got, ref)
    assert span == ref_span and 0 < span[0] < span[1] < len(y)


def _target(s_db, hp, mel_in):
    """The magnitudes Griffin-Lim works to: amplitudes, the NNLS inverse of
    mel, to the power."""
    S = mel.db_to_amplitude(_t(s_db))
    if mel_in:
        S = mel.mel_to_linear_nnls(S, hp.sample_rate, hp.num_fft,
                                   hp.num_mels)
    return S ** hp.griffin_lim_power


def _spectral_convergence(y, target, hp):
    """Of a de-emphasized, peak-normalized waveform: pre-emphasis undoes
    the first, the least-squares gain the second."""
    if hp.use_preemphasis:
        y = audio.preemphasis(y, hp.preemphasis)
    return stft.spectral_convergence(_t(y), target, N_FFT, HOP, WIN).numpy()


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    hp, _ = _hp()
    y = _signal()
    return (jax_audio.mel_spectrogram(y, hp) if kind == "mel"
            else jax_audio.spectrogram(y, hp))


@pytest.mark.parametrize("n_iter", [0, 2, 10, 60])
@pytest.mark.parametrize("kind", ["mel", "linear"])
def test_inverse_spectrogram(kind, n_iter):
    hp, php = _hp(griffin_lim_iters=n_iter)
    s_db = _inputs(kind)
    key = jax.random.PRNGKey(11)
    ref = jax_audio.inverse_spectrogram(s_db, hp, mel=kind == "mel",
                                        key=key)
    angles = _t(_jax_angles(key, (N_FFT // 2 + 1, s_db.shape[1])))
    got = audio.inverse_spectrogram(s_db, php, mel=kind == "mel",
                                    angles=angles, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.max(got) == 1.0
    if n_iter <= 10:
        _close(got, ref, GL_TOL)
    else:
        target = _target(s_db, php, kind == "mel")
        sc = [_spectral_convergence(y, target, php) for y in (got, ref)]
        assert abs(sc[0] - sc[1]) <= SC_TOL, sc


@pytest.mark.parametrize("n_iter", [0, 2, 10, 60])
def test_inverse_spectrogram_batch(n_iter):
    """Two mel spectrograms, the second padded with -100 dB as
    ``vocode_batch`` pads, on the JAX package's split keys' phases."""
    hp, php = _hp(griffin_lim_iters=n_iter)
    a = _inputs("mel")
    b = jax_audio.mel_spectrogram(_signal(1.0, seed=4), hp)
    batch = np.full((2, 80, a.shape[1]), -100.0, np.float32)
    batch[0], batch[1, :, :b.shape[1]] = a, b
    key = jax.random.PRNGKey(12)
    ref = jax_audio.inverse_spectrogram_batch(batch, hp, mel=True, key=key)
    shape = (N_FFT // 2 + 1, a.shape[1])
    angles = _t(np.stack([_jax_angles(k, shape)
                          for k in jax.random.split(key, 2)]))
    got = audio.inverse_spectrogram_batch(batch, php, mel=True,
                                          angles=angles, device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.max(axis=1), [1.0, 1.0])
    for i in range(2):
        if n_iter <= 10:
            _close(got[i], ref[i], GL_TOL)
        else:
            target = _target(batch[i], php, True)
            sc = [_spectral_convergence(y[i], target, php)
                  for y in (got, ref)]
            assert abs(sc[0] - sc[1]) <= SC_TOL, sc


def test_inverse_mel_spectrogram_is_the_mel_path():
    _, php = _hp(griffin_lim_iters=2)
    s_db = _inputs("mel")
    np.testing.assert_array_equal(
        audio.inverse_mel_spectrogram(s_db, php, seed=3, device="cpu"),
        audio.inverse_spectrogram(s_db, php, mel=True, seed=3, device="cpu"))


def test_audio_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, php = _hp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio.spectrogram(_signal()[:1000], php)


# ---------------------------------------------------------------------------
# ops/io.py
# ---------------------------------------------------------------------------

def test_wav_round_trips(tmp_path):
    """The port writes the JAX package's bytes, reads what it writes and
    what the JAX package writes, at every PCM width scipy writes."""
    from scipy.io import wavfile

    hp, php = _hp()
    y = 0.8 * _signal()[:4000]
    io.save(y, str(tmp_path / "port.wav"), php)
    jax_io.save(y, str(tmp_path / "jax.wav"), hp)
    assert (tmp_path / "port.wav").read_bytes() == (
        tmp_path / "jax.wav").read_bytes()
    got = io.load(str(tmp_path / "jax.wav"), php)
    np.testing.assert_array_equal(got, jax_io.load(str(tmp_path / "jax.wav"),
                                                   hp))
    np.testing.assert_allclose(got, y, rtol=0, atol=1e-4)
    io.save_wav(4 * y, str(tmp_path / "loud.wav"), 22050)
    assert np.abs(io.load_wav(str(tmp_path / "loud.wav"))).max() == (
        32767 / 32768)
    for dtype, scale in ((np.int32, 2 ** 31 - 1), (np.uint8, None),
                         (np.float32, None)):
        path = str(tmp_path / f"{np.dtype(dtype).name}.wav")
        if dtype == np.uint8:
            data = (128 + 100 * y[:, None].repeat(2, 1)).astype(np.uint8)
        elif scale:
            data = (y * scale).astype(dtype)
        else:
            data = y
        wavfile.write(path, 16000, data)
        got, rate = io.load_wav_with_rate(path)
        ref, ref_rate = jax_io.load_wav_with_rate(path)
        np.testing.assert_array_equal(got, ref)
        assert rate == ref_rate == 16000 and got.ndim == 1
    with pytest.raises(AssertionError):
        io.load_wav(path, 22050)
