"""The port's evaluation metrics against the JAX package's, on the CPU.

``ops.dtw.dtw_path`` (the C library of ``native`` and the numpy version a
machine without a compiler runs) and ``ops.audio.mel_cepstral_distortion``
in its three modes, on seeded inputs.  Paths are compared exactly; MCDs
within rtol 1e-5 (MFCCs through torch on the CPU against jnp, float32 in
another order; read about 1e-7).
"""

import os

import numpy as np
import pytest

from multilingual_text_to_speech_tpu import native as jax_native
from multilingual_text_to_speech_tpu.config import HParams as JaxHParams
from multilingual_text_to_speech_tpu.ops import audio as jax_audio
from multilingual_text_to_speech_tpu.ops import dtw as jax_dtw
from multilingual_text_to_speech_tpu_torch import native
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.ops import audio, dtw

SHAPES = [(1, 1, 3), (7, 7, 1), (12, 31, 12), (40, 25, 12), (64, 64, 5)]


def _frames(t1, t2, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t1, d).astype(np.float32)
    # y: x warped in time plus noise, so that the path is not the diagonal
    idx = np.sort(rng.randint(0, t1, t2))
    y = (x[idx] + 0.1 * rng.randn(t2, d)).astype(np.float32)
    return x, y


def test_native_library_builds_into_the_checkout():
    assert native.native_dtw_available()
    lib = native._target()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    root = native.BUILD_DIR.parents[1]
    assert os.path.isdir(root / "multilingual_text_to_speech_tpu_torch")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_native_dtw_matches_jax(shape):
    x, y = _frames(*shape, seed=sum(shape))
    ref = jax_native.dtw_path_native(x, y)
    got = native.dtw_path_native(x, y)
    assert ref is not None and got is not None
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    for r, g in zip(jax_dtw.dtw_path(x, y), dtw.dtw_path(x, y)):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_numpy_dtw_matches_jax(shape, monkeypatch):
    """Without the C library (a machine without a compiler) both packages
    run their numpy DTW: the same path, and the C library's."""
    x, y = _frames(*shape, seed=sum(shape) + 1)
    monkeypatch.setattr(jax_native, "dtw_path_native", lambda x, y: None)
    monkeypatch.setattr(native, "dtw_path_native", lambda x, y: None)
    ref = jax_dtw.dtw_path(x, y)
    got = dtw.dtw_path(x, y)
    monkeypatch.undo()
    c_path = dtw.dtw_path(x, y)
    for r, g, c in zip(ref, got, c_path):
        assert np.array_equal(g, r) and np.array_equal(g, c)
    # a monotone path from (0, 0) to the two ends
    px, py = got
    assert (px[0], py[0]) == (0, 0)
    assert (px[-1], py[-1]) == (shape[0] - 1, shape[1] - 1)
    assert (np.diff(px) >= 0).all() and (np.diff(py) >= 0).all()


def test_dtw_path_optimal_on_a_simple_case():
    """``tests/test_audio.py``'s golden: a repeated frame aligns at zero
    cost."""
    x = np.array([[0.0], [1.0], [2.0]])
    y = np.array([[0.0], [0.0], [1.0], [2.0]])
    px, py = dtw.dtw_path(x, y)
    assert (px[-1], py[-1]) == (2, 3)
    assert np.abs(x[px] - y[py]).sum() == pytest.approx(0.0)


def _mels(f1, f2, seed):
    """dB mel spectrograms of two related waveforms' lengths: noise around
    a shared envelope, [80, F]."""
    rng = np.random.RandomState(seed)
    base = -40.0 + 10.0 * rng.randn(80, 1)
    s1 = (base + 5.0 * rng.randn(80, f1)).astype(np.float32)
    s2 = (base + 5.0 * rng.randn(80, f2)).astype(np.float32)
    return s1, s2


@pytest.mark.parametrize("mode", ["cut", "stretch", "dtw"])
@pytest.mark.parametrize("frames", [(50, 50), (50, 70), (90, 33)], ids=str)
def test_mel_cepstral_distortion_matches_jax(mode, frames):
    s1, s2 = _mels(*frames, seed=frames[0] + frames[1])
    ref = jax_audio.mel_cepstral_distortion(s1, s2, JaxHParams(), mode)
    got = audio.mel_cepstral_distortion(s1, s2, HParams(), mode,
                                        device="cpu")
    assert got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert audio.mel_cepstral_distorision is audio.mel_cepstral_distortion


@pytest.mark.parametrize("mode", ["cut", "stretch", "dtw"])
def test_mel_cepstral_distortion_of_a_spectrogram_with_itself(mode):
    s, _ = _mels(50, 1, seed=3)
    assert audio.mel_cepstral_distortion(
        s, s, HParams(), mode, device="cpu") == pytest.approx(0.0, abs=1e-4)


def test_mel_cepstral_distortion_refuses_an_unknown_mode():
    s, _ = _mels(10, 1, seed=4)
    with pytest.raises(ValueError, match="unknown MCD mode"):
        audio.mel_cepstral_distortion(s, s, HParams(), "warp", device="cpu")
