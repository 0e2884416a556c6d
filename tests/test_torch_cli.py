"""The port's serving entry points against the JAX package's, on the CPU:
``Synthesizer.synthesize_line``, ``max_chunks``, ``vocode`` and
``vocode_batch``, and the synthesis CLI run in-process on a checkpoint
that the JAX ``save_checkpoint`` wrote.

Spectrograms within rtol 1e-3, atol 1e-4 (``tests/test_torch_synthesis.py``'s
bounds); waveforms on the JAX package's initial phases (the port's draw
replaced through ``ops.stft.random_angles``) within ``GL_TOL`` of the peak
at 10 Griffin-Lim iterations and by spectral convergence within ``SC_TOL``
at 60 (``tests/test_torch_dsp.py``).
"""

import functools
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from multilingual_text_to_speech_tpu.cli import synthesize as jax_cli
from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu_torch.cli import synthesize as port_cli
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.ops import stft
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from tests.test_torch_checkpoint import _jax_checkpoint
from tests.test_torch_dsp import (
    GL_TOL,
    SC_TOL,
    _close,
    _jax_angles,
    _spectral_convergence,
    _target,
)
from tests.torch_port_utils import jax_variables, port_hp, tiny_hp, variables_np

HOP = 275
LINES = ["a|hallo welt|s1|de", "b|bonjour tout|s2|fr*0.7:de*0.3",
         "c|hallo salut|s0|de-6,fr"]


def _hp(**over):
    return tiny_hp(max_output_length=32, decode_chunk_frames=8, **over)


@functools.lru_cache(maxsize=None)
def _synthesizers(max_chunks=None):
    hp, v_np = _hp(), variables_np(-10.0)
    return (Synthesizer(hp, jax_variables(v_np), max_chunks=max_chunks),
            PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                            device="cpu", max_chunks=max_chunks))


@pytest.mark.parametrize("line", LINES, ids=["pure", "blend", "segments"])
def test_synthesize_line_matches_jax(line):
    jax_syn, port_syn = _synthesizers()
    ref = jax_syn.synthesize_line(line, seed=3)
    got = port_syn.synthesize_line(line, seed=3)
    assert got.shape == ref.shape == (20, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_max_chunks_matches_jax():
    """Two chunks of 8 frames where ``max_output_length`` allows four."""
    jax_syn, port_syn = _synthesizers(max_chunks=2)
    assert port_syn.max_chunks == jax_syn.max_chunks == 2
    assert _synthesizers()[1].max_chunks == 4
    ref = jax_syn.synthesize_line(LINES[0])
    got = port_syn.synthesize_line(LINES[0])
    assert got.shape == ref.shape == (20, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def _jax_phases(monkeypatch, seed):
    """The port's Griffin-Lim starts from the JAX package's draw for
    ``PRNGKey(seed)`` (one key for a spectrogram, split keys for a
    batch)."""
    def angles(shape, generator, device=None):
        key = jax.random.PRNGKey(seed)
        if len(shape) == 2:
            return torch.from_numpy(np.array(_jax_angles(key, tuple(shape))))
        keys = jax.random.split(key, shape[0])
        return torch.from_numpy(np.stack(
            [_jax_angles(k, tuple(shape[1:])) for k in keys]))
    monkeypatch.setattr(stft, "random_angles", angles)


def _vocoder_check(got, ref, spec, n_iter, hp):
    assert got.shape == ref.shape
    if n_iter <= 10:
        _close(got, ref, GL_TOL)
    else:
        target = _target(spec, hp, True)
        sc = [_spectral_convergence(y, target, hp) for y in (got, ref)]
        assert abs(sc[0] - sc[1]) <= SC_TOL, sc


@pytest.mark.parametrize("n_iter", [10, 60])
def test_vocode_matches_jax(monkeypatch, n_iter):
    jax_syn, port_syn = _synthesizers()
    monkeypatch.setattr(jax_syn.hp, "griffin_lim_iters", n_iter)
    monkeypatch.setattr(port_syn.hp, "griffin_lim_iters", n_iter)
    _jax_phases(monkeypatch, 5)
    spec = port_syn.synthesize_line(LINES[1])
    ref = jax_syn.vocode(spec, seed=5)
    got = port_syn.vocode(spec, seed=5)
    assert got.shape == (HOP * (spec.shape[1] - 1),)
    assert np.max(got) == 1.0
    _vocoder_check(got, ref, spec, n_iter, port_syn.hp)


@pytest.mark.parametrize("n_iter", [10, 60])
def test_vocode_batch_matches_jax(monkeypatch, n_iter):
    """Spectrograms of 32 and 20 frames: the shorter padded with -100 dB
    and each waveform cropped to ``hop * (F - 1)``; one frame gives
    ``hop`` samples."""
    jax_syn, port_syn = _synthesizers()
    monkeypatch.setattr(jax_syn.hp, "griffin_lim_iters", n_iter)
    monkeypatch.setattr(port_syn.hp, "griffin_lim_iters", n_iter)
    _jax_phases(monkeypatch, 6)
    full = port_syn.synthesize_batch_lines(LINES[:2], seed=1)
    specs = [full[0], full[1][:, :20], full[0][:, :1]]
    ref = jax_syn.vocode_batch(specs, seed=6)
    got = port_syn.vocode_batch(specs, seed=6)
    assert [len(w) for w in got] == [HOP * 31, HOP * 19, HOP]
    for i, (g, r) in enumerate(zip(got, ref)):
        if n_iter <= 10:
            _close(g, r, GL_TOL)
        elif i < 2:
            # spectral convergence of the cropped waveform on its frames
            _vocoder_check(g, r, specs[i], n_iter, port_syn.hp)


def _run_cli(main, argv, lines, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    main(argv)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, batch_size):
    """The port's CLI with ``--cpu --save_spec`` on a JAX-written
    checkpoint: its ``.npy`` files those of the JAX CLI within rtol 1e-3,
    atol 1e-4; its WAVs ``hop * (F - 1)`` samples, finite, peak at full
    scale."""
    hp, v_np = _hp(griffin_lim_iters=4), variables_np(-10.0)
    ckpt = str(tmp_path / "model.ckpt")
    _jax_checkpoint(ckpt, hp, v_np)
    common = ["--checkpoint", ckpt, "--save_spec", "--seed", "2",
              "--batch_size", str(batch_size)]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_cli(jax_cli.main, common + ["--output", jax_out, "--ignore_wav"],
             LINES, monkeypatch)
    _run_cli(port_cli.main, common + ["--output", port_out, "--cpu"], LINES,
             monkeypatch)
    for line in LINES:
        item = line.split("|")[0]
        ref = np.load(os.path.join(jax_out, f"{item}.npy"))
        got = np.load(os.path.join(port_out, f"{item}.npy"))
        assert got.shape == ref.shape == (20, 32)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
        rate, wav = wavfile.read(os.path.join(port_out, f"{item}.wav"))
        assert rate == hp.sample_rate and wav.dtype == np.int16
        assert wav.shape == (HOP * (got.shape[1] - 1),)
        assert np.abs(wav.astype(np.int32)).max() == 32767
    assert sorted(os.listdir(port_out)) == sorted(
        f"{line.split('|')[0]}.{ext}" for line in LINES
        for ext in ("npy", "wav"))


def test_cli_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    """Without ``--cpu`` the CLI runs on the card, and without one it
    raises: no quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    hp, v_np = _hp(), variables_np(-10.0)
    ckpt = str(tmp_path / "model.ckpt")
    _jax_checkpoint(ckpt, hp, v_np)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_cli(port_cli.main, ["--checkpoint", ckpt, "--output",
                                 str(tmp_path / "out")], LINES[:1],
                 monkeypatch)
