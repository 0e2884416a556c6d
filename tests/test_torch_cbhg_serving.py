"""The CBHG model's serving entry points in the port against the JAX
package's, on the CPU in float32: ``Synthesizer`` on linear spectrograms
(the postnet's GRU over each sample's cut) and ``vocode`` on them
(Griffin-Lim without the NNLS mel inverse).

Spectrograms within rtol 1e-3, atol 1e-4 (``tests/test_torch_synthesis.py``'s
bounds); the waveform, on the JAX package's initial phases, within
``GL_TOL`` of the peak at 10 Griffin-Lim iterations
(``tests/test_torch_dsp.py``'s).
"""

import functools

import numpy as np
import pytest

from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from tests.test_torch_cbhg import BINS, _variables, cbhg_hp
from tests.test_torch_cli import _jax_phases
from tests.test_torch_dsp import GL_TOL, _close
from tests.torch_port_utils import jax_variables, port_hp



def _syn_hp():
    return cbhg_hp(max_output_length=32, decode_chunk_frames=8)


@functools.lru_cache(maxsize=None)
def _synthesizers(stop_bias):
    hp, v = _syn_hp(), _variables(stop_bias)
    return (Synthesizer(hp, jax_variables(v)),
            PortSynthesizer(port_hp(hp), params_from_jax(v), device="cpu"))


LINES = ["a|hallo welt|s1|de", "b|bonjour tout le monde|s2|fr",
         "c|hallo salut|s0|de-6,fr"]


@pytest.mark.parametrize("stop_bias", [0.5])
def test_synthesizer_matches_jax(stop_bias):
    """Denormalized [552, F_i] linear spectrograms of a batch within rtol
    1e-3, atol 1e-4, the samples stopping at their own frames (stop bias
    0.5), so that the CBHG's GRU runs over cuts of different lengths; and
    one line alone."""
    jax_syn, port_syn = _synthesizers(stop_bias)
    ref = jax_syn.synthesize_batch_lines(LINES, seed=2)
    got = port_syn.synthesize_batch_lines(LINES, seed=2)
    assert [g.shape for g in got] == [r.shape for r in ref]
    assert all(g.shape[0] == BINS for g in got)
    assert len({g.shape[1] for g in got}) > 1
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)
    one = port_syn.synthesize_line(LINES[1], seed=2)
    np.testing.assert_allclose(one, jax_syn.synthesize_line(LINES[1], seed=2),
                               rtol=1e-3, atol=1e-4)


def test_vocode_linear_matches_jax(monkeypatch):
    """``vocode`` of a linear spectrogram (no NNLS) on the JAX package's
    initial phases, 10 Griffin-Lim iterations: the waveform within
    ``GL_TOL`` of the peak, ``hop * (F - 1)`` samples."""
    jax_syn, port_syn = _synthesizers(0.5)
    for syn in (jax_syn, port_syn):
        monkeypatch.setattr(syn.hp, "griffin_lim_iters", 10)
    spec = port_syn.synthesize_batch_lines(LINES, seed=2)[2]
    _jax_phases(monkeypatch, 5)
    got = port_syn.vocode(spec, seed=5)
    assert spec.shape == (BINS, 32) and got.shape == (275 * 31,)
    _close(got, jax_syn.vocode(spec, seed=5), GL_TOL)
