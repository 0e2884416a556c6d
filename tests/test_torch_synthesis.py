"""The port's whole serving slice against the JAX ``Synthesizer``.

Both run on the CPU in float32 with prenet dropout 0 and exact gates, on the
same numpy-seeded weights: encode, chunked decode with the stop-token early
exit and per-sample crop, batched postnet, denormalization.
"""

import functools

import numpy as np
import pytest

from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from tests.torch_port_utils import (
    batch,
    jax_variables,
    port_hp,
    tiny_hp,
    variables_np,
)


def _hp():
    return tiny_hp(max_output_length=32, decode_chunk_frames=8)


@functools.lru_cache(maxsize=None)
def _synthesizers(stop_bias):
    hp = _hp()
    v_np = variables_np(stop_bias)
    return (Synthesizer(hp, jax_variables(v_np)),
            PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                            device="cpu"))


def _inputs(mixed):
    hp = _hp()
    text, lengths, speakers = batch(hp, 5, 14, seed=11)
    seqs = [text[i, :lengths[i]] for i in range(5)]
    langs = [0, 1, 1, 0, 1]
    weights = []
    for i, seq in enumerate(seqs):
        w = np.zeros((1, len(seq), 2), np.float32)
        w[0, :, langs[i]] = 1.0
        if mixed and i == 2:
            w[0, :, 0], w[0, :, 1] = 0.3, 0.7
        weights.append(w)
    return seqs, [int(s) for s in speakers], weights


@pytest.mark.parametrize("mixed", [False, True])
def test_spectrograms_from_batch_matches_jax(mixed):
    """Stop bias -10 (nobody stops): all 32 frames, denormalized
    spectrograms within rtol 1e-3 on the row-group (one-hot) and the
    mixing (one blend in the batch) encode paths."""
    jax_syn, port_syn = _synthesizers(-10.0)
    args = _inputs(mixed)
    ref = jax_syn.spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (20, 32)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)


def test_stop_token_crop_matches_jax():
    """Stop bias +10: everybody stops at the first frame, and both crop to
    ``1 + stop_frames`` frames."""
    jax_syn, port_syn = _synthesizers(10.0)
    args = _inputs(False)
    ref = jax_syn.spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    hp = _hp()
    assert [g.shape for g in got] == [r.shape for r in ref]
    assert all(g.shape[1] == 1 + hp.stop_frames for g in got)


def test_blend_with_zero_weight_equals_pure_line():
    """``de*1.0:fr*0.0`` is the pure ``de`` line, bit for bit."""
    _, port_syn = _synthesizers(-10.0)
    pure = port_syn.synthesize_batch_lines(
        ["a|hallo welt|s1|de", "b|bonjour|s2|fr"])
    blend = port_syn.synthesize_batch_lines(
        ["a|hallo welt|s1|de*1.0:fr*0.0", "b|bonjour|s2|fr"])
    for p, b in zip(pure, blend):
        np.testing.assert_array_equal(p, b)


def test_spectrogram_from_ids_matches_jax():
    jax_syn, port_syn = _synthesizers(-10.0)
    seqs, speakers, weights = _inputs(False)
    ref = jax_syn.spectrogram_from_ids(seqs[1], speakers[1], weights[1])
    got = port_syn.spectrogram_from_ids(seqs[1], speakers[1], weights[1])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_synthesizer_honours_use_pallas_decoder():
    """``hp.use_pallas_decoder = False`` with ``pallas_decoder_int8`` at
    True: the JAX ``Synthesizer`` decodes on its XLA scan, whose gates are
    exact, and so does the port (its decode kernels without W8A8 or int8
    streams): every spectrogram within rtol 1e-3, atol 1e-4.  The same port
    with the W8A8 gates that the setting turns off misses that bound: the
    switch changes the output, and the port follows it."""
    hp = tiny_hp(max_output_length=16, decode_chunk_frames=8,
                 pallas_decoder_int8=True, pallas_decoder_int8_streams=True,
                 use_pallas_decoder=False)
    v_np = variables_np(-10.0)
    jax_syn = Synthesizer(hp, jax_variables(v_np))
    port_syn = PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                               device="cpu")
    assert not port_syn.bundle.quantized and not port_syn.bundle.q_streams
    seqs, speakers, weights = _inputs(False)
    args = (seqs[:3], speakers[:3], weights[:3])
    ref = jax_syn.spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (hp.num_mels, 16)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)

    port_syn.bundle = fused_decoder.extract_decoder_bundle(
        port_syn.model.decoder.cell, port_syn.dtype, quantize_gates=True)
    w8a8 = port_syn.spectrograms_from_batch(*args)
    assert not all(np.allclose(o, r, rtol=1e-3, atol=1e-4)
                   for o, r in zip(w8a8, ref))
