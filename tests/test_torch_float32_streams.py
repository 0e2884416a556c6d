"""K1's float32 compute and int8 attention streams: the port against the JAX
package on the CPU.

The JAX serving kernel (``ops/pallas_decoder.py``) runs in interpret mode,
as its own tests run it off the TPU (``fused_decode_chunk(...,
interpret=True)``; ``MTTS_PALLAS_DECODER=interpret`` for its
``Synthesizer``), against the port's plain chunk on the same numpy-seeded
weights and inputs: float32 with W8A8 gates, int8 streams (the kernel's
``q_streams``) in bfloat16 and float32, both attention families, and a
chunk chained through the carry.  The int8 codes and scales of
``chunk_operands`` are bit-exact with ``_quantize_lastdim``, and the W8A8
weights of a float32 bundle with ``extract_decoder_bundle``'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu.ops import pallas_decoder
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
    port_model,
    tiny_hp,
    to_np,
    variables_np,
)

# float32: both sides run every product in float32 and differ by the order
# of their sums (measured up to 1e-6 over two chained chunks): absolute
F32_ATOL = 1e-5
# bfloat16: a rounded intermediate may flip one ulp (2^-8 relative) where
# the two sides sum in another order (measured up to 2.6e-3): relative
# error (norms)
BF16_REL = 1e-2


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@functools.lru_cache(maxsize=None)
def _models(attention_type):
    hp = tiny_hp(attention_type=attention_type)
    v_np = variables_np(attention_type=attention_type)
    return hp, Tacotron(hp, train=False), jax_variables(v_np), port_model(
        hp, v_np)


def _setup(attention_type, b=3, t=16):
    hp, model, variables, port = _models(attention_type)
    text, lengths, speakers = batch(hp, b, t, seed=7)
    langs = np.arange(b, dtype=np.int32) % 2
    memory, mt, mask, carry = jax.jit(functools.partial(
        model.apply, method=Tacotron.encode_for_inference))(
            variables, jnp.asarray(text), jnp.asarray(lengths),
            jnp.asarray(speakers), jnp.asarray(langs))
    return hp, variables, port, (memory, mt, mask), carry


def _torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.as_tensor(np.array(v)),
                                  tree)


def _chunks(attention_type, dtype, int8_gates, streams, steps=(3,)):
    """The JAX kernel in interpret mode and the port's plain chunk, chunk
    after chunk from each side's own carry, prenet dropout 0.5 with the
    same seed pair -> [(jax carry, jax out, port carry, port out)]."""
    hp, variables, port, (memory, mt, mask), carry = _setup(attention_type)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    # the memory and memory transform in the compute type, as a model of
    # that type hands them to the decoder
    memory, mt = memory.astype(jdt), mt.astype(jdt)
    jb = pallas_decoder.extract_decoder_bundle(variables, jdt,
                                               quantize_gates=int8_gates)
    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, dtype, quantize_gates=int8_gates,
        q_streams=streams)
    t_in = (_torch(memory.astype(jnp.float32)).to(dtype),
            _torch(mt.astype(jnp.float32)).to(dtype), _torch(mask))
    kw = dict(dropout_rate=0.5, zoneout_h=hp.zoneout_hidden,
              zoneout_c=hp.zoneout_cell)
    carry_j, carry_p, out = carry, _torch(carry), []
    for i, n in enumerate(steps):
        rng = jax.random.PRNGKey(40 + i)
        carry_j, res_j = pallas_decoder.fused_decode_chunk(
            jb, carry_j, memory, mt, mask, rng, n,
            block_cap=memory.shape[0], interpret=True,
            quantize_streams=streams, **kw)
        bits = np.asarray(jax.random.bits(rng, (1, 1, 2), jnp.uint32))
        carry_p, res_p = fused_decoder.decode_chunk_plain(
            bundle, carry_p, *t_in, (int(bits[0, 0, 0]), int(bits[0, 0, 1])),
            n, **kw)
        out.append((carry_j, res_j, carry_p, res_p))
    return out


def _compare(name, got, ref, dtype):
    got = to_np(got).astype(np.float32)
    ref = np.asarray(ref).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, err_msg=name)
    else:
        assert _rel(got, ref) < BF16_REL, (name, _rel(got, ref))


@pytest.mark.parametrize("attention_type, dtype, int8_gates, streams, steps", [
    ("location_sensitive", torch.float32, True, False, (3,)),
    ("location_sensitive", torch.float32, True, True, (3, 5)),
    ("location_sensitive", torch.bfloat16, True, True, (3,)),
    ("forward_transition_agent", torch.float32, False, True, (3,)),
], ids=["f32-w8a8", "f32-w8a8-q8-chained", "bf16-w8a8-q8",
        "fwd_trans-f32-q8"])
def test_plain_chunk_matches_interpret_kernel(attention_type, dtype,
                                              int8_gates, streams, steps):
    """The port's plain chunk against the JAX kernel in interpret mode on
    the same operands, chunk after chunk (``steps`` a chunk) from each
    side's own carry: spec, stop, context and the carried weights (and
    t_prob) within F32_ATOL in float32, within BF16_REL (relative, norms)
    in bfloat16."""
    for i, (carry_j, (spec_j, stop_j), carry_p, (spec_p, stop_p)) in (
            enumerate(_chunks(attention_type, dtype, int8_gates, streams,
                              steps))):
        _compare(f"chunk {i} spec", spec_p, spec_j, dtype)
        _compare(f"chunk {i} stop", stop_p, stop_j, dtype)
        _compare(f"chunk {i} context", carry_p["context"],
                 carry_j["context"], dtype)
        assert set(carry_p["att_state"]) == set(carry_j["att_state"])
        for k in carry_j["att_state"]:
            _compare(f"chunk {i} {k}", carry_p["att_state"][k],
                     carry_j["att_state"][k], dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [16, 300])
def test_chunk_operands_quantize_as_jax(dtype, t):
    """``chunk_operands``' int8 streams against ``_quantize_lastdim`` as
    ``fused_decode_chunk`` applies it, bit for bit: the memory in the
    compute type and ``mt + bias`` in float32, each per channel over the
    whole batch; the memory transform's scale row in the compute type.  At
    T=300 the JAX kernel pads T to 384 first, and its padded rows of ``mt +
    bias`` (the bias alone) join the amax: channel 0 of ``mt`` nearly
    cancels its bias, so there the padding sets the scale.  Channel 0 of
    the memory is zero everywhere (the 1e-8 floor of the scale)."""
    port = _models("location_sensitive")[3]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.RandomState(t)
    memory = rng.randn(4, t, 12).astype(np.float32)
    memory[..., 0] = 0.0
    bias = rng.randn(8).astype(np.float32)
    mt = (rng.randn(4, t, 8) * 0.01).astype(np.float32)
    mt[..., 0] = -bias[0] + mt[..., 0] * 0.1
    mem_j, mt_j = jnp.asarray(memory).astype(jdt), jnp.asarray(mt).astype(jdt)
    t_pad = pallas_decoder._padded_t(t)
    mt_pad = jnp.pad(mt_j, ((0, 0), (0, t_pad - t), (0, 0)))
    q_m, s_m = pallas_decoder._quantize_lastdim(mem_j)
    q_t, s_t = pallas_decoder._quantize_lastdim(
        mt_pad.astype(jnp.float32) + jnp.asarray(bias)[None])

    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, dtype, quantize_gates=True, q_streams=True)
    bundle.att_bias = torch.as_tensor(bias)
    got_m, got_t, _ = fused_decoder.chunk_operands(
        bundle, torch.as_tensor(memory).to(dtype),
        torch.as_tensor(mt).to(dtype), torch.ones(4, t, dtype=torch.bool))
    np.testing.assert_array_equal(to_np(got_m.q), np.asarray(q_m))
    np.testing.assert_array_equal(to_np(got_m.scale), np.asarray(s_m)[0, 0])
    np.testing.assert_array_equal(to_np(got_t.q), np.asarray(q_t)[:, :t])
    assert got_t.scale.dtype == dtype
    np.testing.assert_array_equal(
        to_np(got_t.scale.float()),
        np.asarray(s_t.astype(jdt).astype(jnp.float32))[0, 0])


def test_float32_bundle_from_jax_weights():
    """A float32 W8A8 bundle built from ``params_from_jax`` weights against
    JAX's ``extract_decoder_bundle(variables, jnp.float32,
    quantize_gates=True)``: the int8 gate weights and their column scales
    bit for bit (the JAX rows padded per segment to 128, the port's
    contiguous), every other weight the same float32 values."""
    hp, _, variables, port = _models("location_sensitive")
    jb = pallas_decoder.extract_decoder_bundle(variables, jnp.float32,
                                               quantize_gates=True)
    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, torch.float32, quantize_gates=True)
    p_dim, mem_dim = hp.prenet_dimension, port.decoder.memory_dim
    hidden = hp.decoder_dimension

    def unpad(w, widths):
        parts, off = [], 0
        for n in widths:
            parts.append(w[off:off + n])
            off += -(-n // 128) * 128
        return np.concatenate(parts, 0)

    for which, widths in (("att", (p_dim, mem_dim, hidden)),
                          ("gen", (hidden, mem_dim, hidden))):
        w_j = unpad(np.asarray(jb[f"{which}_w"]), widths)       # [K, 4H]
        w_p = to_np(getattr(bundle, f"{which}_w"))
        assert w_p.dtype == np.int8
        np.testing.assert_array_equal(w_p[:, :w_j.shape[0]].T, w_j)
        assert not w_p[:, w_j.shape[0]:].any()
        np.testing.assert_array_equal(to_np(getattr(bundle, f"{which}_ws")),
                                      np.asarray(jb[f"{which}_ws"])[0])
    assert bundle.wq.dtype == bundle.head_w.dtype == torch.float32
    np.testing.assert_array_equal(to_np(bundle.wq), np.asarray(jb["wq"]))
    head_j = unpad(np.asarray(jb["head_w"]), (hidden, mem_dim))
    np.testing.assert_array_equal(
        to_np(bundle.head_w)[:, :head_j.shape[0]].T, head_j)


def test_synthesizer_honours_int8_streams(monkeypatch):
    """``hp.pallas_decoder_int8_streams = True``: the port's CPU
    ``Synthesizer`` against the JAX ``Synthesizer`` whose fused decoder runs
    in interpret mode with the int8 streams (``MTTS_PALLAS_DECODER=
    interpret``), float32, W8A8, two chunks of 8 frames: every
    spectrogram within rtol 1e-3, atol 1e-4 (the serving slice's bound).
    The same port without the streams misses that bound: the switch
    changes the output, and the port follows it."""
    monkeypatch.setenv("MTTS_PALLAS_DECODER", "interpret")
    hp = tiny_hp(max_output_length=16, decode_chunk_frames=8,
                 pallas_decoder_int8=True, pallas_decoder_int8_streams=True)
    v_np = variables_np(-10.0)
    jax_syn = Synthesizer(hp, jax_variables(v_np))
    port_syn = PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                               device="cpu")
    assert port_syn.bundle.q_streams
    text, lengths, speakers = batch(hp, 3, 13, seed=11)
    seqs = [text[i, :lengths[i]] for i in range(3)]
    weights = []
    for i, seq in enumerate(seqs):
        w = np.zeros((1, len(seq), 2), np.float32)
        w[0, :, i % 2] = 1.0
        weights.append(w)
    args = (seqs, [int(s) for s in speakers], weights)
    ref = jax_syn.spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (hp.num_mels, 16)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)

    port_syn.bundle.q_streams = False
    off = port_syn.spectrograms_from_batch(*args)
    assert not all(np.allclose(o, r, rtol=1e-3, atol=1e-4)
                   for o, r in zip(off, ref))
