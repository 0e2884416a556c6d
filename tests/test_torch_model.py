"""The PyTorch port's modules against the JAX package on the same weights.

Everything runs on the CPU in float32: the port's plain PyTorch paths against
the JAX package's XLA paths (and its Pallas decoder kernel in interpret
mode).  Inputs and weights are made from numpy seeds and handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu.ops import pallas_decoder
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder
from tests.torch_port_utils import (
    batch,
    jax_variables,
    port_model,
    tiny_hp,
    to_np,
    variables_np,
)


@functools.lru_cache(maxsize=None)
def _models(prenet_layers=2):
    hp = tiny_hp(prenet_layers=prenet_layers)
    v_np = variables_np(prenet_layers=prenet_layers)
    return hp, Tacotron(hp, train=False), jax_variables(v_np), port_model(hp, v_np)


def _jax_encode(model, variables, *args, **kw):
    return jax.jit(functools.partial(
        model.apply, method=Tacotron.encode_for_inference),
        static_argnames=())(variables, *args, **kw)


@pytest.mark.parametrize("shape", [(3, 1, 2), (6, 24, 8), (5, 33, 257)])
def test_rand_bits_bit_exact(shape):
    """The port's int64 lowbias32 hash equals the JAX package's uint32
    ``_rand_bits`` bit for bit, over seeds, salts and shapes."""
    rng = np.random.RandomState(shape[1])
    for _ in range(shape[0]):
        seed0, seed1 = (int(s) for s in rng.randint(0, 2 ** 32, 2,
                                                    dtype=np.uint64))
        salt = int(rng.randint(0, 5000))
        ref = pallas_decoder._rand_bits(
            shape[1:], jnp.uint32(seed0), jnp.uint32(seed1),
            jnp.asarray(salt, jnp.int32))
        got = fused_decoder.rand_bits(shape[1:], seed0, seed1, salt)
        np.testing.assert_array_equal(to_np(got).astype(np.uint32),
                                      np.asarray(ref))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("path", ["row_groups", "mixing"])
def test_encode_for_inference_matches_jax(path, padded):
    """(memory, memory_transform, mask, carry) at atol 1e-5, on both encode
    paths, at the exact length and bucket-padded with zeros."""
    hp, model, variables, port = _models()
    b, t = 4, 11
    text, lengths, speakers = batch(hp, b, t, seed=3)
    if padded:
        text = np.pad(text, ((0, 0), (0, 13)))
    langs = np.array([0, 0, 1, 1], np.int32)
    if path == "row_groups":
        group = np.array([0, 1], np.int32)
        ref = _jax_encode(model, variables, jnp.asarray(text),
                          jnp.asarray(lengths), jnp.asarray(speakers),
                          jnp.asarray(langs), group_langs=jnp.asarray(group))
        got = port.encode_for_inference(
            torch.as_tensor(text), torch.as_tensor(lengths),
            torch.as_tensor(speakers).long(), torch.as_tensor(langs),
            group_langs=torch.as_tensor(group))
    else:
        w = np.random.RandomState(5).uniform(
            0.0, 1.0, (b, text.shape[1], 2)).astype(np.float32)
        ref = _jax_encode(model, variables, jnp.asarray(text),
                          jnp.asarray(lengths), jnp.asarray(speakers),
                          jnp.asarray(w))
        got = port.encode_for_inference(
            torch.as_tensor(text), torch.as_tensor(lengths),
            torch.as_tensor(speakers).long(), torch.as_tensor(w))
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-5)
    for key in ("h_att", "c_att", "h_gen", "c_gen", "context", "frame"):
        np.testing.assert_array_equal(to_np(got[3][key]),
                                      np.asarray(ref[3][key]))
    np.testing.assert_array_equal(to_np(got[3]["att_state"]["weights"]),
                                  np.asarray(ref[3]["att_state"]["weights"]))


def test_mixing_one_hot_equals_row_groups():
    """In the port, one-hot weights through the mixing path give the
    row-group result (atol 1e-5)."""
    hp, _, _, port = _models()
    text, lengths, speakers = batch(hp, 4, 9, seed=4)
    args = (torch.as_tensor(text), torch.as_tensor(lengths),
            torch.as_tensor(speakers).long())
    langs = torch.tensor([0, 0, 1, 1])
    rows = port.encode_for_inference(*args, langs,
                                     group_langs=torch.tensor([0, 1]))
    one_hot = torch.nn.functional.one_hot(langs[:, None].expand(-1, 9),
                                          2).float()
    mixed = port.encode_for_inference(*args, one_hot)
    for r, m in zip(rows[:2], mixed[:2]):
        np.testing.assert_allclose(to_np(m), to_np(r), atol=1e-5)


def _decode_setup(b=4, t=12, prenet_layers=2):
    hp, model, variables, port = _models(prenet_layers)
    text, lengths, speakers = batch(hp, b, t, seed=7)
    langs = np.array([0, 1] * (b // 2), np.int32)
    memory, mt, mask, carry = _jax_encode(
        model, variables, jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(speakers), jnp.asarray(langs))
    t_in = tuple(torch.as_tensor(np.array(x)) for x in (memory, mt, mask))
    t_carry = jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)),
                                     carry)
    return hp, model, variables, port, (carry, memory, mt, mask), t_in, t_carry


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("steps", [2, 16])
def test_decode_chunk_exact_gates_matches_xla_scan(steps):
    """Dropout 0, exact float32 gates: the port's ``Tacotron.decode_chunk``
    and the kernel wrapper's CPU route (both the plain chunk) against the
    JAX XLA-scan decode: atol 3e-5 over 2 steps (the bound of the JAX
    kernel's own parity test), relative error 1e-3 over 16 steps (the
    random net amplifies reassociation noise)."""
    hp, model, variables, port, jx, t_in, t_carry = _decode_setup()
    dec = jax.jit(functools.partial(model.apply, method=Tacotron.decode_chunk),
                  static_argnames=("chunk_frames",))
    carry_x, (spec_x, stop_x) = dec(variables, *jx, jax.random.PRNGKey(0),
                                    chunk_frames=steps)
    eager = port.decode_chunk(t_carry, *t_in, (1, 2), steps)
    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, torch.float32, quantize_gates=False)
    fused = fused_decoder.decode_chunk(
        bundle, t_carry, *t_in, (1, 2), steps, dropout_rate=0.0,
        zoneout_h=hp.zoneout_hidden, zoneout_c=hp.zoneout_cell)
    for carry_p, (spec_p, stop_p) in (eager, fused):
        spec_p, stop_p = to_np(spec_p), to_np(stop_p)
        if steps == 2:
            np.testing.assert_allclose(spec_p, np.asarray(spec_x), atol=3e-5)
            np.testing.assert_allclose(stop_p, np.asarray(stop_x), atol=3e-5)
            np.testing.assert_allclose(to_np(carry_p["h_att"]),
                                       np.asarray(carry_x["h_att"]), atol=3e-5)
            np.testing.assert_allclose(
                to_np(carry_p["att_state"]["weights"]),
                np.asarray(carry_x["att_state"]["weights"]), atol=3e-5)
        else:
            assert _rel(spec_p, np.asarray(spec_x)) < 1e-3
            assert _rel(stop_p, np.asarray(stop_x)) < 1e-3


@pytest.mark.parametrize("prenet_layers", [1, 2, 3])
def test_w8a8_dropout_chunk_matches_pallas_kernel(prenet_layers):
    """W8A8 gates and prenet dropout 0.5: the port's plain chunk against
    the JAX Pallas kernel (interpret mode, one batch block) with the same
    seed pair, at prenet depths 1 to 3 (the flagship's 2).  Dropout masks
    are identical; spec and stop agree to atol 1e-4 over 2 steps
    (requantization may flip one int8 level where the inputs differ by an
    ulp)."""
    hp, _, variables, port, jx, t_in, t_carry = _decode_setup(
        prenet_layers=prenet_layers)
    b = t_in[0].shape[0]
    rng = jax.random.PRNGKey(42)
    jb = pallas_decoder.extract_decoder_bundle(variables, jnp.float32,
                                               quantize_gates=True)
    carry_k, (spec_k, stop_k) = pallas_decoder.fused_decode_chunk(
        jb, *jx, rng, 2, dropout_rate=0.5, zoneout_h=hp.zoneout_hidden,
        zoneout_c=hp.zoneout_cell, block_cap=b, interpret=True)
    bits = np.asarray(jax.random.bits(rng, (1, 1, 2), jnp.uint32))
    seeds = (int(bits[0, 0, 0]), int(bits[0, 0, 1]))

    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, torch.float32, quantize_gates=True)
    carry_p, (spec_p, stop_p) = fused_decoder.decode_chunk(
        bundle, t_carry, *t_in, seeds, 2, dropout_rate=0.5,
        zoneout_h=hp.zoneout_hidden, zoneout_c=hp.zoneout_cell)
    np.testing.assert_allclose(to_np(spec_p), np.asarray(spec_k), atol=1e-4)
    np.testing.assert_allclose(to_np(stop_p), np.asarray(stop_k), atol=1e-4)
    np.testing.assert_allclose(to_np(carry_p["c_gen"]),
                               np.asarray(carry_k["c_gen"]), atol=1e-4)

    # the masks the port's prenet applied are the TPU kernel's masks
    n_pre, p_dim = hp.prenet_layers, hp.prenet_dimension
    thresh = np.uint32(min(int(0.5 * float(2 ** 32)), 2 ** 32 - 1))
    for step in range(2):
        keep = torch.zeros(n_pre, b, p_dim, dtype=torch.uint8)
        fused_decoder.prenet_plain(t_carry["frame"], bundle, 0.5, seeds,
                                   step, keep_out=keep)
        for layer in range(n_pre):
            ref = pallas_decoder._rand_bits(
                (b, p_dim), jnp.uint32(seeds[0]), jnp.uint32(seeds[1]),
                jnp.asarray(step * n_pre + layer + 1, jnp.int32)) < thresh
            np.testing.assert_array_equal(to_np(keep[layer]).astype(bool),
                                          np.asarray(ref))


def test_w8a8_quantization_matches_jax():
    """Column scales and int8 weights equal the JAX package's
    ``_quantize_columns``; the row quantization of the plain gate step
    (``quantize_rows_plain``, the row pass of ``gate_lstm``) rounds like the
    TPU kernel's (``pallas_decoder.py`` ``gate_matmul``, written out in jnp
    below), bit for bit: random rows, an all-zero row (the 1e-6 floor of
    the scale) and a row of exact halves (round half to even)."""
    _, _, variables, port = _models()
    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, torch.float32, quantize_gates=True)
    kern = variables["params"]["decoder"]["cell"]["attention_lstm"]["cell"][
        "gates"]["kernel"]
    q, scale = pallas_decoder._quantize_columns(kern)
    k = kern.shape[0]
    np.testing.assert_array_equal(to_np(bundle.att_w)[:, :k].T, np.asarray(q))
    np.testing.assert_array_equal(to_np(bundle.att_ws),
                                  np.asarray(scale)[0])
    assert not to_np(bundle.att_w)[:, k:].any()

    rows = np.random.RandomState(4).randn(4, k).astype(np.float32)
    rows[1] = 0.0
    rows[2] = 0.0
    rows[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x = jnp.asarray(rows)
    rs_x = jnp.maximum(jnp.max(jnp.abs(x), axis=1, keepdims=True),
                       1e-6) * (1.0 / 127.0)
    q_x = jnp.clip(jnp.round(x * (1.0 / rs_x)), -127.0, 127.0)
    q_p, rs_p = fused_decoder.quantize_rows_plain(torch.as_tensor(rows))
    np.testing.assert_array_equal(to_np(rs_p), np.asarray(rs_x))
    np.testing.assert_array_equal(to_np(q_p), np.asarray(q_x))
    assert not to_np(q_p)[1].any() and to_np(rs_p)[1, 0] > 0.0


def test_postnet_matches_jax():
    hp, model, variables, port = _models()
    pre = np.random.RandomState(9).randn(3, 24, hp.num_mels).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(pre), jnp.full((3,), 24),
                      method=Tacotron.apply_postnet)
    got = port.apply_postnet(torch.as_tensor(pre))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-5)
