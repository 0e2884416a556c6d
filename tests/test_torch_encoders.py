"""The port's encoders of the paper's strategies against the JAX package.

``simple`` (conv blocks and a BiLSTM), ``shared`` (``ConditionalEncoder``),
``separate`` (``MultiEncoder``) and ``convolutional`` (the plain grouped
conv stack), alone and inside whole tiny models of the published
``shared_switching`` (simple encoder, classifier, 548-wide memory at full
width) and ``separate_switching`` (convolutional encoder, 288-wide memory)
topologies.  Everything runs on the CPU in float32 on numpy-seeded weights
handed to both packages through ``params_from_jax``; the JAX train forward
runs its fused train decoder in interpret mode.
"""

import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multilingual_text_to_speech_tpu as mtts
from multilingual_text_to_speech_tpu.models import encoder as jenc
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu_torch import config as pconfig
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models import encoder as penc
from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac
from multilingual_text_to_speech_tpu_torch.models.layers import (
    GroupedConvBlock,
)
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from tests.corpus_utils import tiny_model_hp
from tests.torch_port_utils import N_MELS, _randomize, port_hp, to_np

KEY = jax.random.PRNGKey(0)
# encoder outputs in float32 on the same weights: the port's and the JAX
# package's products sum in other orders
ENC_ATOL = 1e-5


def _random_variables(variables, seed):
    rng = np.random.RandomState(seed)
    return {col: _randomize(jax.tree_util.tree_map(np.asarray,
                                                   variables[col]), rng, col)
            for col in ("params", "batch_stats") if col in variables}


def _jax_apply(module, v_np, *args, **kw):
    return np.asarray(module.apply(
        jax.tree_util.tree_map(jnp.asarray, v_np), *args, **kw))


def _port_module(module, v_np):
    module.load_state_dict(params_from_jax(v_np), strict=True)
    return module.eval()


def _inputs(b, t, c, seed, lengths=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32)
    if lengths is None:
        lengths = rng.randint(2, t + 1, b)
        lengths[0] = t
    lengths = np.asarray(lengths, np.int32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    w = rng.uniform(0.0, 1.0, (b, t, 2)).astype(np.float32)
    return x, lengths, w


def _assert_padding_zero(out, lengths):
    for i, n in enumerate(lengths):
        assert not np.any(out[i, n:]), i


# ---------------------------------------------------------------------------
# the encoders alone
# ---------------------------------------------------------------------------

_ENCODERS = {
    # type: (JAX module, port module, takes the language weights)
    "simple": (lambda: jenc.Encoder(output_dim=8, num_blocks=2,
                                    kernel_size=3, dropout=0.0),
               lambda: penc.Encoder(6, 8, 2, 3, 0.0), False),
    "shared": (lambda: jenc.ConditionalEncoder(
        num_langs=2, langs_embedding_dim=4, output_dim=8, num_blocks=2,
        kernel_size=3, dropout=0.0),
        lambda: penc.ConditionalEncoder(2, 4, 6, 8, 2, 3, 0.0), True),
    "separate": (lambda: jenc.MultiEncoder(
        num_langs=2, output_dim=8, num_blocks=2, kernel_size=3, dropout=0.0),
        lambda: penc.MultiEncoder(2, 6, 8, 2, 3, 0.0), True),
    "convolutional": (lambda: jenc.ConvolutionalEncoder(
        input_dim=6, output_dim=8, groups=2, dropout=0.0),
        lambda: penc.ConvolutionalEncoder(6, 8, 2, dropout=0.0), False),
}


@functools.lru_cache(maxsize=None)
def _encoder_weights(kind):
    jmod, _, with_w = _ENCODERS[kind]
    x, lengths, w = _inputs(4, 9, 6, seed=0)
    args = (jnp.asarray(x), jnp.asarray(lengths)) + (
        (jnp.asarray(w),) if with_w else ())
    return _random_variables(jmod().init(KEY, *args), seed=len(kind))


@pytest.mark.parametrize("kind", sorted(_ENCODERS))
def test_encoder_matches_jax_with_padded_rows(kind):
    """Eval mode, float32: the port's encoder against the JAX module on rows
    of lengths 12, 3, 7 and 1 padded to 12 (the convolutional encoder on
    its language-interleaved path), within atol 1e-5; every padded
    position's output is zero."""
    jmod, pmod, with_w = _ENCODERS[kind]
    v_np = _encoder_weights(kind)
    x, lengths, w = _inputs(4, 12, 6, seed=1, lengths=[12, 3, 7, 1])
    jargs = (jnp.asarray(x), jnp.asarray(lengths)) + (
        (jnp.asarray(w),) if with_w else ())
    ref = _jax_apply(jmod(), v_np, *jargs)
    port = _port_module(pmod(), v_np)
    got = to_np(port(torch.as_tensor(x), torch.as_tensor(lengths),
                     torch.as_tensor(w) if with_w else None))
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL)
    _assert_padding_zero(got, lengths)


@pytest.mark.parametrize("kind", ["simple", "shared", "separate"])
def test_backward_lstm_starts_at_the_true_last_token(kind):
    """With kernel-1 convs, filling the padding with 99 changes nothing in
    the valid outputs (the backward direction starts at each row's last
    token, as the JAX package's ``tests/test_models.py`` checks), and both
    inputs give the JAX outputs within atol 1e-5."""
    x, lengths, w = _inputs(3, 8, 6, seed=2, lengths=[8, 5, 2])
    jmod = {"simple": lambda: jenc.Encoder(
                output_dim=8, num_blocks=1, kernel_size=1, dropout=0.0),
            "shared": lambda: jenc.ConditionalEncoder(
                num_langs=2, langs_embedding_dim=4, output_dim=8,
                num_blocks=1, kernel_size=1, dropout=0.0),
            "separate": lambda: jenc.MultiEncoder(
                num_langs=2, output_dim=8, num_blocks=1, kernel_size=1,
                dropout=0.0)}[kind]
    pmod = {"simple": lambda: penc.Encoder(6, 8, 1, 1, 0.0),
            "shared": lambda: penc.ConditionalEncoder(2, 4, 6, 8, 1, 1, 0.0),
            "separate": lambda: penc.MultiEncoder(2, 6, 8, 1, 1, 0.0)}[kind]
    extra = () if kind == "simple" else (jnp.asarray(w),)
    v_np = _random_variables(jmod().init(
        KEY, jnp.asarray(x), jnp.asarray(lengths), *extra), seed=3)
    port = _port_module(pmod(), v_np)
    corrupt = x.copy()
    corrupt[np.arange(8)[None, :] >= lengths[:, None]] = 99.0
    outs = []
    for xx in (x, corrupt):
        ref = _jax_apply(jmod(), v_np, jnp.asarray(xx), jnp.asarray(lengths),
                         *extra)
        got = to_np(port(torch.as_tensor(xx), torch.as_tensor(lengths),
                         None if kind == "simple" else torch.as_tensor(w)))
        np.testing.assert_allclose(got, ref, atol=ENC_ATOL)
        outs.append(got)
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(outs[0][i, :n], outs[1][i, :n])


def test_convolutional_row_groups_and_mixing_match_jax():
    """The convolutional encoder's row-group path (a language-sorted batch,
    one row group a language) and its mixing path (fractional weights)
    against the JAX module within atol 1e-5; at one-hot weights the mixing
    path gives the row-group result within atol 1e-5."""
    jmod, pmod, _ = _ENCODERS["convolutional"]
    v_np = _encoder_weights("convolutional")
    port = _port_module(pmod(), v_np)
    x, lengths, w = _inputs(4, 10, 6, seed=4)
    group = np.array([1, 0], np.int32)          # rows 0-1 fr, rows 2-3 de
    ref_rows = _jax_apply(jmod(), v_np, jnp.asarray(x), jnp.asarray(lengths),
                          group_langs=jnp.asarray(group))
    rows = to_np(port(torch.as_tensor(x), torch.as_tensor(lengths),
                      group_langs=torch.as_tensor(group).long()))
    np.testing.assert_allclose(rows, ref_rows, atol=ENC_ATOL)
    ref_mix = _jax_apply(jmod(), v_np, jnp.asarray(x), jnp.asarray(lengths),
                         jnp.asarray(w))
    mixed = to_np(port(torch.as_tensor(x), torch.as_tensor(lengths),
                       torch.as_tensor(w)))
    np.testing.assert_allclose(mixed, ref_mix, atol=ENC_ATOL)
    one_hot = np.zeros_like(w)
    one_hot[:2, :, 1] = 1.0
    one_hot[2:, :, 0] = 1.0
    mixed_one_hot = to_np(port(torch.as_tensor(x), torch.as_tensor(lengths),
                               torch.as_tensor(one_hot)))
    np.testing.assert_allclose(mixed_one_hot, rows, atol=ENC_ATOL)


# ---------------------------------------------------------------------------
# whole models of the shared and separate topologies
# ---------------------------------------------------------------------------

_TOPOLOGIES = {
    "shared_switching": dict(encoder_type="simple", reversal_classifier=True,
                             reversal_classifier_w=0.5,
                             language_embedding_dimension=4),
    "separate_switching": dict(encoder_type="convolutional",
                               reversal_classifier=False,
                               language_embedding_dimension=0),
    # the two other strategies' encoders inside a model
    "shared_encoder": dict(encoder_type="shared", reversal_classifier=False,
                           language_embedding_dimension=4),
    "separate_encoder": dict(encoder_type="separate",
                             reversal_classifier=False,
                             language_embedding_dimension=4),
}
B, T, FRAMES = 4, 8, 8


def _model_hp(topology, **over):
    """The topology at laptop widths: 2 languages, 4 speakers, dropout
    cells in the decoder (as both published overlays), float32, exact
    gates, prenet dropout 0."""
    hp = tiny_model_hp(
        multi_speaker=True, multi_language=True, speaker_number=4,
        language_number=2, languages=["de", "fr"],
        decoder_regularization="dropout", compute_dtype="float32",
        pallas_decoder_int8=False, dropout=0.0, **_TOPOLOGIES[topology])
    hp.unique_speakers = ["s0", "s1", "s2", "s3"]
    hp.mel_normalize_mean = list(np.linspace(-2.0, 1.0, N_MELS))
    hp.mel_normalize_variance = list(np.linspace(0.5, 1.5, N_MELS))
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


@functools.lru_cache(maxsize=None)
def _model_weights(topology, stop_bias=None):
    hp = _model_hp(topology)
    variables = jax.jit(jtac.Tacotron(hp, train=False).init)(
        KEY, jnp.ones((B, T), jnp.int32), jnp.full((B,), T),
        jnp.zeros((B, FRAMES, hp.num_mels)), jnp.full((B,), FRAMES),
        jnp.zeros((B,), jnp.int32), jnp.arange(B) % 2, 0.0, KEY)
    v_np = _random_variables(variables, seed=1234)
    if stop_bias is not None:
        stop = v_np["params"]["decoder"]["cell"]["stop_prediction"]
        stop["bias"] = np.full_like(stop["bias"], stop_bias)
    return v_np


def _port_model(hp, v_np):
    model = ptac.Tacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v_np, hp), strict=True)
    return model.eval()


def _text(hp, b, t, seed):
    rng = np.random.RandomState(seed)
    lengths = np.clip(rng.randint(t // 2, t + 1, b), 2, t).astype(np.int32)
    lengths[0] = t
    text = rng.randint(3, hp.total_symbols(), (b, t)).astype(np.int32)
    text[np.arange(t)[None, :] >= lengths[:, None]] = 0
    return text, lengths, rng.randint(0, hp.speaker_number, b).astype(
        np.int32)


@pytest.mark.parametrize("topology", sorted(_TOPOLOGIES))
def test_params_from_jax_loads_strict(topology):
    """Every parameter and batch statistic of a JAX model of the topology
    maps onto the port's ``Tacotron``, which loads it with
    ``strict=True``; the port has no tensor the JAX tree lacks."""
    hp = _model_hp(topology)
    sd = params_from_jax(_model_weights(topology), hp)
    model = ptac.Tacotron(port_hp(hp), torch.float32)
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())


def _jax_encode(hp, v_np, *args, **kw):
    return jax.jit(functools.partial(
        jtac.Tacotron(hp, train=False).apply,
        method=jtac.Tacotron.encode_for_inference))(
            jax.tree_util.tree_map(jnp.asarray, v_np), *args, **kw)


@pytest.mark.parametrize("path", ["row_groups", "mixing"])
@pytest.mark.parametrize("topology", sorted(_TOPOLOGIES))
def test_encode_for_inference_matches_jax(topology, path):
    """(memory, memory transform, mask) within atol 1e-5 on bucket-padded
    rows, through the row-group plan (which a non-grouped encoder takes as
    per-character weights) and through fractional mixing weights."""
    hp = _model_hp(topology)
    v_np = _model_weights(topology)
    text, lengths, speakers = _text(hp, B, 11, seed=3)
    text = np.pad(text, ((0, 0), (0, 5)))
    if path == "row_groups":
        langs = np.array([0, 0, 1, 1], np.int32)
        group = np.array([0, 1], np.int32)
        ref = _jax_encode(hp, v_np, jnp.asarray(text), jnp.asarray(lengths),
                          jnp.asarray(speakers), jnp.asarray(langs),
                          group_langs=jnp.asarray(group))
        got = _port_model(hp, v_np).encode_for_inference(
            torch.as_tensor(text), torch.as_tensor(lengths),
            torch.as_tensor(speakers).long(), torch.as_tensor(langs),
            group_langs=torch.as_tensor(group))
    else:
        w = np.random.RandomState(5).uniform(
            0.0, 1.0, (B, text.shape[1], 2)).astype(np.float32)
        ref = _jax_encode(hp, v_np, jnp.asarray(text), jnp.asarray(lengths),
                          jnp.asarray(speakers), jnp.asarray(w))
        got = _port_model(hp, v_np).encode_for_inference(
            torch.as_tensor(text), torch.as_tensor(lengths),
            torch.as_tensor(speakers).long(), torch.as_tensor(w))
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=ENC_ATOL)


@pytest.mark.parametrize("topology", ["shared_switching",
                                      "separate_switching"])
def test_plain_decode_chunk_matches_xla_scan(topology):
    """The plain decode chunk (8 steps, dropout cells, prenet dropout 0,
    exact float32 gates) from the same encoding against the JAX XLA-scan
    decode: spectrogram and stop logits within atol 3e-5 after 2 steps (the
    bound of the flagship's test) and a relative error of 1e-3 after 8."""
    hp = _model_hp(topology)
    v_np = _model_weights(topology)
    model = jtac.Tacotron(hp, train=False)
    variables = jax.tree_util.tree_map(jnp.asarray, v_np)
    text, lengths, speakers = _text(hp, B, 10, seed=7)
    memory, mt, mask, carry = _jax_encode(
        hp, v_np, jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(speakers), jnp.asarray(np.array([0, 1, 0, 1], np.int32)))
    port = _port_model(hp, v_np)
    t_in = tuple(torch.as_tensor(np.array(x)) for x in (memory, mt, mask))
    t_carry = jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)),
                                     carry)
    dec = jax.jit(functools.partial(model.apply,
                                    method=jtac.Tacotron.decode_chunk),
                  static_argnames=("chunk_frames",))
    for steps in (2, 8):
        _, (spec_x, stop_x) = dec(variables, carry, memory, mt, mask,
                                  jax.random.PRNGKey(0), chunk_frames=steps)
        _, (spec_p, stop_p) = port.decode_chunk(t_carry, *t_in, (1, 2), steps)
        spec_x, stop_x = np.asarray(spec_x), np.asarray(stop_x)
        if steps == 2:
            np.testing.assert_allclose(to_np(spec_p), spec_x, atol=3e-5)
            np.testing.assert_allclose(to_np(stop_p), stop_x, atol=3e-5)
        else:
            for g, r in ((spec_p, spec_x), (stop_p, stop_x)):
                assert (np.linalg.norm(to_np(g) - r)
                        / np.linalg.norm(r)) < 1e-3


def _targets(hp, seed=3):
    rng = np.random.RandomState(seed)
    target = rng.randn(B, FRAMES, hp.num_mels).astype(np.float32)
    tlen = np.array([FRAMES, FRAMES - 2, FRAMES - 1, 5], np.int32)
    target[np.arange(FRAMES)[None, :] >= tlen[:, None]] = 0.0
    stop = np.zeros((B, FRAMES), np.float32)
    for i, n in enumerate(tlen):
        stop[i, max(n - hp.stop_frames, 0):] = 1.0
    return target, tlen, stop


@functools.lru_cache(maxsize=None)
def _jax_train_step(topology):
    """The JAX training forward, loss and gradients at teacher forcing 0.5,
    dropout 0 outside the decoder (the convolutional encoder's hard-wired
    0.05 too; flax's rbg dropout cannot be reproduced), the decoder's
    dropout cells on (the kernels' hash), fused train decoder in interpret
    mode."""
    hp = _model_hp(topology)
    v_np = _model_weights(topology)
    text, lengths, speakers = _text(hp, B, T, seed=7)
    languages = np.arange(B) % 2
    target, tlen, stop = _targets(hp)
    key = jax.random.PRNGKey(11)
    orig = jtac.ConvolutionalEncoder
    old_env = os.environ.get("MTTS_PALLAS_TRAIN_DECODER")
    os.environ["MTTS_PALLAS_TRAIN_DECODER"] = "interpret"
    jtac.ConvolutionalEncoder = (
        lambda *a, **kw: orig(*a, **{**kw, "dropout": 0.0}))
    try:
        model = jtac.Tacotron(hp, train=True)
        variables = jax.tree_util.tree_map(jnp.asarray, v_np)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(target),
                jnp.asarray(tlen), jnp.asarray(speakers),
                jnp.asarray(languages), 0.5, key, mutable=["batch_stats"],
                rngs={"dropout": jax.random.fold_in(key, 1)})
            total, losses = jtac.tacotron_loss(
                out, hp=hp, input_lengths=jnp.asarray(lengths),
                target_lengths=jnp.asarray(tlen),
                pre_target=jnp.asarray(target), post_target=jnp.asarray(target),
                stop_target=jnp.asarray(stop), speakers=jnp.asarray(speakers),
                guided_att_variance=0.3)
            return total, (losses, mut)

        (_, (losses, mut)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    finally:
        jtac.ConvolutionalEncoder = orig
        if old_env is None:
            os.environ.pop("MTTS_PALLAS_TRAIN_DECODER")
        else:
            os.environ["MTTS_PALLAS_TRAIN_DECODER"] = old_env
    rng_tf, rng_steps = jax.random.split(key)
    teacher = np.asarray(jax.random.bernoulli(rng_tf, 0.5, (FRAMES,)))
    seeds = tuple(int(s) for s in np.asarray(
        jax.random.bits(rng_steps, (2,), jnp.uint32)))
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": grads, "batch_stats": mut["batch_stats"]})
    return ((text, lengths, speakers, languages, target, tlen, stop),
            teacher.astype(int).tolist(), seeds,
            {k: float(v) for k, v in losses.items()},
            params_from_jax({"params": tree["params"]}),
            params_from_jax({"batch_stats": tree["batch_stats"]}))


@pytest.mark.parametrize("topology", ["shared_switching",
                                      "separate_switching"])
def test_training_forward_loss_and_grads_match_jax(topology):
    """Train mode at teacher forcing 0.5 (the JAX side's flags and seeds):
    every loss term within rtol 1e-5, every parameter gradient within 1e-4
    of that tensor's largest value and every batch-norm running statistic
    after the step within atol 1e-5, as the flagship's test holds them."""
    data, teacher, seeds, ref_losses, ref_grads, ref_stats = \
        _jax_train_step(topology)
    assert 0 < sum(teacher) < len(teacher)
    hp = _model_hp(topology)
    model = _port_model(hp, _model_weights(topology)).train()
    for m in model.modules():          # the JAX side runs with dropout 0
        if isinstance(m, GroupedConvBlock):
            m.dropout = 0.0
    text, lengths, speakers, languages, target, tlen, stop = (
        torch.as_tensor(x) for x in data)
    out = model(text, lengths, target, tlen, speakers, languages, teacher,
                seeds)
    total, losses = ptac.tacotron_loss(
        out, hp=model.hp, input_lengths=lengths, target_lengths=tlen,
        pre_target=target, post_target=target, stop_target=stop,
        speakers=speakers, guided_att_variance=0.3)
    total.backward()
    assert set(losses) == set(ref_losses)
    for k, r in ref_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), r, rtol=1e-5,
                                   err_msg=k)
    params = dict(model.named_parameters())
    assert set(params) == set(ref_grads)
    for name, r in ref_grads.items():
        if not params[name].requires_grad:     # the BiLSTM's zero bias_hh
            assert params[name].grad is None and not np.any(to_np(r))
            continue
        g = to_np(params[name].grad)
        scale = float(np.abs(to_np(r)).max()) + 1e-6
        assert np.abs(g - to_np(r)).max() / scale < 1e-4, name
    buffers = dict(model.named_buffers())
    for name, r in ref_stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(to_np(buffers[name]), to_np(r),
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("topology", ["shared_switching",
                                      "separate_switching"])
def test_synthesizer_matches_jax(topology, mixed):
    """``Synthesizer.spectrograms_from_batch`` on the CPU, stop bias -10
    (every line decodes all 24 frames): the denormalized spectrograms
    within rtol 1e-3 (atol 1e-4) of the JAX ``Synthesizer``'s, on one-hot
    lines (the row-group plan) and with one accent blend (mixing)."""
    hp = _model_hp(topology, max_output_length=24, decode_chunk_frames=8)
    v_np = _model_weights(topology, -10.0)
    jax_syn = Synthesizer(hp, jax.tree_util.tree_map(jnp.asarray, v_np))
    port_syn = PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                               device="cpu")
    text, lengths, speakers = _text(hp, 5, 12, seed=11)
    seqs = [text[i, :lengths[i]] for i in range(5)]
    weights = []
    for i, seq in enumerate(seqs):
        w = np.zeros((1, len(seq), 2), np.float32)
        w[0, :, i % 2] = 1.0
        if mixed and i == 2:
            w[0, :, 0], w[0, :, 1] = 0.3, 0.7
        weights.append(w)
    args = (seqs, [int(s) for s in speakers], weights)
    ref = jax_syn.spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    assert len(got) == len(ref) == 5
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (N_MELS, 24)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["shared_switching", "separate_switching"])
def test_switching_hparams_equal_the_published_overlays(name):
    """``shared_switching_hparams()`` and ``separate_switching_hparams()``
    equal the JAX package's ``HParams.from_json`` of
    ``params/<name>.json`` with the counts its trainer sets (the languages'
    from their list) and 16 speakers, key for key."""
    path = Path(mtts.__file__).parent / "params" / f"{name}.json"
    ref = mtts.HParams.from_json(str(path))
    ref.language_number = len(ref.languages)
    ref.speaker_number = 16
    got = getattr(pconfig, f"{name}_hparams")()
    assert got.state_dict() == ref.state_dict()
    memory = {"shared_switching": 548, "separate_switching": 288}[name]
    assert got.decoder_input_dimension() == memory
