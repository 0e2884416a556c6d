"""The CBHG linear postnet in the port against the JAX package, on the CPU
in float32.

``PostnetCBHG`` alone (eval and train mode, bank kernels 1..8 at narrow
channels, ragged lengths: outputs on each sample's frames, gradients and
batch statistics), the even kernels' padding against flax's SAME, the
weight maps both ways, and a tiny ``predict_linear`` Tacotron: the training
forward, loss and gradients and the eval forward against the JAX package's
XLA decoder path (prenet dropout, zoneout and the generated encoder's
dropout 0, which that path draws from ``jax.random``), ``Synthesizer``
and ``vocode`` on linear spectrograms are in
``tests/test_torch_cbhg_serving.py``.

Tolerances: f32 outputs within atol 1e-5, batch statistics within atol
1e-5, loss terms within rtol 1e-5, gradients within 1e-4 of each tensor's
largest value (``tests/test_torch_training.py``'s bounds).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.models import postnet as jpost
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.models.layers import (
    same_pad_amounts as jax_same_pad_amounts,
)
from multilingual_text_to_speech_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac
from multilingual_text_to_speech_tpu_torch.models.layers import (
    ConvBlock,
    ConvBlockGenerated,
    same_pad_amounts,
)
from multilingual_text_to_speech_tpu_torch.models.postnet import PostnetCBHG
from tests.torch_port_utils import (
    _randomize,
    batch,
    jax_variables,
    port_hp,
    tiny_hp,
    to_np,
)

BINS = 1102 // 2 + 1
CBHG = dict(cbhg_bank_kernels=8, cbhg_bank_dimension=4,
            cbhg_projection_dimension=6, cbhg_highway_dimension=8,
            cbhg_rnn_dim=8)
B, T, FRAMES = 4, 8, 8


def cbhg_hp(**over):
    """``tiny_hp`` with the CBHG postnet at narrow widths (all eight bank
    kernels) and linear normalization constants."""
    hp = tiny_hp(predict_linear=True, **{**CBHG, **over})
    hp.lin_normalize_mean = list(np.linspace(-1.0, 1.0, BINS))
    hp.lin_normalize_variance = list(np.linspace(0.5, 1.5, BINS))
    return hp


def flax_shapes(hp):
    """The flax init's tree for ``hp`` as shapes (traced, not compiled)."""
    model = jtac.Tacotron(hp, train=False)
    key = jax.random.PRNGKey(0)
    b = 2
    variables = jax.eval_shape(
        model.init, key, jnp.ones((b, T), jnp.int32), jnp.full((b,), T),
        jnp.zeros((b, FRAMES, hp.num_mels)), jnp.full((b,), FRAMES),
        jnp.zeros((b,), jnp.int32), jnp.arange(b) % 2, 0.0, key)
    return {col: jax.tree_util.tree_map(lambda x: x.shape, variables[col])
            for col in ("params", "batch_stats")}


@functools.lru_cache(maxsize=None)
def _variables(stop_bias=None, classifier="none", seed=1234):
    """numpy weights (random batch statistics too) in the flax layout for
    ``cbhg_hp`` with ``classifier`` ("none", "reversal" or "cosine"):
    seeded normal weights at 0.3 on ``params_to_jax`` of a port model
    (``test_weight_maps_round_trip_exactly`` holds its paths and shapes to
    the flax init's); ``stop_bias`` overrides the stop head's bias."""
    hp = _classifier_hp(classifier)
    tree = params_to_jax(ptac.Tacotron(port_hp(hp)).state_dict(), hp)
    rng = np.random.RandomState(seed)
    v = {col: _randomize(tree[col], rng, col)
         for col in ("params", "batch_stats")}
    if stop_bias is not None:
        stop = v["params"]["decoder"]["cell"]["stop_prediction"]
        stop["bias"] = np.full_like(stop["bias"], stop_bias)
    return v


def _classifier_hp(classifier):
    if classifier == "none":
        return cbhg_hp()
    return cbhg_hp(reversal_classifier=True,
                   reversal_classifier_type=classifier)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _module_case(train, seed=0):
    """A flax ``PostnetCBHG`` with random weights and statistics, the port's
    loaded with them, an input [3, 11, 5] and ragged lengths."""
    m, out_dim = 5, 13
    jm = jpost.PostnetCBHG(output_dim=out_dim, bank_size=8, bank_channels=4,
                           projection_channels=6, highway_dim=8, gru_dim=8,
                           train=train)
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 11, m).astype(np.float32)
    lengths = np.array([11, 7, 4], np.int32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(lengths))
    v = {col: _randomize(jax.tree_util.tree_map(np.asarray, v[col]), rng, col)
         for col in ("params", "batch_stats")}
    pm = PostnetCBHG(m, out_dim, 8, 4, 6, 3, 8, 8)
    pm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, pm.train(train), x, lengths


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cbhg_matches_jax(train):
    """Outputs on each sample's frames within atol 1e-5; the gradients of
    a masked weighted sum within 1e-4 of each tensor's largest value (the
    GRU's ``bias_hh`` r and z thirds zero, flax having no such leaves); in
    train mode the running statistics within atol 1e-5."""
    jm, v, pm, x, lengths = _module_case(train)
    mask = (np.arange(x.shape[1])[None, :] < lengths[:, None])[..., None]
    w = np.random.RandomState(9).randn(*x.shape[:2], 13).astype(np.float32)
    w = w * mask

    def loss(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                       jnp.asarray(x), jnp.asarray(lengths),
                       mutable=["batch_stats"] if train else False)
        out, mut = out if train else (out, None)
        return jnp.sum(out * w), (out, mut)

    (_, (ref, mut)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax_variables(v)["params"])
    got = pm(torch.as_tensor(x), torch.as_tensor(lengths))
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(to_np(got) * mask, np.asarray(ref) * mask,
                               atol=1e-5)
    ref_grads = params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})
    params = dict(pm.named_parameters())
    assert set(params) == set(ref_grads)
    for name, r in ref_grads.items():
        g = to_np(params[name].grad)
        scale = float(np.abs(to_np(r)).max()) + 1e-6
        assert np.abs(g - to_np(r)).max() / scale < 1e-4, name
    for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
        assert not params[f"bigru.{name}"].grad[:8].any()
    if train:
        stats = params_from_jax(
            {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   mut["batch_stats"])})
        buffers = dict(pm.named_buffers())
        for name, r in stats.items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(to_np(buffers[name]), to_np(r),
                                           atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kernel", range(1, 9))
def test_conv_block_padding_is_flax_same(kernel):
    """Even kernels pad one more frame on the right, as flax's SAME
    padding does: the port's ``ConvBlock`` convolution against
    ``nn.Conv(padding="SAME")`` within atol 1e-5, and its pad amounts are
    the JAX package's."""
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 9, 3).astype(np.float32)
    conv = fnn.Conv(4, (kernel,), padding="SAME", use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = conv.apply(v, jnp.asarray(x))
    block = ConvBlock(3, 4, kernel).eval()
    with torch.no_grad():
        block.Conv_0.weight.copy_(torch.as_tensor(np.transpose(
            np.asarray(v["params"]["kernel"]), (2, 1, 0))))
        block.BatchNorm_0.running_var.fill_(1.0 - block.BatchNorm_0.eps)
    np.testing.assert_allclose(to_np(block(torch.as_tensor(x))),
                               np.asarray(ref), atol=1e-5)
    assert same_pad_amounts(kernel, 1) == tuple(
        jax_same_pad_amounts(kernel, 1))
    lo, hi = same_pad_amounts(kernel, 1)
    assert lo + hi == kernel - 1 and hi - lo == (kernel + 1) % 2


@pytest.mark.parametrize("classifier", ["cosine"])
def test_weight_maps_round_trip_exactly(classifier):
    """``params_to_jax(params_from_jax(tree))`` is the tree bit for bit,
    with exactly the flax init's paths and shapes (the GRU cells
    ``GRUCell_0``/``GRUCell_1``, the bank, highway and classifier
    leaves), and the GRU's ``bias_hh`` is ``[0, 0, hn.bias]``."""
    hp = _classifier_hp(classifier)
    v = _variables(classifier=classifier)
    ref = list(_leaves(v))
    assert [(p, a.shape) for p, a in ref] == [
        (p, tuple(s)) for p, s in _leaves(flax_shapes(hp))]
    model = ptac.Tacotron(port_hp(hp))
    model.load_state_dict(params_from_jax(v), strict=True)
    got = list(_leaves(params_to_jax(model.state_dict(), hp)))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    gru = v["params"]["postnet"]["GRUCell_1"]
    np.testing.assert_array_equal(
        to_np(model.postnet.bigru.bias_hh_l0_reverse),
        np.concatenate([np.zeros(8, np.float32), gru["hn"]["bias"]]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _targets(hp, seed=3):
    rng = np.random.RandomState(seed)
    tlen = np.array([FRAMES, FRAMES - 2, FRAMES - 1, 5], np.int32)
    pad = np.arange(FRAMES)[None, :] >= tlen[:, None]
    mel = rng.randn(B, FRAMES, hp.num_mels).astype(np.float32)
    lin = rng.randn(B, FRAMES, BINS).astype(np.float32)
    mel[pad], lin[pad] = 0.0, 0.0
    stop = np.zeros((B, FRAMES), np.float32)
    for i, n in enumerate(tlen):
        stop[i, max(n - hp.stop_frames, 0):] = 1.0
    return mel, lin, tlen, stop


@pytest.fixture
def xla_decoder(monkeypatch):
    """The JAX package's XLA decoder scan, its generated encoder's
    hard-coded dropout at 0."""
    monkeypatch.setenv("MTTS_PALLAS_TRAIN_DECODER", "off")
    orig = jtac.GeneratedConvolutionalEncoder
    monkeypatch.setattr(jtac, "GeneratedConvolutionalEncoder",
                        lambda *a, **kw: orig(*a, **{**kw, "dropout": 0.0}))


def _port_model(hp, v):
    model = ptac.Tacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v), strict=True)
    for m in model.modules():
        if isinstance(m, ConvBlockGenerated):
            m.dropout = 0.0
    return model


def _inputs(hp):
    text, lengths, speakers = batch(hp, B, T, seed=7)
    return text, lengths, speakers, np.arange(B) % hp.language_number


def test_training_forward_loss_and_grads_match_jax(xla_decoder):
    """Teacher forcing 0.5, zoneout 0: every loss term within rtol 1e-5
    (``mel_pos`` against the linear target), every gradient within 1e-4
    of its tensor's largest value, the running statistics after the step
    within atol 1e-5, and ``post_prediction`` [B, F, 552] zero past each
    length."""
    hp = cbhg_hp(zoneout_hidden=0.0, zoneout_cell=0.0)
    v = _variables()
    text, lengths, speakers, languages = _inputs(hp)
    mel, lin, tlen, stop = _targets(hp)
    key = jax.random.PRNGKey(11)
    model = jtac.Tacotron(hp, train=True)

    def loss_fn(params):
        out, mut = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(mel),
            jnp.asarray(tlen), jnp.asarray(speakers), jnp.asarray(languages),
            0.5, key, mutable=["batch_stats"],
            rngs={"dropout": jax.random.fold_in(key, 1)})
        total, losses = jtac.tacotron_loss(
            out, hp=hp, input_lengths=jnp.asarray(lengths),
            target_lengths=jnp.asarray(tlen), pre_target=jnp.asarray(mel),
            post_target=jnp.asarray(lin), stop_target=jnp.asarray(stop),
            speakers=jnp.asarray(speakers), guided_att_variance=0.3)
        return total, (losses, mut)

    (_, (ref_losses, mut)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_variables(v)["params"])
    teacher = np.asarray(jax.random.bernoulli(jax.random.split(key)[0], 0.5,
                                              (FRAMES,)))
    assert 0 < teacher.sum() < FRAMES

    pm = _port_model(hp, v).train()
    args = [torch.as_tensor(a) for a in (text, lengths, mel, tlen, speakers,
                                         languages)]
    out = pm(*args, teacher.astype(int).tolist(), (5, 6))
    total, losses = ptac.tacotron_loss(
        out, hp=pm.hp, input_lengths=args[1], target_lengths=args[3],
        pre_target=args[2], post_target=torch.as_tensor(lin),
        stop_target=torch.as_tensor(stop), speakers=args[4],
        guided_att_variance=0.3)
    total.backward()
    post = to_np(out["post_prediction"])
    assert post.shape == (B, FRAMES, BINS)
    assert not post[np.arange(FRAMES)[None, :] >= tlen[:, None]].any()
    assert set(losses) == set(ref_losses)
    for k, r in ref_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(r),
                                   rtol=1e-5, err_msg=k)
    ref_grads = params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})
    params = dict(pm.named_parameters())
    assert set(params) == set(ref_grads)
    for name, r in ref_grads.items():
        g = to_np(params[name].grad)
        scale = float(np.abs(to_np(r)).max()) + 1e-6
        assert np.abs(g - to_np(r)).max() / scale < 1e-4, name
    stats = params_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])})
    buffers = dict(pm.named_buffers())
    for name, r in stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(to_np(buffers[name]), to_np(r),
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ratio", [0.5])
def test_eval_forward_matches_jax(xla_decoder, ratio):
    """``model.eval()``'s forward (the GTA and ``evaluate`` passes: here
    teacher-forced and free-running frames both) against
    ``Tacotron(train=False)``: pre and post predictions, stop logits and
    alignments within atol 1e-5."""
    hp = cbhg_hp()
    v = _variables()
    text, lengths, speakers, languages = _inputs(hp)
    mel, _, tlen, _ = _targets(hp)
    key = jax.random.PRNGKey(13)
    ref = jax.jit(lambda *a: jtac.Tacotron(hp, train=False).apply(
        *a, ratio, key))(
        jax_variables(v), jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(mel), jnp.asarray(tlen), jnp.asarray(speakers),
        jnp.asarray(languages))
    teacher = np.asarray(jax.random.bernoulli(jax.random.split(key)[0],
                                              ratio, (FRAMES,)))
    pm = _port_model(hp, v).eval()
    args = [torch.as_tensor(a) for a in (text, lengths, mel, tlen, speakers,
                                         languages)]
    out = pm(*args, teacher.astype(int).tolist(), (5, 6))
    for k in ("pre_prediction", "post_prediction", "stop_token",
              "alignment"):
        np.testing.assert_allclose(to_np(out[k]), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)


def test_cbhg_model_needs_no_refusal():
    """``Tacotron`` builds with ``predict_linear`` and either classifier,
    and ``init_random_weights`` keeps the GRU's r and z ``bias_hh`` thirds
    at zero."""
    hp = port_hp(cbhg_hp(reversal_classifier=True,
                         reversal_classifier_type="cosine"))
    model = ptac.init_random_weights(ptac.Tacotron(hp), 0)
    assert isinstance(model.postnet, PostnetCBHG)
    assert model.classifier.fc.weight.shape == (hp.speaker_number,
                                                hp.encoder_dimension)
    gru = model.postnet.bigru
    for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
        b = getattr(gru, name)
        assert not b[:8].any() and b[8:].abs().sum() > 0
