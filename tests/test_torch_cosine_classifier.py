"""The cosine-similarity speaker classifier in the port against the JAX
package, on the CPU in float32.

``GradientClipping`` against ``gradient_clipping``'s custom VJP (exact),
``CosineSimilarityClassifier`` against the flax module,
``cosine_similarity_classifier_loss`` and its gradients (into the
embeddings, the logits and the classifier's kernel), the whole training
forward, loss and gradients of a tiny model against the JAX package's XLA
decoder path (prenet dropout, zoneout and the generated encoder's dropout
0), and ``train_step``.

An all-zero embedding row (the generated encoder zeroes the frames past a
text's length) has a NaN gradient in the JAX package, whose
``jnp.linalg.norm`` differentiates ``sqrt`` at 0; PyTorch's norm gives 0
there, as the reference model's does.  The loss agrees either way; the
gradients are compared on texts without padding, and the zero rows have a
test of their own.

Tolerances: the loss within rtol 1e-6 and its gradients within atol 1e-6
(one product and a few reductions at these sizes); the training step's
loss terms within rtol 1e-5 and gradients within 1e-4 of each tensor's
largest value (``tests/test_torch_training.py``'s bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.models import classifier as jcls
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac
from multilingual_text_to_speech_tpu_torch.models.classifier import (
    CosineSimilarityClassifier,
    GradientClipping,
    cosine_similarity_classifier_loss,
)
from multilingual_text_to_speech_tpu_torch.training import trainer
from tests.test_torch_cbhg import _port_model, xla_decoder  # noqa: F401
from tests.torch_port_utils import (
    _randomize,
    jax_variables,
    port_hp,
    tiny_hp,
    to_np,
)

B, T, FRAMES, C, S = 4, 8, 8, 16, 4


def _hp(**over):
    return tiny_hp(reversal_classifier=True, reversal_classifier_type="cosine",
                   **over)


def _variables(hp, seed=1234):
    """Seeded weights at 0.3 in the flax layout of ``hp``'s model."""
    tree = params_to_jax(ptac.Tacotron(port_hp(hp)).state_dict(), hp)
    rng = np.random.RandomState(seed)
    return {col: _randomize(tree[col], rng, col)
            for col in ("params", "batch_stats")}


def _loss_inputs(seed=0, zero_rows=False):
    rng = np.random.RandomState(seed)
    lengths = np.array([T, 5, 7, 3], np.int32)
    speakers = rng.randint(0, S, B).astype(np.int32)
    pred = rng.randn(B, T, S).astype(np.float32)
    emb = rng.randn(B, T, C).astype(np.float32)
    if zero_rows:
        emb[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    kernel = (0.3 * rng.randn(C, S)).astype(np.float32)
    return lengths, speakers, pred, emb, kernel


def _jax_loss_and_grads(lengths, speakers, pred, emb, kernel):
    def f(p, e, k):
        return jcls.cosine_similarity_classifier_loss(
            jnp.asarray(lengths), jnp.asarray(speakers), p, e, k)
    loss, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(pred), jnp.asarray(emb), jnp.asarray(kernel))
    return float(loss), [np.asarray(g) for g in grads]


def _port_loss_and_grads(lengths, speakers, pred, emb, kernel):
    ts = [torch.tensor(a, requires_grad=True) for a in (pred, emb, kernel)]
    loss = cosine_similarity_classifier_loss(
        torch.as_tensor(lengths), torch.as_tensor(speakers), *ts)
    loss.backward()
    return float(loss.detach()), [to_np(t.grad) for t in ts]


def test_loss_and_gradients_match_jax():
    """Ragged lengths (the cross-entropy masked, the cosine term over all
    positions): the loss and its gradients into the logits, the
    embeddings and the kernel."""
    args = _loss_inputs()
    ref_loss, ref_grads = _jax_loss_and_grads(*args)
    loss, grads = _port_loss_and_grads(*args)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for name, g, r in zip(("prediction", "embeddings", "kernel"), grads,
                          ref_grads):
        np.testing.assert_allclose(g, r, atol=1e-6, err_msg=name)


def test_zero_embedding_rows_have_no_gradient():
    """Embeddings zero past each length: the same loss; the JAX package's
    gradient is NaN on those rows, the port's 0 there and the JAX one
    everywhere else."""
    args = _loss_inputs(zero_rows=True)
    ref_loss, ref_grads = _jax_loss_and_grads(*args)
    loss, grads = _port_loss_and_grads(*args)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    pad = np.arange(T)[None, :] >= args[0][:, None]
    assert np.isnan(ref_grads[1][pad]).all()
    assert not grads[1][pad].any()
    np.testing.assert_allclose(grads[1][~pad], ref_grads[1][~pad], atol=1e-6)
    np.testing.assert_allclose(grads[0], ref_grads[0], atol=1e-6)
    assert np.isfinite(grads[2]).all()


@pytest.mark.parametrize("clip", [0.25, 0.05])
def test_gradient_clipping_clamps_the_backward(clip):
    """Identity forward; backward ``clamp(g, -clip, clip)``, bit for bit
    the JAX package's custom VJP."""
    rng = np.random.RandomState(1)
    x, g = rng.randn(3, 5).astype(np.float32), rng.randn(3, 5).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_()
    y = GradientClipping.apply(xt, clip)
    (y * torch.as_tensor(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: jcls.gradient_clipping(v, clip), jnp.asarray(x))
    np.testing.assert_array_equal(to_np(y), x)
    np.testing.assert_array_equal(to_np(xt.grad),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    assert np.abs(to_np(xt.grad)).max() == pytest.approx(clip)


def test_classifier_matches_jax():
    """The flax ``CosineSimilarityClassifier``'s logits within atol 1e-5
    and the input's clipped gradient exactly (one ``fc`` layer)."""
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, C).astype(np.float32)
    g = (3.0 * rng.randn(B, T, S)).astype(np.float32)
    jm = jcls.CosineSimilarityClassifier(S)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, vjp = jax.vjp(lambda a: jm.apply(v, a), jnp.asarray(x))
    pm = CosineSimilarityClassifier(C, S)
    pm.load_state_dict({k.split(".", 1)[1]: t for k, t in params_from_jax(
        {"params": {"classifier": jax.tree_util.tree_map(
            np.asarray, v["params"])}}).items()})
    xt = torch.as_tensor(x).requires_grad_()
    out = pm(xt)
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(to_np(xt.grad),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)
    assert np.abs(to_np(xt.grad)).max() <= 0.25


def _batch(hp, seed=7):
    """Texts without padding (every length T), so that no encoder row is
    zero (see the module's docstring), and ragged targets."""
    rng = np.random.RandomState(seed)
    text = rng.randint(3, hp.total_symbols(), (B, T)).astype(np.int32)
    lengths = np.full(B, T, np.int32)
    speakers = rng.randint(0, hp.speaker_number, B).astype(np.int32)
    languages = np.arange(B) % hp.language_number
    tlen = np.array([FRAMES, FRAMES - 2, FRAMES - 1, 5], np.int32)
    mel = rng.randn(B, FRAMES, hp.num_mels).astype(np.float32)
    mel[np.arange(FRAMES)[None, :] >= tlen[:, None]] = 0.0
    stop = np.zeros((B, FRAMES), np.float32)
    for i, n in enumerate(tlen):
        stop[i, max(n - hp.stop_frames, 0):] = 1.0
    return text, lengths, speakers, languages, mel, tlen, stop


def test_training_forward_loss_and_grads_match_jax(xla_decoder):  # noqa: F811
    """Teacher forcing 0.5, zoneout 0: every loss term within rtol 1e-5
    (``lang_class`` the cosine loss), every gradient within 1e-4 of its
    tensor's largest value, ``classifier.fc.weight``'s included: it
    reaches the weight through the logits and through the cosine term."""
    hp = _hp(zoneout_hidden=0.0, zoneout_cell=0.0)
    v = _variables(hp)
    text, lengths, speakers, languages, mel, tlen, stop = _batch(hp)
    key = jax.random.PRNGKey(11)
    model = jtac.Tacotron(hp, train=True)

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(mel),
            jnp.asarray(tlen), jnp.asarray(speakers), jnp.asarray(languages),
            0.5, key, mutable=["batch_stats"],
            rngs={"dropout": jax.random.fold_in(key, 1)})
        return jtac.tacotron_loss(
            out, hp=hp, input_lengths=jnp.asarray(lengths),
            target_lengths=jnp.asarray(tlen), pre_target=jnp.asarray(mel),
            post_target=jnp.asarray(mel), stop_target=jnp.asarray(stop),
            speakers=jnp.asarray(speakers), guided_att_variance=0.3,
            classifier_kernel=params["classifier"]["fc"]["kernel"])

    (_, ref_losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_variables(v)["params"])
    teacher = np.asarray(jax.random.bernoulli(jax.random.split(key)[0], 0.5,
                                              (FRAMES,)))
    pm = _port_model(hp, v).train()
    args = [torch.as_tensor(a) for a in (text, lengths, mel, tlen, speakers,
                                         languages)]
    out = pm(*args, teacher.astype(int).tolist(), (5, 6))
    total, losses = ptac.tacotron_loss(
        out, hp=pm.hp, input_lengths=args[1], target_lengths=args[3],
        pre_target=args[2], post_target=args[2],
        stop_target=torch.as_tensor(stop), speakers=args[4],
        guided_att_variance=0.3, classifier_kernel=ptac.classifier_kernel(pm))
    total.backward()
    assert set(losses) == set(ref_losses) and "lang_class" in losses
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
    assert np.abs(to_np(params["classifier.fc.weight"].grad)).max() > 0


def test_train_step_trains_the_cosine_model():
    """``train_step`` on the CPU with ragged texts: finite losses, every
    parameter with a gradient moved (the classifier's ``fc`` included),
    and ``classifier_kernel`` is ``fc.weight`` transposed."""
    hp = port_hp(_hp())
    text, _, speakers, languages, mel, tlen, stop = _batch(_hp())
    lengths = np.array([T, 5, 7, 3], np.int32)
    text[np.arange(T)[None, :] >= lengths[:, None]] = 0
    b = trainer.Batch(text, lengths, mel, None, tlen, stop, speakers,
                      languages)
    model = ptac.init_random_weights(ptac.Tacotron(hp), 3)
    assert torch.equal(ptac.classifier_kernel(model),
                       model.classifier.fc.weight.t())
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt, sched = trainer.make_optimizer(model, hp)
    res = trainer.train_step(model, opt, sched, b,
                             ptac.TacotronLossState.init(hp),
                             torch.Generator().manual_seed(5), device="cpu")
    assert all(np.isfinite(float(v)) for v in res.losses.values())
    assert float(res.losses["lang_class"]) > 0
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
        assert not torch.equal(p.detach(), before[name]), name
