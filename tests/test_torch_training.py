"""The port's training step against the JAX package, on the CPU in float32.

The whole training forward, loss, gradients and batch-norm statistics
against ``Tacotron(train=True)`` (its fused train decoder in interpret
mode), the optimizer against ``make_optimizer``'s optax chain, the
schedules, gradient reversal, the classifier weights and the grouped
training layout.  Weights and inputs come from numpy seeds; the JAX side's
teacher flags and decoder seeds are drawn from its key as its decoder draws
them and handed to the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multilingual_text_to_speech_tpu.models import classifier as jcls
from multilingual_text_to_speech_tpu.models import encoder as jenc
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.training import schedule as jsched
from multilingual_text_to_speech_tpu.training import trainer as jtrainer
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac
from multilingual_text_to_speech_tpu_torch.models.classifier import (
    GradientReversal,
)
from multilingual_text_to_speech_tpu_torch.models.encoder import (
    from_grouped,
    to_grouped,
)
from multilingual_text_to_speech_tpu_torch.models.layers import (
    ConvBlockGenerated,
)
from multilingual_text_to_speech_tpu_torch.training import schedule, trainer
from tests.torch_port_utils import (
    batch,
    jax_variables,
    port_hp,
    tiny_hp,
    to_np,
    variables_np,
)

B, T, FRAMES = 4, 8, 8


def _hp(**over):
    return tiny_hp(reversal_classifier=True, **over)


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
def _jax_step(ratio, t=T, hp_over=()):
    """One JAX training forward + loss + grads on the tiny flagship-topology
    model at text length ``t`` and the settings ``hp_over`` (pairs), fused
    train decoder in interpret mode where it takes the shapes (its XLA scan
    above 512 symbols), encoder dropout 0."""
    import os

    hp = _hp(**dict(hp_over))
    v_np = variables_np(classifier=True)
    text, lengths, speakers = batch(hp, B, t, seed=7)
    languages = np.arange(B) % hp.language_number
    target, tlen, stop = _targets(hp)
    key = jax.random.PRNGKey(11)
    orig = jtac.GeneratedConvolutionalEncoder
    old_env = os.environ.get("MTTS_PALLAS_TRAIN_DECODER")
    os.environ["MTTS_PALLAS_TRAIN_DECODER"] = "interpret"
    jtac.GeneratedConvolutionalEncoder = (
        lambda *a, **kw: orig(*a, **{**kw, "dropout": 0.0}))
    try:
        model = jtac.Tacotron(hp, train=True)
        variables = jax_variables(v_np)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(target),
                jnp.asarray(tlen), jnp.asarray(speakers),
                jnp.asarray(languages), ratio, key, mutable=["batch_stats"],
                rngs={"dropout": jax.random.fold_in(key, 1)})
            total, losses = jtac.tacotron_loss(
                out, hp=hp, input_lengths=jnp.asarray(lengths),
                target_lengths=jnp.asarray(tlen),
                pre_target=jnp.asarray(target), post_target=jnp.asarray(target),
                stop_target=jnp.asarray(stop), speakers=jnp.asarray(speakers),
                guided_att_variance=0.3)
            return total, (losses, mut, out)

        (_, (losses, mut, out)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    finally:
        jtac.GeneratedConvolutionalEncoder = orig
        if old_env is None:
            os.environ.pop("MTTS_PALLAS_TRAIN_DECODER")
        else:
            os.environ["MTTS_PALLAS_TRAIN_DECODER"] = old_env
    rng_tf, rng_steps = jax.random.split(key)
    teacher = np.asarray(jax.random.bernoulli(rng_tf, ratio, (FRAMES,)))
    seeds = tuple(int(s) for s in np.asarray(
        jax.random.bits(rng_steps, (2,), jnp.uint32)))
    acc = jtrainer.Trainer._classifier_accuracy(
        None, out, type("B", (), {"utterance_lengths": jnp.asarray(lengths),
                                  "speakers": jnp.asarray(speakers)})())
    tree = jax.tree_util.tree_map(np.asarray,
                                  {"params": grads, "batch_stats": mut["batch_stats"]})
    return (hp, v_np, (text, lengths, speakers, languages, target, tlen, stop),
            teacher.astype(int).tolist(), seeds,
            {k: float(v) for k, v in losses.items()}, float(acc),
            params_from_jax({"params": tree["params"]}),
            params_from_jax({"batch_stats": tree["batch_stats"]}))


def _port_model(hp, v_np):
    model = ptac.Tacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v_np, hp), strict=True)
    for m in model.modules():          # the JAX side runs with dropout 0
        if isinstance(m, ConvBlockGenerated):
            m.dropout = 0.0
    return model.train()


def _check_step_against_jax(ratio, t=T, hp_over=()):
    """The port's plain training forward, loss, gradients and batch-norm
    statistics against ``_jax_step``'s (tolerances in the callers)."""
    (hp, v_np, data, teacher, seeds, ref_losses, ref_acc, ref_grads,
     ref_stats) = _jax_step(ratio, t, hp_over)
    assert 0 < sum(teacher) < len(teacher)
    text, lengths, speakers, languages, target, tlen, stop = (
        torch.as_tensor(x) for x in data)
    model = _port_model(hp, v_np)
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
    acc = trainer.classifier_accuracy(out["speaker_prediction"], speakers,
                                      lengths)
    assert float(acc) == pytest.approx(ref_acc, abs=1e-7)
    params = dict(model.named_parameters())
    assert set(params) == set(ref_grads)
    for name, r in ref_grads.items():
        g = to_np(params[name].grad)
        scale = float(np.abs(to_np(r)).max()) + 1e-6
        assert np.abs(g - to_np(r)).max() / scale < 1e-4, name
    buffers = dict(model.named_buffers())
    for name, r in ref_stats.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(to_np(buffers[name]), to_np(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("ratio", [0.5])
def test_training_forward_loss_and_grads_match_jax(ratio):
    """At teacher forcing 0.5 (teacher and free-running steps both
    occur): every loss term within rtol 1e-5, the classifier accuracy exactly,
    every parameter gradient within 1e-4 of that tensor's largest value,
    and every batch-norm running statistic after the step within atol
    1e-5."""
    _check_step_against_jax(ratio)


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_eval_forward_matches_jax(ratio):
    """``Tacotron.eval()``'s teacher-forced forward (K2's eval variant:
    zoneout 0.1 interpolated) against ``Tacotron(train=False)`` on the JAX
    package's XLA path, at prenet dropout 0 (that path draws its prenet
    dropout from ``jax.random`` keys, not the kernels' hash): the pre and
    post predictions, stop logits and alignments within atol 1e-5
    (measured 6.6e-7; the train-mode forward is 0.6 away), and the
    decoder's outputs carry no ``grad_fn``."""
    hp = _hp()
    v_np = variables_np(classifier=True)
    text, lengths, speakers = batch(hp, B, T, seed=7)
    languages = np.arange(B) % hp.language_number
    target, tlen, _ = _targets(hp)
    key = jax.random.PRNGKey(13)
    ref = jtac.Tacotron(hp, train=False).apply(
        jax_variables(v_np), jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(target), jnp.asarray(tlen), jnp.asarray(speakers),
        jnp.asarray(languages), ratio, key)
    teacher = np.asarray(jax.random.bernoulli(jax.random.split(key)[0],
                                              ratio, (FRAMES,)))
    model = _port_model(hp, v_np).eval()
    args = [torch.as_tensor(x) for x in (text, lengths, target, tlen,
                                         speakers, languages)]
    out = model(*args, teacher.astype(int).tolist(), (5, 6))
    for k in ("pre_prediction", "post_prediction", "stop_token",
              "alignment"):
        np.testing.assert_allclose(to_np(out[k]), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    assert out["pre_prediction"].grad_fn is None
    assert out["alignment"].grad_fn is None


class _Toy(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.encoder = torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(torch.tensor(w["encoder"]["w"]))})
        self.decoder = torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(torch.tensor(w["decoder"]["w"])),
             "b": torch.nn.Parameter(torch.tensor(w["decoder"]["b"]))})


@pytest.mark.parametrize("encoder_optimizer", [False, True])
def test_optimizer_matches_optax(encoder_optimizer):
    """Three steps fed identical numpy gradients: clipping (active on two
    steps), weight decay, Adam and a learning-rate decay at step 1 and 2,
    against ``make_optimizer``'s optax chain: parameters within atol
    1e-7."""
    hp = tiny_hp(learning_rate=1e-3, learning_rate_encoder=3e-3,
                 learning_rate_decay=0.5, learning_rate_decay_start=1,
                 learning_rate_decay_each=1, weight_decay=1e-2,
                 gradient_clipping=0.25, encoder_optimizer=encoder_optimizer)
    rng = np.random.RandomState(0)
    # parameters near 0.1, where a float32 ulp (7e-9) is well inside the
    # tolerance; the steps are lr-sized (1e-3) whatever the scale
    w = {"encoder": {"w": (0.1 * rng.randn(3, 4)).astype(np.float32)},
         "decoder": {"w": (0.1 * rng.randn(5)).astype(np.float32),
                     "b": (0.1 * rng.randn(2)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x, s=s: (rng.randn(*x.shape) * s).astype(np.float32), w)
        for s in (1.0, 0.01, 0.5)]

    tx = jtrainer.make_optimizer(hp)
    params = jax.tree_util.tree_map(jnp.asarray, w)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    model = _Toy(w)
    opt, sched = trainer.make_optimizer(model, port_hp(hp))
    for g in grads:
        model.encoder["w"].grad = torch.tensor(g["encoder"]["w"])
        model.decoder["w"].grad = torch.tensor(g["decoder"]["w"])
        model.decoder["b"].grad = torch.tensor(g["decoder"]["b"])
        norm = trainer.clip_grad_global_norm_(list(model.parameters()),
                                              hp.gradient_clipping)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(g)), rtol=1e-6)
        opt.step()
        sched.step()
    got = {"encoder": {"w": model.encoder["w"]},
           "decoder": {"w": model.decoder["w"], "b": model.decoder["b"]}}
    for r, p in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(to_np, got))):
        np.testing.assert_allclose(p, np.asarray(r), atol=1e-7, rtol=0)


@pytest.mark.parametrize("step", [0, 1, 14999, 15000, 29999, 30000, 70000])
def test_schedules_match_jax(step):
    hp = tiny_hp(constant_teacher_forcing=False)
    np.testing.assert_allclose(
        schedule.step_decay_schedule(port_hp(hp))(step),
        float(jsched.step_decay_schedule(hp)(step)), rtol=1e-6)
    assert schedule.teacher_forcing_ratio(port_hp(hp), step) == \
        pytest.approx(jsched.teacher_forcing_ratio(hp, step), abs=1e-12)


@pytest.mark.parametrize("scale,clip", [(1.0, 0.25), (0.5, 0.1)])
def test_gradient_reversal_sign_and_clamp(scale, clip):
    """Identity forward; backward ``-scale * clamp(g, -clip, clip)``, as the
    JAX package's custom VJP."""
    rng = np.random.RandomState(1)
    x, g = rng.randn(3, 5).astype(np.float32), rng.randn(3, 5).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_()
    y = GradientReversal.apply(xt, scale, clip)
    (y * torch.as_tensor(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: jcls.gradient_reversal(v, scale, clip),
                     jnp.asarray(x))
    np.testing.assert_array_equal(to_np(y), x)
    np.testing.assert_allclose(to_np(xt.grad), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=0, rtol=0)
    assert np.all(np.abs(to_np(xt.grad)) <= clip * scale + 1e-7)


def test_classifier_weights_load_strict_and_match_jax():
    """``params_from_jax`` now carries the classifier over (``strict=True``
    load) and the port's classifier gives the JAX logits."""
    hp = _hp()
    v_np = variables_np(classifier=True)
    model = ptac.Tacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v_np, hp), strict=True)
    x = np.random.RandomState(2).randn(B, T, hp.encoder_dimension).astype(
        np.float32)
    ref = jcls.ReversalClassifier(hp.reversal_classifier_dim,
                                  hp.speaker_number).apply(
        {"params": jax_variables(v_np)["params"]["classifier"]},
        jnp.asarray(x))
    np.testing.assert_allclose(to_np(model.classifier(torch.as_tensor(x))),
                               np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("groups", [2, 5])
def test_grouped_training_layout_and_mask(groups):
    """Sample ``k*g + j`` is row ``[j, k]`` of the group-major layout, the
    length mask follows it, and the inverse restores the batch: as the JAX
    package's ``_to_grouped``, ``_grouped_length_mask`` and
    ``_from_grouped``."""
    rng = np.random.RandomState(groups)
    b, t = 3 * groups, 6
    x = rng.randn(b, t, 4).astype(np.float32)
    lengths = rng.randint(1, t + 1, b)
    x4 = to_grouped(torch.as_tensor(x), groups)
    np.testing.assert_array_equal(
        to_np(x4), np.asarray(jenc._to_grouped(jnp.asarray(x), groups)))
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(to_grouped(torch.as_tensor(mask)[..., None], groups)),
        np.asarray(jenc._grouped_length_mask(jnp.asarray(lengths), b, t,
                                             groups)))
    np.testing.assert_array_equal(to_np(from_grouped(x4)), x)


def test_train_step_moves_every_parameter():
    """``train_step`` on the CPU: finite losses, the gradient norm before
    clipping, every parameter with a gradient changed, the running
    statistics moved, the loss state advanced, and the same generator seed
    gives the same step."""
    hp = port_hp(_hp())
    data = batch(_hp(), B, T, seed=4)
    target, tlen, stop = _targets(_hp())
    b = trainer.Batch(data[0], data[1], target, None, tlen, stop, data[2],
                      np.arange(B) % hp.language_number)

    def run():
        torch.manual_seed(0)
        model = ptac.init_random_weights(ptac.Tacotron(hp), 3)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt, sched = trainer.make_optimizer(model, hp)
        res = trainer.train_step(model, opt, sched, b,
                                 ptac.TacotronLossState.init(hp),
                                 torch.Generator().manual_seed(5),
                                 device="cpu")
        return model, before, res

    model, before, res = run()
    assert all(np.isfinite(float(v)) for v in res.losses.values())
    assert float(res.grad_norm) > 0 and 0.0 <= float(res.accuracy) <= 1.0
    assert res.loss_state.guided_att_steps == hp.guided_attention_steps - 1
    for name, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name
    assert not torch.equal(model.postnet.conv0.BatchNorm_0.running_mean,
                           before["postnet.conv0.BatchNorm_0.running_mean"])
    _, _, again = run()
    for k, v in res.losses.items():
        assert float(again.losses[k]) == float(v)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_train_step_runs_on_the_card_unless_asked(device):
    """``train_step`` runs on ``cuda`` by default: without a card it raises,
    and with one it refuses a model left on the CPU; it never trains there
    silently, and no parameter moves."""
    hp = port_hp(_hp())
    data = batch(_hp(), B, T, seed=4)
    target, tlen, stop = _targets(_hp())
    b = trainer.Batch(data[0], data[1], target, None, tlen, stop, data[2],
                      np.arange(B) % hp.language_number)
    model = ptac.init_random_weights(ptac.Tacotron(hp), 3)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt, sched = trainer.make_optimizer(model, hp)
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err, match="cuda|CUDA"):
        trainer.train_step(model, opt, sched, b,
                           ptac.TacotronLossState.init(hp),
                           torch.Generator().manual_seed(5), device=device)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
