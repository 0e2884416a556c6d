"""The port's ``Trainer`` against the JAX package's, on the CPU in float32.

On the tiny generated-encoder corpus of ``tests/test_training.py`` (two
languages, perfect sampling, B=4, zoneout) with multiple speakers and the
reversal classifier, the JAX ``Trainer`` and the port's run one epoch (3
steps) and ``evaluate``.  The port starts from the JAX trainer's initial
weights and replays the JAX trainer's draws (``JaxDraws``: each step's
teacher flags and decoder seeds, the evaluation's seeds and the logged
sample), with its train sampler at the JAX sampler's state.  Dropout is 0
(prenet, postnet, and the generated encoder's hard-coded 0.05, patched as
``tests/test_torch_training.py`` does): flax's dropout streams cannot be
replayed by torch.  The JAX decoder runs its fused kernel in interpret
mode, whose masks the port's plain K2/K3 reproduce from the same seeds.
TensorBoard is blocked (the loggers write ``metrics.jsonl`` alone), and
the JAX model's init runs jitted, once; the resumed JAX trainers start from
that init's values, which the checkpoint then overwrites.

Bounds: every loss term and the gradient norm of each step, the eval loss
and the MCD within rtol 1e-4 (float32 sums in another order; read up to
4e-6); the final weights and batch-norm statistics within atol 1e-4
(three steps of lr 1e-3; read up to 1.5e-5, on a bias whose gradient is
near zero, where Adam's normalized step turns rounding into sign); the
resumed weights, Adam moments, step and epoch bit-identical.
"""

import json
import os
import sys
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.data import (
    TextToSpeechDatasetCollection as JaxData,
)
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.parallel import make_mesh
from multilingual_text_to_speech_tpu.training import Trainer as JaxTrainer
from multilingual_text_to_speech_tpu_torch import parallel
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.data import (
    TextToSpeechDatasetCollection,
)
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.interop.optax_state import (
    optimizer_from_optax,
    optimizer_to_optax,
)
from multilingual_text_to_speech_tpu_torch.models.layers import (
    ConvBlockGenerated,
)
from multilingual_text_to_speech_tpu_torch.training import checkpoint
from multilingual_text_to_speech_tpu_torch.training.trainer import (
    Trainer,
    make_optimizer,
)
from tests.corpus_utils import build_corpus_with_metafiles, tiny_model_hp

RTOL = 1e-4
ATOL_WEIGHTS = 1e-4


class JaxDraws:
    """The JAX ``Trainer``'s draws, replayed from its key: a step splits
    off ``step_rng``, whose first half draws the teacher flags and whose
    second the decoder's two uint32 seeds (``models/decoder.py``); an eval
    batch splits off two keys; the logged sample one."""

    def __init__(self, key):
        self.key = key

    def _split(self, n=2):
        keys = jax.random.split(self.key, n)
        self.key = keys[0]
        return keys[1:]

    @staticmethod
    def _seeds(key):
        _, rng_steps = jax.random.split(key)
        return tuple(int(s) for s in np.asarray(
            jax.random.bits(rng_steps, (2,), jnp.uint32)))

    def train(self, frames, ratio):
        (step_rng,) = self._split()
        rng_tf, _ = jax.random.split(step_rng)
        teacher = np.asarray(jax.random.bernoulli(
            rng_tf, np.float32(ratio), (frames,)))
        return teacher.astype(int).tolist(), self._seeds(step_rng)

    def eval(self):
        k1, k2 = self._split(3)
        return self._seeds(k1), self._seeds(k2)

    def pick(self, n):
        (key,) = self._split()
        return int(jax.random.randint(key, (), 0, n))


def _hp(**over):
    return tiny_model_hp(
        languages=["german", "french"], multi_language=True,
        encoder_type="generated", balanced_sampling=True,
        perfect_sampling=True, batch_size=4, case_sensitive=False,
        guided_attention_steps=1000, decoder_regularization="zoneout",
        griffin_lim_iters=2, multi_speaker=True, reversal_classifier=True,
        compute_dtype="float32", dropout=0.0, bucket_text_multiple=32,
        **over)


def _jax_tree(state):
    return jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})


def _no_encoder_dropout(model):
    for m in model.modules():
        if isinstance(m, ConvBlockGenerated):
            m.dropout = 0.0


def _records(logger, kind):
    logger._jsonl.flush()
    with open(os.path.join(logger.log_dir, "metrics.jsonl"),
              encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _recording(module, log):
    """``module.mel_cepstral_distortion`` that appends each value to log."""
    inner = module.mel_cepstral_distortion

    def mcd(*a, **kw):
        log.append(inner(*a, **kw))
        return log[-1]
    return mcd


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch and ``evaluate`` of both trainers, then both save."""
    from multilingual_text_to_speech_tpu.ops import audio as jax_audio
    from multilingual_text_to_speech_tpu_torch.ops import audio as port_audio

    root = str(tmp_path_factory.mktemp("corpus"))
    tmp = str(tmp_path_factory.mktemp("runs"))
    mp = pytest.MonkeyPatch()
    mp.setenv("MTTS_PALLAS_TRAIN_DECODER", "interpret")
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    orig_enc = jtac.GeneratedConvolutionalEncoder
    mp.setattr(jtac, "GeneratedConvolutionalEncoder",
               lambda *a, **kw: orig_enc(*a, **{**kw, "dropout": 0.0}))
    mp.setattr(jtac.Tacotron, "init", lambda self, *a, **kw: jax.jit(
        nn.Module.init.__get__(self))(*a, **kw))
    mcds = {"jax": [], "port": []}
    mp.setattr(jax_audio, "mel_cepstral_distortion",
               _recording(jax_audio, mcds["jax"]))
    mp.setattr(port_audio, "mel_cepstral_distortion",
               _recording(port_audio, mcds["port"]))
    try:
        jhp = _hp()
        build_corpus_with_metafiles(root, jhp, n_per_lang=8)
        php = HParams.from_state_dict(jhp.state_dict())
        jt = JaxTrainer(jhp, JaxData(root, jhp),
                        mesh=make_mesh(devices=jax.devices()[:1]), seed=0,
                        log_dir=os.path.join(tmp, "jax_logs"),
                        checkpoint_dir=os.path.join(tmp, "jax_ckpt"))
        init = _jax_tree(jt.state)
        pt = Trainer(php, TextToSpeechDatasetCollection(root, php,
                                                        device="cpu"),
                     device="cpu", seed=0,
                     initial_state=params_from_jax(init),
                     draws=JaxDraws(jt.rng),
                     log_dir=os.path.join(tmp, "port_logs"),
                     checkpoint_dir=os.path.join(tmp, "port_ckpt"))
        _no_encoder_dropout(pt.model)
        # the JAX trainer drew its init batch: one pass of its sampler
        pt.train_sampler._rng.set_state(jt.train_sampler._rng.get_state())
        steps = jt.train_epoch(), pt.train_epoch()

        # the JAX evaluation without its logger (its Griffin-Lim render
        # compiles for long; the MCDs are recorded instead); the port's
        # logger call is replayed through the JAX logger for its keys
        jax_logger, jt.logger = jt.logger, None
        calls = []
        port_eval = pt.logger.evaluation

        def record(*a, **kw):
            calls.append((a, kw))
            port_eval(*a, **kw)
        pt.logger.evaluation = record
        eval_loss = jt.evaluate(), pt.evaluate()
        jt.logger = jax_logger
        (a, kw), = calls
        jax_logger.evaluation(*a, **kw)
        yield types.SimpleNamespace(
            root=root, tmp=tmp, jhp=jhp, php=php, jt=jt, pt=pt, init=init,
            steps=steps, eval_loss=eval_loss, mcds=mcds,
            jax_ckpt=jt.save(eval_loss[0]), port_ckpt=pt.save(eval_loss[1]))
    finally:
        mp.undo()


def test_steps_match_jax(run):
    """Each step's loss terms, total, gradient norm, learning rate and
    classifier accuracy, from both loggers' ``metrics.jsonl``."""
    assert run.steps == (3, 3)
    assert run.pt.step == int(run.jt.state.step) == 3
    ref = _records(run.jt.logger, "train")
    got = _records(run.pt.logger, "train")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0, 1, 2]
    for r, g in zip(ref, got):
        for k in r:
            if k.startswith("loss_") or k in ("total_loss", "gradient_norm",
                                              "lr"):
                np.testing.assert_allclose(g[k], r[k], rtol=RTOL, err_msg=k)
        assert g["classifier_acc"] == pytest.approx(r["classifier_acc"],
                                                    abs=1e-6)


def test_final_weights_match_jax(run):
    ref = params_from_jax(_jax_tree(run.jt.state))
    got = run.pt.model.state_dict()
    assert set(got) == set(ref)
    moved = 0
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0,
                                   atol=ATOL_WEIGHTS, err_msg=name)
        moved += not torch.equal(r, params_from_jax(run.init)[name])
    assert moved > len(ref) // 2


def test_eval_loss_and_mcd_match_jax(run):
    """``evaluate``'s summed loss, each sample's DTW-MCD and their mean
    (the logged ``mcd``)."""
    np.testing.assert_allclose(run.eval_loss[1], run.eval_loss[0], rtol=RTOL)
    ref, got = run.mcds["jax"], run.mcds["port"]
    assert len(got) == len(ref) == 4
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    (logged,) = _records(run.pt.logger, "eval")
    assert logged["mcd"] == pytest.approx(float(np.mean(ref)), rel=RTOL)
    assert set(run.pt.eval_seconds) == {"forced", "free", "mcd", "render"}


def test_metrics_jsonl_keys_match_jax(run):
    for kind in ("train", "eval"):
        ref = _records(run.jt.logger, kind)
        got = _records(run.pt.logger, kind)
        assert ref and len(got) == len(ref)
        assert all(set(g) == set(r) for g, r in zip(got, ref)), kind
    (ev,) = _records(run.pt.logger, "eval")
    assert ev["audio_generated_samples"] > 0 and ev["epoch"] == 1


def _port_moments(trainer):
    by_id = {id(p): n for n, p in trainer.model.named_parameters()}
    return {by_id[id(p)]: st for p, st in trainer.optimizer.state.items()}


def _jax_adam(opt_state, encoder_optimizer):
    """(count, mu, nu, schedule count) of a JAX trainer's optax state, the
    groups' masked trees merged."""
    inner = opt_state[1]
    if not encoder_optimizer:
        return (int(inner[1].count), inner[1].mu, inner[1].nu,
                int(inner[2].count))
    mu, nu = {}, {}
    for g in ("encoder", "other"):
        chain = inner.inner_states[g].inner_state
        for dst, tree in ((mu, chain[1].mu), (nu, chain[1].nu)):
            for k, v in tree.items():
                if k == "encoder" and g == "encoder" or (
                        k != "encoder" and g == "other"):
                    dst[k] = v
    return int(chain[1].count), mu, nu, int(chain[2].count)


def _assert_same_adam(port_trainer, jax_opt_state, encoder_optimizer):
    count, mu, nu, sched = _jax_adam(jax_opt_state, encoder_optimizer)
    mu = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, mu)})
    nu = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, nu)})
    states = _port_moments(port_trainer)
    for name, p in port_trainer.model.named_parameters():
        if not p.requires_grad:
            assert not mu[name].any() and not nu[name].any(), name
            continue
        st = states[name]
        assert int(st["step"]) == count
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
    assert port_trainer.scheduler.last_epoch == sched


@pytest.fixture(scope="module")
def encoder_group_run(run):
    """A port trainer with ``hp.encoder_optimizer`` (its own learning rate
    for the encoder) after one epoch, and its checkpoint."""
    php = HParams.from_state_dict(run.jhp.state_dict())
    php.encoder_optimizer = True
    php.learning_rate_encoder = 3e-3
    pt = Trainer(php, TextToSpeechDatasetCollection(run.root, php,
                                                    device="cpu"),
                 device="cpu", seed=1,
                 initial_state=params_from_jax(run.init),
                 checkpoint_dir=os.path.join(run.tmp, "port_enc_ckpt"))
    pt.train_epoch()
    return pt, pt.save(1.0)


def _jax_trainer_from(run, path, **over):
    """The JAX trainer resumed from ``path``; its model init returns the
    first JAX trainer's (the checkpoint overwrites every value)."""
    hp = run.jhp.copy()
    for k, v in over.items():
        setattr(hp, k, v)
    init = jax.tree_util.tree_map(jnp.asarray, run.init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtac.Tacotron, "init", lambda self, *a, **kw: init)
        return JaxTrainer(hp, JaxData(run.root, hp),
                          mesh=make_mesh(devices=jax.devices()[:1]), seed=0,
                          from_checkpoint=path)


@pytest.mark.parametrize("encoder_optimizer", [False, True])
def test_jax_trainer_resumes_port_checkpoint(run, encoder_group_run,
                                            encoder_optimizer, capsys):
    """The JAX ``Trainer`` from a port-written file: epoch + 1, the step,
    the weights and the Adam moments and counts, bit for bit, and no
    warning of a mismatched optimizer section."""
    pt, path = ((encoder_group_run) if encoder_optimizer
                else (run.pt, run.port_ckpt))
    jt = _jax_trainer_from(run, path, encoder_optimizer=encoder_optimizer,
                           learning_rate_encoder=pt.hp.learning_rate_encoder)
    assert "WARNING" not in capsys.readouterr().out
    assert jt.epoch == pt.epoch + 1
    assert int(jt.state.step) == pt.step == 3
    ref = params_from_jax(_jax_tree(jt.state))
    for name, t in pt.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(t, ref[name]), name
    _assert_same_adam(pt, jt.state.opt_state, encoder_optimizer)


@pytest.mark.parametrize("encoder_optimizer", [False, True])
def test_port_trainer_resumes_jax_checkpoint(run, encoder_group_run,
                                            encoder_optimizer, tmp_path,
                                            capsys):
    """The port's ``Trainer`` from a JAX-written file: the JAX run's own
    checkpoint, and (encoder groups) the one the JAX trainer writes after
    resuming the port's; epoch + 1, step, weights and moments bit for
    bit."""
    if encoder_optimizer:
        jt = _jax_trainer_from(
            run, encoder_group_run[1], encoder_optimizer=True,
            learning_rate_encoder=3e-3)
        jt.checkpoint_dir = str(tmp_path)
        path = jt.save(1.0)
        hp = run.php.copy()
        hp.encoder_optimizer, hp.learning_rate_encoder = True, 3e-3
    else:
        jt, path, hp = run.jt, run.jax_ckpt, run.php.copy()
    pt = Trainer(hp, TextToSpeechDatasetCollection(run.root, hp,
                                                   device="cpu"),
                 device="cpu", seed=0, from_checkpoint=path)
    assert "WARNING" not in capsys.readouterr().out
    assert pt.epoch == jt.epoch + 1 and pt.step == int(jt.state.step) == 3
    ref = params_from_jax(_jax_tree(jt.state))
    for name, t in pt.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(t, ref[name]), name
    _assert_same_adam(pt, jt.state.opt_state, encoder_optimizer)
    assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(
        (3e-3 if encoder_optimizer else 1e-3), rel=1e-12)


def test_port_resume_is_bit_identical(run):
    """The port's own file back into a new port trainer: every weight and
    buffer, every Adam state, the step, the schedule and the loss state."""
    pt = Trainer(run.php.copy(), run.pt.data, device="cpu", seed=0,
                 from_checkpoint=run.port_ckpt)
    assert (pt.epoch, pt.step) == (run.pt.epoch + 1, run.pt.step)
    saved = run.pt.model.state_dict()
    for name, t in pt.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(t, saved[name]), name
    a, b = _port_moments(run.pt), _port_moments(pt)
    assert set(a) == set(b)
    for name in a:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    assert pt.scheduler.last_epoch == run.pt.scheduler.last_epoch
    assert pt.loss_state == run.pt.loss_state


def test_mismatched_optimizer_section_warns_and_starts_fresh(run, tmp_path,
                                                            capsys):
    """An optimizer section that does not fit (here the empty one a bare
    ``save_checkpoint`` writes): the weights, step and epoch restore, the
    warning prints, and Adam starts from fresh moments."""
    path = str(tmp_path / "bare")
    checkpoint.save_checkpoint(
        path, epoch=4, step=9, state_dict=run.pt.model.state_dict(),
        hp=run.php, criterion_state=run.pt.loss_state.state_dict())
    pt = Trainer(run.php.copy(), run.pt.data, device="cpu", seed=0,
                 from_checkpoint=path)
    assert "WARNING: optimizer state in checkpoint does not match" in \
        capsys.readouterr().out
    assert (pt.epoch, pt.step) == (5, 9)
    assert not pt.optimizer.state and pt.scheduler.last_epoch == 0


@pytest.mark.parametrize("encoder_optimizer", [False, True])
def test_optax_section_round_trips(run, encoder_optimizer):
    """``optimizer_to_optax`` then ``optimizer_from_optax`` into a fresh
    optimizer: every state bit-identical; the section's nesting is the JAX
    chain's (``flax.serialization.from_state_dict`` takes it)."""
    from flax import serialization

    from multilingual_text_to_speech_tpu.training.trainer import (
        make_optimizer as jax_make_optimizer,
    )

    src = run.pt
    hp = run.php.copy()
    hp.encoder_optimizer = encoder_optimizer
    model = src.model
    opt, sched = make_optimizer(model, hp)
    by_name = _port_moments(src)       # the epoch's moments, in hp's groups
    for n, p in model.named_parameters():
        if n in by_name:
            opt.state[p] = {k: v.clone() for k, v in by_name[n].items()}
    sched.last_epoch = 7
    section = optimizer_to_optax(model, opt, sched, hp)
    jhp = run.jhp.copy()
    jhp.encoder_optimizer = encoder_optimizer
    template = jax_make_optimizer(jhp).init(run.init["params"])
    restored = serialization.from_state_dict(template, section)
    count, _, _, sched_count = _jax_adam(restored, encoder_optimizer)
    assert (count, sched_count) == (3, 7)

    opt2, sched2 = make_optimizer(model, hp)
    optimizer_from_optax(section, model, opt2, sched2, hp)
    assert sched2.last_epoch == 7
    by_id = {id(p): n for n, p in model.named_parameters()}
    a = {by_id[id(p)]: s for p, s in opt.state.items()}
    b = {by_id[id(p)]: s for p, s in opt2.state.items()}
    assert set(a) == set(b)
    for name in a:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    # the other setting's section does not fit
    other = run.php.copy()
    other.encoder_optimizer = not encoder_optimizer
    with pytest.raises((KeyError, ValueError, TypeError)):
        optimizer_from_optax(section, model, *make_optimizer(model, other),
                             other)


def test_trainer_needs_the_card_unless_asked(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(run.php.copy(), run.pt.data, seed=0)


def test_make_mesh_needs_the_card_unless_asked(run):
    """``parallel.make_mesh`` without a device puts the rank on the card, as
    every entry point of the port: without one it raises, and only
    ``device="cpu"`` gives the CPU, on which a trainer given that mesh
    and no device runs its steps."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(run.php)
    mesh = parallel.make_mesh(run.php, device="cpu")
    assert mesh.device == torch.device("cpu")
    pt = Trainer(run.php.copy(), run.pt.data, seed=0, mesh=mesh)
    assert pt.device == pt.mesh.device == torch.device("cpu")
    assert pt.train_epoch(max_steps=1) == 1
    assert all(p.device.type == "cpu" for p in pt.model.parameters())


def test_fit_saves_every_checkpoint_epochs_and_profiles(run, tmp_path):
    """``fit`` from a port checkpoint: two more epochs at
    ``checkpoint_each_epochs`` 1 write two files, the newest the last;
    ``profile_steps`` writes a ``torch.profiler`` trace and ``max_steps``
    cuts an epoch short."""
    hp = run.php.copy()
    hp.checkpoint_each_epochs = 1
    pt = Trainer(hp, run.pt.data, device="cpu", seed=0,
                 from_checkpoint=run.port_ckpt,
                 checkpoint_dir=str(tmp_path / "ckpt"))
    assert pt.train_epoch(profile_steps=1,
                          profile_dir=str(tmp_path / "prof")) == 3
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert pt.train_epoch(max_steps=2) == 2 and pt.step == 8
    pt.epoch += 1
    best = pt.fit(epochs=4)
    assert np.isfinite(best) and pt.epoch == 4 and pt.step == 14
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert len(files) == 2 and all(f.startswith("1.0_loss-") for f in files)
    latest = checkpoint.find_latest_checkpoint(str(tmp_path / "ckpt"))
    assert int(checkpoint.load_checkpoint(latest)["epoch"]) == 3
