"""The port's ``Trainer`` with the CBHG postnet against the JAX
package's, on the CPU in float32.

``tests/test_torch_trainer.py``'s tiny generated-encoder corpus with
``predict_linear`` (linear spectrograms cached beside the mels, their
normalization constants from the training set) and the CBHG at narrow
widths: both trainers run one epoch (3 steps) from the JAX init and
``evaluate`` (its free-running predictions turned into mels by
``linear_to_mel`` before the DTW-MCD), both save, each resumes the other's
file (the GTA CLIs are in ``tests/test_torch_cbhg_gta.py``).
The JAX decoder runs its XLA scan: dropout and zoneout are 0 (that scan
draws both from ``jax.random``); the port replays the JAX trainer's
teacher flags (``JaxDraws``).

Bounds (``tests/test_torch_trainer.py``'s): each step's losses and
gradient norm, the eval loss and each MCD within rtol 1e-4; the final
weights within atol 1e-4; the resumed weights and Adam moments
bit-identical.
"""

import os
import sys
import types

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.data import (
    TextToSpeechDatasetCollection as JaxData,
)
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.parallel import make_mesh
from multilingual_text_to_speech_tpu.training import Trainer as JaxTrainer
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.data import (
    TextToSpeechDatasetCollection,
)
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models.postnet import PostnetCBHG
from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer
from tests.corpus_utils import build_corpus_with_metafiles
from tests.test_torch_cbhg import BINS, CBHG
from tests.test_torch_trainer import (
    ATOL_WEIGHTS,
    RTOL,
    JaxDraws,
    _assert_same_adam,
    _hp,
    _jax_trainer_from,
    _jax_tree,
    _no_encoder_dropout,
    _recording,
    _records,
)

DATASET = "tiny_cbhg"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch, ``evaluate`` and ``save`` of both trainers."""
    from multilingual_text_to_speech_tpu.ops import audio as jax_audio
    from multilingual_text_to_speech_tpu_torch.ops import audio as port_audio

    base = str(tmp_path_factory.mktemp("cbhg"))
    root = os.path.join(base, "data", DATASET)
    mp = pytest.MonkeyPatch()
    mp.setenv("MTTS_PALLAS_TRAIN_DECODER", "off")
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
        jhp = _hp(predict_linear=True, zoneout_hidden=0.0, zoneout_cell=0.0,
                  dataset=DATASET, **CBHG)
        build_corpus_with_metafiles(root, jhp, n_per_lang=8)
        php = HParams.from_state_dict(jhp.state_dict())
        jt = JaxTrainer(jhp, JaxData(root, jhp),
                        mesh=make_mesh(devices=jax.devices()[:1]), seed=0,
                        log_dir=os.path.join(base, "jax_logs"),
                        checkpoint_dir=os.path.join(base, "jax_ckpt"))
        init = _jax_tree(jt.state)
        pt = Trainer(php, TextToSpeechDatasetCollection(root, php,
                                                        device="cpu"),
                     device="cpu", seed=0,
                     initial_state=params_from_jax(init),
                     draws=JaxDraws(jt.rng),
                     log_dir=os.path.join(base, "port_logs"),
                     checkpoint_dir=os.path.join(base, "port_ckpt"))
        _no_encoder_dropout(pt.model)
        pt.train_sampler._rng.set_state(jt.train_sampler._rng.get_state())
        steps = jt.train_epoch(), pt.train_epoch()
        # neither logs the evaluation (its Griffin-Lim render); the MCDs
        # are recorded instead
        loggers = jt.logger, pt.logger
        jt.logger = pt.logger = None
        eval_loss = jt.evaluate(), pt.evaluate()
        jt.logger, pt.logger = loggers
        yield types.SimpleNamespace(
            root=root, base=base, jhp=jhp, php=php, jt=jt, pt=pt, init=init,
            steps=steps, eval_loss=eval_loss, mcds=mcds,
            jax_ckpt=jt.save(eval_loss[0]), port_ckpt=pt.save(eval_loss[1]))
    finally:
        mp.undo()


def test_steps_match_jax(run):
    """The CBHG model trains: each step's loss terms (``mel_pos`` against
    the linear targets), total and gradient norm, and the weights after
    the epoch."""
    assert isinstance(run.pt.model.postnet, PostnetCBHG)
    assert run.steps == (3, 3)
    ref = _records(run.jt.logger, "train")
    got = _records(run.pt.logger, "train")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0, 1, 2]
    for r, g in zip(ref, got):
        for k in r:
            if k.startswith("loss_") or k in ("total_loss", "gradient_norm"):
                np.testing.assert_allclose(g[k], r[k], rtol=RTOL, err_msg=k)
    ref_w = params_from_jax(_jax_tree(run.jt.state))
    for name, t in run.pt.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), ref_w[name].numpy(),
                                       rtol=0, atol=ATOL_WEIGHTS,
                                       err_msg=name)
    np.testing.assert_allclose(run.php.lin_normalize_mean,
                               run.jhp.lin_normalize_mean, rtol=1e-6)
    assert len(run.php.lin_normalize_mean) == BINS


def test_evaluate_matches_jax(run):
    """``evaluate``'s summed loss and each sample's DTW-MCD on the linear
    predictions turned into mels."""
    np.testing.assert_allclose(run.eval_loss[1], run.eval_loss[0], rtol=RTOL)
    ref, got = run.mcds["jax"], run.mcds["port"]
    assert len(got) == len(ref) == 4
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_checkpoints_resume_across_packages(run, capsys):
    """The JAX ``Trainer`` from the port's file and the port's from the
    JAX one: epoch, step, every weight (the GRU's and the bank's) and the
    Adam moments and counts bit for bit, and no optimizer warning."""
    jt = _jax_trainer_from(run, run.port_ckpt)
    pt = Trainer(run.php.copy(), TextToSpeechDatasetCollection(
        run.root, run.php, device="cpu"), device="cpu", seed=0,
        from_checkpoint=run.jax_ckpt)
    assert "WARNING" not in capsys.readouterr().out
    for trained, resumed in ((run.pt, jt), (pt, run.jt)):
        assert int(resumed.state.step) == trained.step == 3
        ref = params_from_jax(_jax_tree(resumed.state))
        for name, t in trained.model.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                assert torch.equal(t, ref[name]), name
        _assert_same_adam(trained, resumed.state.opt_state, False)
    assert jt.epoch == run.pt.epoch + 1 and pt.epoch == run.jt.epoch + 1
