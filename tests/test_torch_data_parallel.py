"""The port's data-parallel ``Trainer`` on two gloo ranks against the JAX
``Trainer`` on a two-device mesh, on the CPU in float32.

The setup of ``tests/test_torch_trainer.py`` (the tiny generated-encoder
corpus, two languages, perfect sampling, global batch 4, zoneout, multiple
speakers and the reversal classifier, dropout 0, the JAX decoder's fused
kernel in interpret mode): the JAX ``Trainer`` runs in this process on
``make_mesh(devices=jax.devices()[:2])``, where the decode runs per shard
through ``shard_map`` with the shard index folded into its key, and the
batch statistics and the loss are the global batch's.  The port's runs on
two processes (``tests/torch_dp_worker.py``), 2 rows a rank, from the JAX
init, with the JAX draws (the teacher flags once, each shard's seeds from
``fold_in``) replayed from a file, so that the workers import no JAX and
run while the JAX trainer does.

Bounds, those of ``tests/test_torch_trainer.py``: every step's loss terms
and gradient norm rtol 1e-4; the final weights and batch-norm statistics
atol 1e-4; the eval loss and each MCD rtol 1e-4.  The two ranks end
bit-identical (weights, statistics, Adam moments, eval loss); only rank 0
wrote ``metrics.jsonl`` and the checkpoint.  ``cli/train.py
--distributed --cpu`` under ``torch.distributed.run`` at two ranks trains
an epoch on the same corpus.  Every process has a timeout.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.data import (
    TextToSpeechDatasetCollection as JaxData,
)
from multilingual_text_to_speech_tpu.data.batching import batch_iterator
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.parallel import make_mesh
from multilingual_text_to_speech_tpu.training import Trainer as JaxTrainer
from multilingual_text_to_speech_tpu.training.schedule import (
    teacher_forcing_ratio,
)
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from tests.corpus_utils import build_corpus_with_metafiles
from tests.test_torch_trainer import (
    ATOL_WEIGHTS,
    RTOL,
    JaxDraws,
    _hp,
    _jax_tree,
    _records,
    _recording,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
WORLD = 2
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RecordingDraws(JaxDraws):
    """``JaxDraws`` that also keeps each shard's seeds, as the JAX decode
    derives them on the mesh: ``bits(fold_in(rng_steps, idx), (2,))``."""

    def __init__(self, key):
        super().__init__(key)
        self.shards = {}

    def _seeds(self, key):
        _, rng_steps = jax.random.split(key)
        seeds = tuple(int(s) for s in np.asarray(
            jax.random.bits(rng_steps, (2,), jnp.uint32)))
        for idx in range(WORLD):
            self.shards[(seeds, idx)] = tuple(int(s) for s in np.asarray(
                jax.random.bits(jax.random.fold_in(rng_steps, idx), (2,),
                                jnp.uint32)))
        return seeds


def _draws(jt, hp):
    """The JAX trainer's draws for its next epoch and evaluation, taken
    from copies of its samplers and key (the trainer itself untouched)."""
    draws = RecordingDraws(jt.rng)
    rec = {"train": [], "eval": [], "pick": []}
    train = batch_iterator(jt.data.train, copy.deepcopy(jt.train_sampler),
                           jt.collate)
    for step, batch in enumerate(train):
        frames = batch.mel_spectrograms.shape[1]
        ratio = teacher_forcing_ratio(hp, step)
        teacher, seeds = draws.train(frames, ratio)
        rec["train"].append((teacher, seeds, frames, ratio))
    last = None
    for batch in batch_iterator(jt.data.dev, copy.deepcopy(jt.eval_sampler),
                                jt.collate):
        rec["eval"].append(draws.eval())
        last = len(batch.utterances)
    rec["pick"].append((draws.pick(last), last))
    rec["shards"] = draws.shards
    return rec


def _workers(setup, out):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return [subprocess.Popen(
        [sys.executable, WORKER, setup, str(rank), str(WORLD), str(port),
         out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]


def _wait(procs):
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX trainer's epoch and evaluation on a two-device mesh beside
    the port's on two gloo ranks, from the same init and draws."""
    from multilingual_text_to_speech_tpu.ops import audio as jax_audio

    base = str(tmp_path_factory.mktemp("dp"))
    root = os.path.join(base, "data", "tiny")
    out = os.path.join(base, "port")
    mp = pytest.MonkeyPatch()
    mp.setenv("MTTS_PALLAS_TRAIN_DECODER", "interpret")
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    orig_enc = jtac.GeneratedConvolutionalEncoder
    mp.setattr(jtac, "GeneratedConvolutionalEncoder",
               lambda *a, **kw: orig_enc(*a, **{**kw, "dropout": 0.0}))
    mp.setattr(jtac.Tacotron, "init", lambda self, *a, **kw: jax.jit(
        nn.Module.init.__get__(self))(*a, **kw))
    jax_mcds = []
    mp.setattr(jax_audio, "mel_cepstral_distortion",
               _recording(jax_audio, jax_mcds))
    try:
        jhp = _hp(dataset="tiny", checkpoint_each_epochs=1)
        build_corpus_with_metafiles(root, jhp, n_per_lang=8)
        php = HParams.from_state_dict(jhp.state_dict())
        hp_path = os.path.join(base, "hp.json")
        with open(hp_path, "w", encoding="utf-8") as f:
            json.dump(php.state_dict(), f)
        jt = JaxTrainer(jhp, JaxData(root, jhp),
                        mesh=make_mesh(devices=jax.devices()[:WORLD]),
                        seed=0, log_dir=os.path.join(base, "jax_logs"))
        assert dict(jt.mesh.shape) == {"data": WORLD, "model": 1}
        init = _jax_tree(jt.state)
        setup = os.path.join(base, "setup.pt")
        torch.save({"hp": php.state_dict(), "root": root,
                    "init": params_from_jax(init),
                    "sampler_state": jt.train_sampler._rng.get_state(),
                    "draws": _draws(jt, jhp)}, setup)
        procs = _workers(setup, out)
        try:
            steps = jt.train_epoch()
            jax_logger, jt.logger = jt.logger, None
            eval_loss = jt.evaluate()
            jt.logger = jax_logger
        finally:
            _wait(procs)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        yield dict(base=base, root=root, hp_path=hp_path, jt=jt,
                   steps=steps, eval_loss=eval_loss, mcds=jax_mcds,
                   ranks=ranks, out=out)
    finally:
        mp.undo()


def _port_records(out, kind):
    (run_dir,) = os.listdir(os.path.join(out, "logs"))
    with open(os.path.join(out, "logs", run_dir, "metrics.jsonl"),
              encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_steps_match_jax(run):
    """Each step's loss terms, total, gradient norm, learning rate and
    classifier accuracy (rank 0's ``metrics.jsonl``: the sums of the
    ranks' contributions) against the JAX trainer's on its mesh."""
    r0 = run["ranks"][0]
    assert run["steps"] == r0["steps"] == 3 and r0["step"] == 3
    ref = _records(run["jt"].logger, "train")
    got = _port_records(run["out"], "train")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0, 1, 2]
    for r, g in zip(ref, got):
        for k in r:
            if k.startswith("loss_") or k in ("total_loss", "gradient_norm",
                                              "lr"):
                np.testing.assert_allclose(g[k], r[k], rtol=RTOL, err_msg=k)
        assert g["classifier_acc"] == pytest.approx(r["classifier_acc"],
                                                    abs=1e-6)


def test_final_weights_and_batch_statistics_match_jax(run):
    ref = params_from_jax(_jax_tree(run["jt"].state))
    got = run["ranks"][0]["state"]
    assert set(got) == set(ref)
    for name, r in ref.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0,
                                       atol=ATOL_WEIGHTS, err_msg=name)


def test_eval_loss_and_mcd_match_jax(run):
    """``evaluate`` on both ranks: the summed loss of the global batch and
    each sample's DTW-MCD (every rank scores the gathered batch)."""
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["eval_loss"], run["eval_loss"],
                                   rtol=RTOL)
        assert len(rank["mcds"]) == len(run["mcds"]) == 4
        np.testing.assert_allclose(rank["mcds"], run["mcds"], rtol=RTOL)


def test_ranks_end_bit_identical_and_only_rank0_writes(run):
    a, b = run["ranks"]
    assert a["state"].keys() == b["state"].keys()
    for name, t in a["state"].items():
        assert torch.equal(t, b["state"][name]), name
    assert a["moments"].keys() == b["moments"].keys()
    for name, st in a["moments"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], b["moments"][name][k]), (name, k)
    assert a["eval_loss"] == b["eval_loss"] and a["path"] == b["path"]
    assert (a["logs"], b["logs"]) == (True, False)
    assert len(os.listdir(os.path.join(run["out"], "logs"))) == 1
    assert os.listdir(os.path.join(run["out"], "ckpt")) == [
        os.path.basename(a["path"])]
    (ev,) = _port_records(run["out"], "eval")
    assert ev["audio_generated_samples"] > 0


def test_train_cli_distributed_trains_an_epoch(run):
    """``cli/train.py --distributed --cpu`` at two ranks under
    ``torch.distributed.run`` (through the worker's ``cli`` entry, which
    blocks TensorBoard): one epoch, one checkpoint, one log."""
    work = os.path.join(run["base"], "cli")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), WORKER, "cli", "--distributed",
         "--cpu", "--hyper_parameters", run["hp_path"], "--data_root",
         os.path.join(run["base"], "data"), "--base_directory", work,
         "--epochs", "1", "--logging_start", "0", "--flush_seconds", "0"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("backend gloo") == WORLD
    assert len(os.listdir(os.path.join(work, "checkpoints"))) == 1
    (run_dir,) = os.listdir(os.path.join(work, "logs"))
    with open(os.path.join(work, "logs", run_dir, "metrics.jsonl"),
              encoding="utf-8") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("train") == 3 and kinds.count("eval") == 1
