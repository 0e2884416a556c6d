"""The port's prepare, train and GTA CLIs on the CPU, in-process.

On a tiny generated-encoder corpus (two languages, perfect sampling,
float32, dropout 0): ``cli/prepare.py --cpu`` writes the metafile the JAX
CLI writes; ``cli/train.py --cpu`` trains an epoch, saves, and ``--resume``
goes on from the newest checkpoint; ``cli/gta.py --cpu`` on that
checkpoint writes one ``{serial:05}-{speaker}.npy`` per training item in
[bins, F], within rtol 1e-3, atol 1e-4 of the JAX ``cli/gta.py``'s on the
same file (``tests/test_torch_synthesis.py``'s bounds: the JAX GTA runs its
XLA scan, whose prenet dropout is 0 here).  Without ``--cpu`` and without
a card each CLI raises.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.cli import gta as jax_gta
from multilingual_text_to_speech_tpu.cli import prepare as jax_prepare
from multilingual_text_to_speech_tpu_torch.cli import gta, prepare, train
from multilingual_text_to_speech_tpu_torch.training import checkpoint
from tests.corpus_utils import make_css10_corpus, tiny_model_hp

DATASET = "tiny_css10"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A corpus under ``data/<hp.dataset>`` made by the port's prepare CLI
    (and a copy by the JAX one), split into train/val, and the
    hyper-parameters as JSON."""
    base = str(tmp_path_factory.mktemp("work"))
    root = os.path.join(base, "data", DATASET)
    make_css10_corpus(root, n_per_lang=8)
    jroot = os.path.join(base, "jax_data")
    shutil.copytree(root, jroot)
    hp = tiny_model_hp(
        languages=["german", "french"], multi_language=True,
        multi_speaker=True, encoder_type="generated", balanced_sampling=True,
        perfect_sampling=True, batch_size=4, case_sensitive=False,
        decoder_regularization="zoneout", griffin_lim_iters=2,
        compute_dtype="float32", dropout=0.0, checkpoint_each_epochs=1,
        dataset=DATASET, bucket_text_multiple=32)
    hp_path = os.path.join(base, "hp.json")
    with open(hp_path, "w", encoding="utf-8") as f:
        json.dump(hp.state_dict(), f)
    common = ["--dataset", "css10", "--no_phonemes", "--hyper_parameters",
              hp_path]
    prepare.main(common + ["--root", root, "--cpu"])
    jax_prepare.main(common + ["--root", jroot])
    lines = open(os.path.join(root, "all.txt"), encoding="utf-8"
                 ).read().splitlines()
    for name, keep in (("train.txt", lambda i: i % 4 != 3),
                       ("val.txt", lambda i: i % 4 == 3)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(l for i, l in enumerate(lines) if keep(i))
                    + "\n")
    return base, root, jroot, hp_path


def test_prepare_cli_writes_the_jax_metafile(workspace):
    _, root, jroot, _ = workspace
    with open(os.path.join(root, "all.txt"), encoding="utf-8") as f:
        got = f.read()
    with open(os.path.join(jroot, "all.txt"), encoding="utf-8") as f:
        assert got == f.read()
    assert len(got.splitlines()) == 16
    mel = np.load(os.path.join(root, got.splitlines()[0].split("|")[4]))
    assert mel.shape[0] == 20 and np.isfinite(mel).all()


@pytest.fixture(scope="module")
def trained(workspace):
    """``cli/train.py --cpu`` for one epoch, then ``--resume`` to two
    (TensorBoard blocked: the logger writes ``metrics.jsonl`` alone)."""
    base, _, _, hp_path = workspace
    args = ["--base_directory", base, "--data_root",
            os.path.join(base, "data"), "--cpu", "--seed", "3"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        train.main(args + ["--hyper_parameters", hp_path, "--epochs", "1"])
        ckpt_dir = os.path.join(base, "checkpoints")
        first = sorted(os.listdir(ckpt_dir))
        train.main(args + ["--resume", "--epochs", "2"])
    return base, ckpt_dir, first


def test_train_cli_trains_saves_and_resumes(trained):
    base, ckpt_dir, first = trained
    assert len(first) == 1
    files = sorted(os.listdir(ckpt_dir))
    assert len(files) == 2 and first[0] in files
    payload = checkpoint.load_checkpoint(
        checkpoint.find_latest_checkpoint(ckpt_dir))
    # 6 training items a language at 2 a batch: 3 steps an epoch
    assert (int(payload["epoch"]), int(payload["step"])) == (1, 6)
    assert payload["hp"].dataset == DATASET
    assert payload["hp"].mel_normalization() is not None
    assert payload["optimizer"]["1"]["1"]["count"] == 6
    records = []
    for d in sorted(os.listdir(os.path.join(base, "logs"))):
        with open(os.path.join(base, "logs", d, "metrics.jsonl"),
                  encoding="utf-8") as f:
            records += [json.loads(l) for l in f]
    # --logging_start 1: the first epoch's steps are not logged
    assert sorted(r["step"] for r in records if r["kind"] == "train") == [
        3, 4, 5]
    assert sorted(r["epoch"] for r in records if r["kind"] == "eval") == [
        1, 2]


def test_gta_cli_matches_jax(trained, tmp_path):
    base, ckpt_dir, _ = trained
    path = checkpoint.find_latest_checkpoint(ckpt_dir)
    data_root = os.path.join(base, "data")
    gta.main(["--checkpoint", path, "--data_root", data_root, "--output",
              str(tmp_path / "port"), "--cpu"])
    jax_gta.main(["--checkpoint", path, "--data_root", data_root,
                  "--output", str(tmp_path / "jax"), "--cpu"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 12          # one file per training item
    assert {n.split("-", 1)[1] for n in names} == {"german.npy",
                                                   "french.npy"}
    for n in names:
        got = np.load(tmp_path / "port" / n)
        ref = np.load(tmp_path / "jax" / n)
        assert got.shape == ref.shape and got.shape[0] == 20
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("cli", ["prepare", "train", "gta"])
def test_clis_need_the_card_unless_asked(cli, trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    base, ckpt_dir, _ = trained
    argv = {"prepare": [prepare.main, "--dataset", "css10", "--root",
                        str(tmp_path)],
            "train": [train.main, "--base_directory", str(tmp_path),
                      "--data_root", os.path.join(base, "data"),
                      "--checkpoint_root", ckpt_dir, "--resume"],
            "gta": [gta.main, "--checkpoint",
                    checkpoint.find_latest_checkpoint(ckpt_dir),
                    "--data_root", os.path.join(base, "data"), "--output",
                    str(tmp_path)]}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        argv[0](argv[1:])


def test_train_cli_refuses_distributed(workspace, monkeypatch):
    """``--distributed`` outside ``torch.distributed.run`` (no rank in the
    environment) raises before it trains; ``tests/test_torch_data_parallel
    .py`` runs it under the launcher."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train.main(["--distributed", "--cpu"])
