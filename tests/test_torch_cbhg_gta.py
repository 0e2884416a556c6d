"""The GTA CLI with the CBHG postnet: the port's against the JAX
package's, on the CPU in float32.

A checkpoint of a seeded CBHG model (``predict_linear``, the CBHG at
narrow widths, zoneout and dropout 0) over
``tests/test_torch_cbhg_trainer.py``'s corpus, written by the port's
``Trainer.save``; both ``cli/gta.py --cpu`` write one linear spectrogram
[552, F] a training item, denormalized, within rtol 1e-3, atol 1e-4 of each
other (``tests/test_torch_cli_train.py``'s bounds; the JAX GTA runs its
XLA scan).
"""

import os
import sys

import numpy as np
import pytest

from multilingual_text_to_speech_tpu.cli import gta as jax_gta
from multilingual_text_to_speech_tpu_torch.cli import gta
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.data import (
    TextToSpeechDatasetCollection,
)
from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer
from tests.corpus_utils import build_corpus_with_metafiles
from tests.test_torch_cbhg import BINS, CBHG
from tests.test_torch_trainer import _hp

DATASET = "tiny_cbhg"


@pytest.fixture(scope="module")
def checkpoint_path(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cbhg_gta"))
    root = os.path.join(base, "data", DATASET)
    jhp = _hp(predict_linear=True, zoneout_hidden=0.0, zoneout_cell=0.0,
              dataset=DATASET, **CBHG)
    build_corpus_with_metafiles(root, jhp, n_per_lang=8)
    php = HParams.from_state_dict(jhp.state_dict())
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        pt = Trainer(php, TextToSpeechDatasetCollection(root, php,
                                                        device="cpu"),
                     device="cpu", seed=3,
                     checkpoint_dir=os.path.join(base, "ckpt"))
    return os.path.dirname(root), pt.save(0.0)


def test_gta_writes_linear_spectrograms_as_jax(checkpoint_path, tmp_path):
    """One [552, F] linear spectrogram a training item, the same names and
    values."""
    data_root, path = checkpoint_path
    gta.main(["--checkpoint", path, "--data_root", data_root,
              "--output", str(tmp_path / "port"), "--cpu"])
    jax_gta.main(["--checkpoint", path, "--data_root", data_root,
                  "--output", str(tmp_path / "jax"), "--cpu"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 12
    for n in names:
        got = np.load(tmp_path / "port" / n)
        ref = np.load(tmp_path / "jax" / n)
        assert got.shape == ref.shape and got.shape[0] == BINS
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4,
                                   err_msg=n)
