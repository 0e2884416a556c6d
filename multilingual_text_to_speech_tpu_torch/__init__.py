"""PyTorch port of the multilingual Tacotron 2 framework for NVIDIA Hopper.

The JAX package ``multilingual_text_to_speech_tpu`` beside it is the
reference; this package imports nothing of it.  It covers batched serving
synthesis (encoder, decoder with its step as hand-written CUDA kernels in
``ops/fused_decoder.py``, postnet) and the training step
(``training/trainer.py::train_step``: the train-mode forward, the loss, the
teacher-forced decoder's forward and backward as hand-written CUDA kernels
in ``ops/fused_train_decoder.py``, clipping and Adam) and the training
runtime around it (``data/``, ``training/trainer.py::Trainer``, the
prepare, train and GTA CLIs, data parallel over processes in
``parallel/``), for the flagship model and for every encoder
of the paper's parameter-sharing strategies (``shared_switching_hparams``,
``separate_switching_hparams``).
"""

from multilingual_text_to_speech_tpu_torch.config import (
    HParams,
    flagship_hparams,
    separate_switching_hparams,
    shared_switching_hparams,
)
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

__all__ = ["HParams", "flagship_hparams", "shared_switching_hparams",
           "separate_switching_hparams", "Synthesizer"]
