"""Hyper-parameters of the PyTorch port.

A copy of the JAX package's ``HParams`` with the same keys and defaults, so
the bundled ``params/*.json`` overlays of either package load by path and a
checkpoint's embedded ``hp`` dict round-trips.  Keys that only steer the JAX
package's TPU paths (mesh sizes, the train decoder's Pallas switch, the flax
dropout RNG) are kept so those overlays load unchanged; the port reads
``compute_dtype``, ``decode_chunk_frames``, ``use_pallas_decoder`` and, when
it is set, ``pallas_decoder_int8`` and ``pallas_decoder_int8_streams`` (the
serving decoder's W8A8 gates and int8 streams) and ignores the rest.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Optional

import numpy as np

_DEFAULTS: Dict[str, Any] = {
    "version": "1.0",
    # training loop
    "epochs": 300,
    "batch_size": 52,
    "learning_rate": 1e-3,
    "learning_rate_decay": 0.5,
    "learning_rate_decay_start": 15000,
    "learning_rate_decay_each": 15000,
    "learning_rate_encoder": 1e-3,
    "weight_decay": 1e-6,
    "encoder_optimizer": False,
    "max_output_length": 5000,
    "gradient_clipping": 0.25,
    "reversal_gradient_clipping": 0.25,
    "guided_attention_loss": True,
    "guided_attention_steps": 20000,
    "guided_attention_toleration": 0.25,
    "guided_attention_gain": 1.00025,
    "constant_teacher_forcing": True,
    "teacher_forcing": 1.0,
    "teacher_forcing_steps": 100000,
    "teacher_forcing_start_steps": 50000,
    "checkpoint_each_epochs": 10,
    "parallelization": True,
    # dataset
    "dataset": "ljspeech",
    "cache_spectrograms": True,
    "languages": ["en-us"],
    "balanced_sampling": False,
    "perfect_sampling": False,
    # text
    "characters": "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz ",
    "case_sensitive": True,
    "remove_multiple_wspaces": True,
    "use_punctuation": True,
    "punctuations_out": '、。，"(),.:;¿?¡!\\',
    "punctuations_in": "'-",
    "use_phonemes": False,
    "phonemes": "ɹɐpbtdkɡfvθðszʃʒhmnŋlrwjeəɪɒuːɛiaʌʊɑɜɔx ",
    # model
    "embedding_dimension": 512,
    "encoder_type": "simple",
    "encoder_dimension": 512,
    "encoder_blocks": 3,
    "encoder_kernel_size": 5,
    "generator_dim": 8,
    "generator_bottleneck_dim": 4,
    "prenet_dimension": 256,
    "prenet_layers": 2,
    "attention_type": "location_sensitive",
    "attention_dimension": 128,
    "attention_kernel_size": 31,
    "attention_location_dimension": 32,
    "decoder_dimension": 1024,
    "decoder_regularization": "dropout",
    "zoneout_hidden": 0.1,
    "zoneout_cell": 0.1,
    "dropout_hidden": 0.1,
    "postnet_dimension": 512,
    "postnet_blocks": 5,
    "postnet_kernel_size": 5,
    "dropout": 0.5,
    "predict_linear": False,
    "cbhg_bank_kernels": 8,
    "cbhg_bank_dimension": 128,
    "cbhg_projection_kernel_size": 3,
    "cbhg_projection_dimension": 256,
    "cbhg_highway_dimension": 128,
    "cbhg_rnn_dim": 128,
    "cbhg_dropout": 0.0,
    "multi_speaker": False,
    "multi_language": False,
    "speaker_embedding_dimension": 32,
    "language_embedding_dimension": 4,
    "input_language_embedding": 4,
    "reversal_classifier": False,
    "reversal_classifier_type": "reversal",
    "reversal_classifier_dim": 256,
    "reversal_classifier_w": 1.0,
    "stop_frames": 5,
    "speaker_number": 0,
    "language_number": 0,
    # audio
    "sample_rate": 22050,
    "num_fft": 1102,
    "num_mels": 80,
    "num_mfcc": 13,
    "stft_window_ms": 50,
    "stft_shift_ms": 12.5,
    "griffin_lim_iters": 60,
    "griffin_lim_power": 1.5,
    "normalize_spectrogram": True,
    "use_preemphasis": True,
    "preemphasis": 0.97,
    # serving shapes: texts pad to a multiple of bucket_text_multiple and
    # the decoder runs decode_chunk_frames steps between early-exit checks
    "bucket_text_multiple": 32,
    "bucket_frame_multiple": 64,
    "decode_chunk_frames": 64,
    # "bfloat16" or "float32": matmul/conv inputs; carries stay float32
    "compute_dtype": "bfloat16",
    # JAX-package switches, kept so its overlays and checkpoints load
    "dropout_rng_impl": "rbg",
    "use_pallas_decoder": True,
    # W8A8 int8 LSTM gate products in the serving decoder
    "pallas_decoder_int8": True,
    "pallas_decoder_int8_streams": None,
    "use_pallas_train_decoder": True,
    "mesh_data_parallel": -1,
    "mesh_model_parallel": 1,
}

# attributes set at run time (speaker list, normalization statistics) that
# must survive the state_dict round-trip
_RUNTIME_KEYS = (
    "unique_speakers",
    "mel_normalize_mean",
    "mel_normalize_variance",
    "lin_normalize_mean",
    "lin_normalize_variance",
)


def _to_jsonable(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    return value


class HParams:
    """Mutable hyper-parameter bag with JSON overlay and state_dict
    round-trip (the same contract as the JAX package's ``HParams``)."""

    def __init__(self, **overrides: Any):
        for key, value in _DEFAULTS.items():
            setattr(self, key, copy.deepcopy(value))
        for key, value in overrides.items():
            setattr(self, key, value)

    def load_state_dict(self, d: Dict[str, Any]) -> "HParams":
        for key, value in d.items():
            setattr(self, key, value)
        return self

    def state_dict(self) -> Dict[str, Any]:
        return {k: _to_jsonable(v) for k, v in vars(self).items()
                if not k.startswith("_")}

    @classmethod
    def from_state_dict(cls, d: Dict[str, Any]) -> "HParams":
        return cls().load_state_dict(d)

    def overlay(self, json_path: str) -> "HParams":
        with open(json_path, "r", encoding="utf-8") as f:
            self.load_state_dict(json.load(f))
        return self

    @classmethod
    def from_json(cls, json_path: str) -> "HParams":
        return cls().overlay(json_path)

    def copy(self) -> "HParams":
        return HParams.from_state_dict(copy.deepcopy(self.state_dict()))

    def symbols_count(self) -> int:
        count = len(self.phonemes if self.use_phonemes else self.characters)
        if self.use_punctuation:
            count += len(self.punctuations_out) + len(self.punctuations_in)
        return count

    def total_symbols(self) -> int:
        """Alphabet plus PAD/EOS/UNK."""
        return self.symbols_count() + 3

    def decoder_input_dimension(self) -> int:
        """Encoder width plus the speaker and language embedding widths."""
        dim = self.encoder_dimension
        if self.multi_speaker:
            dim += self.speaker_embedding_dimension
        if self.multi_language:
            dim += self.language_embedding_dimension
        return dim

    def mel_normalization(self) -> Optional[tuple]:
        mean = getattr(self, "mel_normalize_mean", None)
        var = getattr(self, "mel_normalize_variance", None)
        if mean is None or var is None:
            return None
        return (np.asarray(mean, dtype=np.float32).reshape(-1, 1),
                np.asarray(var, dtype=np.float32).reshape(-1, 1))

    def lin_normalization(self) -> Optional[tuple]:
        mean = getattr(self, "lin_normalize_mean", None)
        var = getattr(self, "lin_normalize_variance", None)
        if mean is None or var is None:
            return None
        return (np.asarray(mean, dtype=np.float32).reshape(-1, 1),
                np.asarray(var, dtype=np.float32).reshape(-1, 1))


def flagship_hparams() -> HParams:
    """The flagship serving model: the generated (meta-learning) grouped-conv
    encoder over 5 languages, 16 speakers, location-sensitive attention and
    zoneout, at the default widths (embedding 512, encoder 256, decoder
    1024, prenet 256x2, attention 128/32/31, 80 mels).  The same topology
    as the JAX package's ``__graft_entry__._flagship_hp``."""
    hp = HParams()
    hp.encoder_type = "generated"
    hp.languages = ["de", "fr", "zh", "ru", "nl"]
    hp.multi_language = True
    hp.language_number = 5
    hp.multi_speaker = True
    hp.speaker_number = 16
    hp.encoder_dimension = 256
    hp.generator_dim = 10
    hp.generator_bottleneck_dim = 4
    hp.reversal_classifier = True
    hp.reversal_classifier_dim = 256
    hp.reversal_classifier_w = 0.125
    hp.balanced_sampling = True
    hp.perfect_sampling = True
    hp.decoder_regularization = "zoneout"
    return hp


# the multilingual overlays of the JAX package's params/shared_switching.json
# and params/separate_switching.json (the paper's shared and separate
# strategies on the code-switching corpus), copied key for key
_SWITCHING_CHARACTERS = (
    " abcdefghijklmnopqrstuvwxyzçèéßäöōǎǐíǒàáǔüèéìūòóùúāēěīâêôûñőűабвгдежзий"
    "клмнопрстуфхцчшщъыьэюяё")
_SWITCHING_COMMON: Dict[str, Any] = {
    "balanced_sampling": True,
    "batch_size": 50,
    "case_sensitive": False,
    "characters": _SWITCHING_CHARACTERS,
    "checkpoint_each_epochs": 5,
    "dataset": "css_comvoi",
    "epochs": 300,
    "languages": ["de", "fr", "zh", "ru", "nl"],
    "multi_language": True,
    "multi_speaker": True,
    "predict_linear": False,
    "speaker_embedding_dimension": 32,
}
_SHARED_SWITCHING: Dict[str, Any] = dict(
    _SWITCHING_COMMON,
    encoder_type="simple",
    language_embedding_dimension=4,
    learning_rate=0.001,
    learning_rate_decay_each=10000,
    learning_rate_decay_start=10000,
    reversal_classifier=True,
    reversal_classifier_dim=256,
    reversal_classifier_w=0.5,
    reversal_gradient_clipping=0.25,
    version="SHARED-SWITCHING",
)
_SEPARATE_SWITCHING: Dict[str, Any] = dict(
    _SWITCHING_COMMON,
    encoder_dimension=256,
    encoder_type="convolutional",
    language_embedding_dimension=0,
    learning_rate=0.0001,
    learning_rate_decay_each=15000,
    learning_rate_decay_start=15000,
    perfect_sampling=True,
    reversal_classifier=False,
    version="SEPARATE-SWITCHING",
)


def _switching(overlay: Dict[str, Any]) -> HParams:
    hp = HParams().load_state_dict(copy.deepcopy(overlay))
    # the published overlays leave both counts to the trainer, which takes
    # the languages' from their list and the speakers' from the data: 16
    # speakers, as for the flagship
    hp.language_number = len(hp.languages)
    hp.speaker_number = 16
    return hp


def shared_switching_hparams() -> HParams:
    """The paper's shared strategy on the code-switching corpus
    (``params/shared_switching.json``): the simple encoder (3 conv blocks
    and a BiLSTM, width 512) shared by 5 languages, a 4-wide language
    embedding on the decoder's memory (548 wide with the 32-wide speaker
    embedding), the reversal speaker classifier (256, weight 0.5), dropout
    cells in the decoder, 16 speakers."""
    return _switching(_SHARED_SWITCHING)


def separate_switching_hparams() -> HParams:
    """The paper's separate strategy on the code-switching corpus
    (``params/separate_switching.json``): the plain grouped convolutional
    encoder (width 256, one group a language, 5 languages), no language
    embedding on the memory (288 wide), no classifier, dropout cells in the
    decoder, 16 speakers."""
    return _switching(_SEPARATE_SWITCHING)
