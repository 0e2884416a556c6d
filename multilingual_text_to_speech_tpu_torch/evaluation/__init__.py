"""Offline evaluation harness: CER-via-ASR and MCD with confidence intervals.

Port of the JAX package's ``evaluation/`` (the reference model's
``evaluation/``) — the measurement pipeline behind
the paper's tables: synthesize eval sentence sets, transcribe with a cloud
ASR, score character error rate and mel cepstral distortion per language.
"""

from multilingual_text_to_speech_tpu_torch.evaluation.cer import (
    confidence_interval,
    levenshtein,
    sample_cer,
)
from multilingual_text_to_speech_tpu_torch.evaluation.mcd import (
    mel_cepstral_distortion_specs,
)

__all__ = [
    "levenshtein", "sample_cer", "confidence_interval",
    "mel_cepstral_distortion_specs",
]
