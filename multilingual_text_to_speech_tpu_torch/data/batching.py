"""Bucketed batching: dataset items -> one padded ``Batch``.

A copy of the JAX package's ``data/batching.py``: batches pad to bucket
boundaries (``hp.bucket_text_multiple``, ``hp.bucket_frame_multiple``)
instead of the batch's maximum, so the training step sees a small, fixed
set of shapes.  Language conditioning is a ``[B]`` index vector.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np


class Batch(NamedTuple):
    """One padded training batch (channels-last spectrograms)."""

    utterances: np.ndarray            # [B, T] int32
    utterance_lengths: np.ndarray     # [B] int32
    mel_spectrograms: np.ndarray      # [B, F, num_mels] float32
    linear_spectrograms: Optional[np.ndarray]  # [B, F, bins] or None
    spectrogram_lengths: np.ndarray   # [B] int32
    stop_tokens: np.ndarray           # [B, F] float32
    speakers: Optional[np.ndarray]    # [B] int32 or None
    languages: Optional[np.ndarray]   # [B] int32 or None


def _bucket(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class Collate:
    """Pad a list of dataset items into one bucketed Batch.

    stop-token targets are 1 on the last ``hp.stop_frames`` frames AND on all
    padding (matching the reference, where padded logits are forced to 1000
    so padded positions contribute ~zero loss; dataset.py:320)."""

    def __init__(self, hp, sort_by_text_length: bool = False):
        self.hp = hp
        self.sort_by_text_length = sort_by_text_length

    def __call__(self, items: List[tuple]) -> Batch:
        hp = self.hp
        b = len(items)

        utt_lengths = np.asarray([len(it[2]) for it in items], np.int32)
        spec_lengths = np.asarray([it[3].shape[0] for it in items], np.int32)

        order = np.arange(b)
        if self.sort_by_text_length:
            order = np.argsort(-utt_lengths)

        t_max = _bucket(int(utt_lengths.max()), hp.bucket_text_multiple)
        f_max = _bucket(int(spec_lengths.max()), hp.bucket_frame_multiple)

        utterances = np.zeros((b, t_max), np.int32)
        mels = np.zeros((b, f_max, hp.num_mels), np.float32)
        linears = (
            np.zeros((b, f_max, hp.num_fft // 2 + 1), np.float32)
            if hp.predict_linear else None
        )
        stop_tokens = np.ones((b, f_max), np.float32)
        speakers = np.zeros(b, np.int32) if hp.multi_speaker else None
        languages = np.zeros(b, np.int32) if hp.multi_language else None

        for out_i, idx in enumerate(order):
            speaker, language, seq, mel, linear = items[idx]
            n, f = len(seq), mel.shape[0]
            utterances[out_i, :n] = seq
            mels[out_i, :f] = mel
            if linears is not None and linear is not None:
                linears[out_i, :f] = linear
            stop_tokens[out_i, : max(f - hp.stop_frames, 0)] = 0.0
            if speakers is not None:
                speakers[out_i] = speaker
            if languages is not None:
                languages[out_i] = language

        return Batch(
            utterances=utterances,
            utterance_lengths=utt_lengths[order],
            mel_spectrograms=mels,
            linear_spectrograms=linears,
            spectrogram_lengths=spec_lengths[order],
            stop_tokens=stop_tokens,
            speakers=speakers,
            languages=languages,
        )


def batch_iterator(dataset, sampler, collate: Collate) -> Iterator[Batch]:
    """Sampler indices -> dataset items -> collated batches."""
    for indices in sampler:
        yield collate([dataset[i] for i in indices])
