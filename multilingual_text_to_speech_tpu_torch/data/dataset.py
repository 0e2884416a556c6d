"""Datasets over 8-field metafiles, spectrogram caches, corpus ingestion.

Port of the JAX package's ``data/dataset.py``: a dataset is a plain-Python
object over the same metafile format

    id|speaker|language|audio_path|mel_path|linear_path|text|phonemes

(and the 5-field ComVoi inventory form), so a corpus prepared by either
package loads in the other.  Spectrograms are cached ``.npy`` files in the
layout ``[bins, frames]`` and transposed to channels-last ``[frames,
bins]`` on load.  A spectrogram that is not cached is computed by the
port's ``ops.audio`` on the dataset's device: the card unless the caller
passes ``device="cpu"`` (``device.resolve_device`` raises without a card).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from multilingual_text_to_speech_tpu_torch.data import loaders
from multilingual_text_to_speech_tpu_torch.device import (
    DeviceLike,
    resolve_device,
)
from multilingual_text_to_speech_tpu_torch.ops import audio as audio_ops
from multilingual_text_to_speech_tpu_torch.ops.io import load_wav
from multilingual_text_to_speech_tpu_torch.text import SymbolTable
from multilingual_text_to_speech_tpu_torch.text.cleaners import (
    remove_odd_whitespaces,
    remove_punctuation,
    to_lower,
)


class TextToSpeechDataset:
    """Parse a metafile, clean + encode utterances, serve spectrograms
    (reference: dataset/dataset.py:55-190); spectrograms that are not
    cached are computed on ``device``."""

    def __init__(self, meta_file: str, dataset_root_dir: str, hp,
                 known_unique_speakers: Optional[List[str]] = None,
                 device: DeviceLike = None):
        self.root_dir = dataset_root_dir
        self.hp = hp
        self.device = resolve_device(device)
        self.unique_speakers: List[str] = list(known_unique_speakers or [])
        seen = set(self.unique_speakers)
        self.items: List[dict] = []

        with open(meta_file, "r", encoding="utf-8") as f:
            for line in f:
                tokens = line.rstrip("\n").split("|")
                if len(tokens) == 5:
                    # the short corpus-inventory format the reference ships
                    # for ComVoi (data/comvoi_clean/all.txt):
                    # id|speaker|language|audio|text — no spectrograms or
                    # phonemes yet (the reference's own Dataset cannot read
                    # it; accepting it here is a deliberate superset).
                    # Bare labels like '01' repeat across the per-language
                    # folders for DIFFERENT people — suffix the language so
                    # identities stay distinct, matching the convention of
                    # the trainable metafiles ('00-nl' in css_comvoi)
                    speaker = f"{tokens[1]}-{tokens[2]}"
                    tokens = ([tokens[0], speaker, tokens[2], tokens[3]]
                              + ["", "", tokens[4], ""])
                if len(tokens) < 8:
                    continue
                item = {
                    "id": tokens[0],
                    "speaker": tokens[1],
                    "language": tokens[2],
                    "audio": tokens[3],
                    "spectrogram": tokens[4],
                    "linear_spectrogram": tokens[5],
                    "text": tokens[6],
                    "phonemes": tokens[7],
                }
                if item["language"] in hp.languages:
                    if item["speaker"] not in seen:
                        seen.add(item["speaker"])
                        self.unique_speakers.append(item["speaker"])
                    self.items.append(item)

        # clean text (dataset.py:103-116)
        for item in self.items:
            text, phon = item["text"], item["phonemes"]
            if not hp.use_punctuation:
                text = remove_punctuation(text, hp)
                phon = remove_punctuation(phon, hp)
            if not hp.case_sensitive:
                text = to_lower(text)
            if hp.remove_multiple_wspaces:
                text = remove_odd_whitespaces(text)
                phon = remove_odd_whitespaces(phon)
            item["text"], item["phonemes"] = text, phon

        # encode to ID sequences / indices (dataset.py:118-123)
        char_table = SymbolTable(hp, use_phonemes=False)
        phon_table = SymbolTable(hp, use_phonemes=True)
        for item in self.items:
            item["phonemes"] = phon_table.encode(item["phonemes"])
            item["text"] = char_table.encode(item["text"])
            item["speaker"] = self.unique_speakers.index(item["speaker"])
            item["language"] = hp.languages.index(item["language"])

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int):
        """(speaker, language, sequence, mel [F, M], linear [F, bins] | None)."""
        hp = self.hp
        item = self.items[index]
        mel = self.load_spectrogram(
            item["audio"], item["spectrogram"], hp.normalize_spectrogram, True
        )
        linear = (
            self.load_spectrogram(
                item["audio"], item["linear_spectrogram"],
                hp.normalize_spectrogram, False,
            )
            if hp.predict_linear else None
        )
        seq = item["phonemes"] if hp.use_phonemes else item["text"]
        return item["speaker"], item["language"], seq, mel, linear

    def load_spectrogram(self, audio_path: str, spectrogram_path: str,
                         normalize: bool, is_mel: bool) -> np.ndarray:
        """Load a cached spectrogram or compute from audio
        (reference: dataset/dataset.py:135-163).  Returns [F, bins]."""
        hp = self.hp
        if hp.cache_spectrograms and spectrogram_path:
            S = np.load(os.path.join(self.root_dir, spectrogram_path))
        else:
            wav = load_wav(os.path.join(self.root_dir, audio_path), hp.sample_rate)
            S = audio_ops.spectrogram(wav, hp, mel=is_mel,
                                      device=self.device)
        expected = hp.num_mels if is_mel else hp.num_fft // 2 + 1
        assert S.shape[0] == expected, (
            f"Spectrogram dim mismatch: got {S.shape[0]}, expected {expected}"
        )
        if normalize:
            S = audio_ops.normalize_spectrogram(S, hp, is_mel)
        return S.T.astype(np.float32)  # channels-last

    def get_normalization_constants(self, is_mel: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Mean of per-item per-channel mean/std (reference: dataset.py:165-176).
        Returns arrays shaped [bins, 1] like the reference."""
        mean = 0.0
        std = 0.0
        for item in self.items:
            path = item["spectrogram"] if is_mel else item["linear_spectrogram"]
            S = self.load_spectrogram(item["audio"], path, False, is_mel).T
            mean = mean + np.mean(S, axis=1, keepdims=True)
            std = std + np.std(S, axis=1, keepdims=True)
        n = max(len(self.items), 1)
        return mean / n, std / n

    def get_num_speakers(self) -> int:
        return len({item["speaker"] for item in self.items})

    def get_num_languages(self) -> int:
        return len({item["language"] for item in self.items})


class TextToSpeechDatasetCollection:
    """train/dev(/test) datasets under one root
    (reference: dataset/dataset.py:14-52)."""

    def __init__(self, dataset_root_dir: str, hp,
                 training_file: str = "train.txt",
                 validation_file: str = "val.txt",
                 test_file: Optional[str] = None,
                 device: DeviceLike = None):
        train_path = os.path.join(dataset_root_dir, training_file)
        if not os.path.exists(train_path):
            raise IOError(f"Training meta-file not found: {train_path}")
        self.train = TextToSpeechDataset(train_path, dataset_root_dir, hp,
                                         device=device)

        val_path = os.path.join(dataset_root_dir, validation_file)
        if not os.path.exists(val_path):
            raise IOError(f"Validation meta-file not found: {val_path}")
        self.dev = TextToSpeechDataset(
            val_path, dataset_root_dir, hp, self.train.unique_speakers,
            device=device,
        )
        assert len(self.dev.unique_speakers) == len(self.train.unique_speakers), (
            "Validation set contains speakers not present in the train set!"
        )

        self.test = None
        if test_file:
            test_path = os.path.join(dataset_root_dir, test_file)
            if not os.path.exists(test_path):
                raise IOError(f"Test meta-file not found: {test_path}")
            self.test = TextToSpeechDataset(
                test_path, dataset_root_dir, hp, self.train.unique_speakers,
                device=device,
            )
            assert len(self.test.unique_speakers) == len(self.train.unique_speakers)


def create_meta_file(
    dataset_name: str,
    dataset_root_dir: str,
    output_metafile_name: str,
    hp,
    audio_sample_rate: int,
    num_fft_freqs: int,
    spectrograms: bool = True,
    phonemes: bool = True,
    progress=None,
    device: DeviceLike = None,
) -> str:
    """Full corpus ingestion: loader -> (optional) phoneme dicts ->
    mel+linear spectrogram cache -> metafile
    (reference: dataset/dataset.py:192-259).

    Spectrograms are computed on ``device`` (the card unless ``"cpu"``) and
    saved in the ``[bins, frames]`` .npy layout under spectrograms/ and
    linear_spectrograms/.
    """
    from multilingual_text_to_speech_tpu_torch.text.phonemize import (
        build_phoneme_dicts,
        to_phoneme,
    )

    dev = resolve_device(device) if spectrograms else None
    work_hp = hp.copy()
    work_hp.sample_rate = audio_sample_rate
    work_hp.num_fft = num_fft_freqs

    items = loaders.get_loader_by_name(dataset_name)(dataset_root_dir)

    phoneme_dicts: Dict[str, Dict[str, str]] = {}
    if phonemes:
        pairs = [
            (row[0], hp.languages[0] if row[3] == "" else row[3]) for row in items
        ]
        phoneme_dicts = build_phoneme_dicts(pairs, work_hp)

    if spectrograms:
        spec_dirs = [
            os.path.join(dataset_root_dir, "spectrograms"),
            os.path.join(dataset_root_dir, "linear_spectrograms"),
        ]
        for d in spec_dirs:
            os.makedirs(d, exist_ok=True)

    metafile_path = os.path.join(dataset_root_dir, output_metafile_name)
    with open(metafile_path, "w", encoding="utf-8") as f:
        for i, (raw_text, audio_path, speaker, language) in enumerate(items):
            if language == "":
                language = hp.languages[0]
            phonemized = (
                to_phoneme(raw_text, False, language, work_hp,
                           phoneme_dicts.get(language))
                if phonemes else ""
            )
            spectrogram_paths = "|"
            if spectrograms:
                name = f"{i:06}.npy"
                wav = load_wav(
                    os.path.join(dataset_root_dir, audio_path),
                    work_hp.sample_rate,
                )
                np.save(os.path.join(spec_dirs[0], name),
                        audio_ops.spectrogram(wav, work_hp, mel=True,
                                              device=dev))
                np.save(os.path.join(spec_dirs[1], name),
                        audio_ops.spectrogram(wav, work_hp, mel=False,
                                              device=dev))
                spectrogram_paths = (
                    os.path.join("spectrograms", name) + "|"
                    + os.path.join("linear_spectrograms", name)
                )
            print(
                f"{i:06}|{speaker}|{language}|{audio_path}|{spectrogram_paths}"
                f"|{raw_text}|{phonemized}",
                file=f,
            )
            if progress is not None:
                progress((i + 1) / len(items))
    return metafile_path
