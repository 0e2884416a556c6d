"""Corpus loaders: turn raw dataset trees into ``[text, audio, speaker,
language]`` rows.

A copy of the JAX package's ``data/loaders.py``: the same six corpora with
the same directory conventions.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List, Optional

Row = List[str]  # [text, audio_relative_path, speaker, language]


def get_loader_by_name(name: str):
    """Dispatch by corpus name (reference: dataset/loaders.py:6-9)."""
    loaders = {
        "vctk": vctk,
        "mailabs": mailabs,
        "css10": css10,
        "my_blizzard": my_blizzard,
        "ljspeech": ljspeech,
        "my_common_voice": my_common_voice,
    }
    try:
        return loaders[name.lower()]
    except KeyError:
        raise ValueError(
            f"No loader for dataset '{name}'; known: {sorted(loaders)}"
        )


def _assert_audio(root: str, rel: str) -> None:
    full = os.path.join(root, rel)
    assert os.path.isfile(full), (
        f"metafile points at a missing audio file: {full}")


def vctk(root_path: str, meta_files: Optional[list] = None) -> List[Row]:
    """VCTK layout: txt/<spk>/<spk>_<utt>.txt + wav48/<spk>/<spk>_<utt>.wav
    (reference: dataset/loaders.py:12-29)."""
    if meta_files is None:
        meta_files = glob(f"{root_path}/txt/**/*.txt", recursive=True)
    meta_files = sorted(meta_files)
    items: List[Row] = []
    for meta_file in meta_files:
        file_name = os.path.basename(meta_file).split(".")[0]
        speaker = file_name.split("_")[0]
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.read()
        audio = os.path.join("wav48", speaker, file_name + ".wav")
        _assert_audio(root_path, audio)
        items.append([text.rstrip("\n"), audio, speaker, ""])
    return items


def mailabs(root_path: str, meta_files: Optional[list] = None) -> List[Row]:
    """M-AILABS layout: <lang>/by_book/<gender>/<speaker>/<book>/metadata.csv
    (reference: dataset/loaders.py:32-51)."""
    if meta_files is None:
        meta_files = glob(f"{root_path}/*/*/*/*/metadata.csv", recursive=True)
    meta_files = sorted(meta_files)
    items: List[Row] = []
    for meta_file in meta_files:
        book_dir = os.path.dirname(meta_file)
        speaker_dir = os.path.dirname(book_dir)
        language_dir = os.path.dirname(os.path.dirname(speaker_dir))
        speaker = os.path.basename(speaker_dir)
        language = os.path.basename(language_dir)
        with open(meta_file, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip("\n").split("|")
                audio = os.path.join(
                    os.path.relpath(book_dir, root_path), "wavs", cols[0] + ".wav"
                )
                _assert_audio(root_path, audio)
                items.append([cols[2], audio, speaker, language])
    return items


def css10(root_path: str, meta_files: Optional[list] = None) -> List[Row]:
    """CSS10 layout: <language>/transcript.txt; speaker := language
    (reference: dataset/loaders.py:54-71)."""
    if meta_files is None:
        meta_files = glob(f"{root_path}/*/transcript.txt", recursive=True)
    meta_files = sorted(meta_files)
    items: List[Row] = []
    for meta_file in meta_files:
        language = os.path.basename(os.path.dirname(meta_file))
        with open(meta_file, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip().split("|")
                audio = os.path.join(language, cols[0])
                _assert_audio(root_path, audio)
                items.append([cols[2], audio, language, language])
    return items


def my_blizzard(root_path: str, meta_files: Optional[list] = None) -> List[Row]:
    """Blizzard 2013 layout: transcripts/**/*.txt + segments/
    (reference: dataset/loaders.py:74-96)."""
    if meta_files is None:
        meta_files = glob(f"{root_path}/transcripts/**/*.txt", recursive=False)
    meta_files = sorted(meta_files)
    items: List[Row] = []
    for transcript in meta_files:
        folder = os.path.dirname(transcript)
        filename = os.path.splitext(os.path.basename(transcript))[0]
        segments_folder = folder.replace(f"{root_path}/transcripts", "segments")
        with open(transcript, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip("\n").split("|")
                audio = os.path.join(segments_folder, f"{filename}-{cols[0]}.wav")
                _assert_audio(root_path, audio)
                items.append([cols[1], audio, "", ""])
    return items


def ljspeech(root_path: str, meta_file: Optional[str] = None) -> List[Row]:
    """LJ Speech layout: metadata.csv + wavs/
    (reference: dataset/loaders.py:99-115)."""
    txt_file = meta_file or os.path.join(root_path, "metadata.csv")
    assert os.path.isfile(txt_file), f"Dataset meta-file not found: {txt_file}"
    items: List[Row] = []
    with open(txt_file, "r", encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            audio = os.path.join("wavs", cols[0] + ".wav")
            _assert_audio(root_path, audio)
            items.append([cols[2], audio, "", ""])
    return items


def my_common_voice(root_path: str, meta_files: Optional[list] = None) -> List[Row]:
    """Cleaned CommonVoice layout: <lang>/meta.csv + <lang>/wavs/<spk>/
    (reference: dataset/loaders.py:118-135)."""
    if meta_files is None:
        meta_files = glob(f"{root_path}/*/meta.csv", recursive=True)
    meta_files = sorted(meta_files)
    items: List[Row] = []
    for meta_file in meta_files:
        language = os.path.basename(os.path.dirname(meta_file))
        with open(meta_file, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip().split("|")
                speaker = cols[0]
                audio = os.path.join(language, "wavs", cols[0], cols[1])
                _assert_audio(root_path, audio)
                items.append([cols[2], audio, speaker, language])
    return items
