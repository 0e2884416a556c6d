"""ASR transcription of synthesized wavs for CER evaluation.

Port of the JAX package's ``evaluation/asr.py`` (the reference model's
``evaluation/asr_request.py``): per eval metafile
entry, send ``<model>/audios/<language>/<idx>.wav`` to a speech recognizer
and store the result list as ``<model>/asr/<language>/<idx>.json``.

The Google Cloud Speech client is an optional dependency (network service);
any callable ``recognize_fn(path, language_code, sample_rate) -> list`` can
be plugged in (e.g. a local ASR) — the downstream CER scorer only needs the
``[{"alternatives": [{"transcript": ...}]}]`` shape.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

LANGUAGE_CODES = {
    "dutch": "nl-NL",
    "finnish": "fi-FI",
    "french": "fr-FR",
    "german": "de-DE",
    "greek": "el-GR",
    "hungarian": "hu-HU",
    "chinese": "zh",
    "japanese": "ja-JP",
    "russian": "ru-RU",
    "spanish": "es-ES",
}


def google_cloud_recognize(path: str, language_code: str,
                           sample_rate: int) -> Optional[List[dict]]:
    """Google Cloud Speech v1 recognition (reference: asr_request.py:21-40).
    Requires the optional google-cloud-speech package + credentials."""
    from google.cloud import speech_v1  # optional dependency
    from google.protobuf.json_format import MessageToDict

    client = speech_v1.SpeechClient()
    config = {"language_code": language_code, "sample_rate_hertz": sample_rate}
    with open(path, "rb") as f:
        audio = {"content": f.read()}
    response = MessageToDict(
        client.recognize(config, audio), preserving_proto_field_name=True
    )
    return response.get("results")


def transcribe_language(
    language: str, model: str, where: str, sample_rate: int = 22050,
    recognize_fn: Callable = google_cloud_recognize,
) -> int:
    """Transcribe every wav of a model/language pair; returns count written
    (reference: asr_request.py:67-89)."""
    count = 0
    meta_file = os.path.join(where, f"{language}.txt")
    if not os.path.exists(meta_file):
        meta_file = os.path.join(where, "all_meta_files", f"{language}.txt")
    with open(meta_file, "r", encoding="utf-8") as f:
        for line in f:
            idx = line.rstrip().split("|")[0]
            sound_path = os.path.join(
                where, model, "audios", language, f"{idx}.wav"
            )
            if not os.path.exists(sound_path):
                continue
            result = recognize_fn(
                sound_path, LANGUAGE_CODES[language], sample_rate
            )
            if result is None:
                continue
            out_dir = os.path.join(where, model, "asr", language)
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{idx}.json"), "w",
                      encoding="utf-8") as of:
                json.dump(result, of, ensure_ascii=False)
            count += 1
    return count


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--language", type=str, required=True)
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--where", type=str, required=True)
    parser.add_argument("--sample_rate", type=int, default=22050)
    args = parser.parse_args(argv)

    n = transcribe_language(
        args.language, args.model, args.where, args.sample_rate
    )
    print(f"Transcribed {n} utterances")


if __name__ == "__main__":
    main()
