"""Romanization of Chinese (pinyin) and Japanese (romaji) transcripts.

Port of the JAX package's ``dataset_prepare/romanize.py`` (the reference
model's ``dataset_prepare/pinyin_convertor.py`` and
``mecab_convertor.py``): line filters converting stdin text for use in the
metafile's text column (the model trains on romanized zh/ja).

Backends (jieba+pinyin / MeCab+romkan) are optional host-side dependencies.

Usage:
    cat transcript.txt | python -m \
        multilingual_text_to_speech_tpu_torch.dataset_prepare.romanize --lang zh
"""

from __future__ import annotations

import sys


def to_pinyin(line: str) -> str:
    """Chinese -> pinyin with jieba word segmentation
    (reference: pinyin_convertor.py)."""
    import jieba  # optional dependency
    import pinyin  # optional dependency

    return " ".join(pinyin.get(w) for w in jieba.cut(line.rstrip()))


def to_romaji(line: str) -> str:
    """Japanese -> romaji via MeCab segmentation + kana reading + romkan
    (reference: mecab_convertor.py)."""
    import MeCab  # optional dependency
    import romkan  # optional dependency

    wakati = MeCab.Tagger("-Owakati")
    yomi = MeCab.Tagger("-Oyomi")
    return romkan.to_roma(yomi.parse(wakati.parse(line)))


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--lang", choices=["zh", "ja"], required=True)
    args = parser.parse_args(argv)

    convert = to_pinyin if args.lang == "zh" else to_romaji
    for line in sys.stdin:
        print(convert(line))


if __name__ == "__main__":
    main()
