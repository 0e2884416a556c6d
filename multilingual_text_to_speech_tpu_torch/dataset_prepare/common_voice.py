"""CommonVoice corpus acquisition and filtering.

Port of the JAX package's ``dataset_prepare/common_voice.py`` (the
reference model's ``dataset_prepare/normalize_comvoi.sh``):
download per-language archives, keep only ``validated.tsv`` entries with
zero down-votes, delete unreferenced clips.  Download URLs point at the
same cv-corpus-3/4 snapshots the reference used.

Network access is required only for ``download``; ``filter_language`` works
on an already-extracted tree.
"""

from __future__ import annotations

import csv
import os
import tarfile
import urllib.request
from glob import glob

_BASE4 = ("https://voice-prod-bundler-ee1969a6ce8178826482b88e843c335139bd3fb4"
          ".s3.amazonaws.com/cv-corpus-4-2019-12-10")
_BASE3 = ("https://voice-prod-bundler-ee1969a6ce8178826482b88e843c335139bd3fb4"
          ".s3.amazonaws.com/cv-corpus-3")

DOWNLOAD_URLS = {
    "ja": f"{_BASE4}/ja.tar.gz", "lv": f"{_BASE4}/lv.tar.gz",
    "pt": f"{_BASE4}/pt.tar.gz", "ta": f"{_BASE4}/ta.tar.gz",
    "ar": f"{_BASE4}/ar.tar.gz", "id": f"{_BASE4}/id.tar.gz",
    "en": f"{_BASE3}/en.tar.gz", "de": f"{_BASE3}/de.tar.gz",
    "fr": f"{_BASE3}/fr.tar.gz", "rw": f"{_BASE3}/rw.tar.gz",
    "cy": f"{_BASE3}/cy.tar.gz", "br": f"{_BASE3}/br.tar.gz",
    "cv": f"{_BASE3}/cv.tar.gz", "tr": f"{_BASE3}/tr.tar.gz",
    "tt": f"{_BASE3}/tt.tar.gz", "ky": f"{_BASE3}/ky.tar.gz",
    "ga": f"{_BASE3}/ga-IE.tar.gz", "kab": f"{_BASE3}/kab.tar.gz",
    "ca": f"{_BASE3}/ca.tar.gz", "zh": f"{_BASE3}/zh-CN.tar.gz",
    "sl": f"{_BASE3}/sl.tar.gz", "it": f"{_BASE3}/it.tar.gz",
    "nl": f"{_BASE3}/nl.tar.gz", "cnh": f"{_BASE3}/cnh.tar.gz",
    "eo": f"{_BASE3}/eo.tar.gz", "et": f"{_BASE3}/et.tar.gz",
    "fa": f"{_BASE3}/fa.tar.gz", "eu": f"{_BASE3}/eu.tar.gz",
    "es": f"{_BASE3}/es.tar.gz", "mn": f"{_BASE3}/mn.tar.gz",
    "sah": f"{_BASE3}/sah.tar.gz", "dv": f"{_BASE3}/dv.tar.gz",
    "sv": f"{_BASE3}/sv-SE.tar.gz", "ru": f"{_BASE3}/ru.tar.gz",
}


def download(language: str, target_dir: str) -> str:
    """Fetch and extract one language archive (requires network)."""
    lang_dir = os.path.join(target_dir, language)
    if os.path.isdir(lang_dir):
        print(f"Skipping {language}: already exists")
        return lang_dir
    os.makedirs(lang_dir, exist_ok=True)
    archive = os.path.join(lang_dir, f"{language}.tar.gz")
    urllib.request.urlretrieve(DOWNLOAD_URLS[language], archive)
    with tarfile.open(archive, "r:gz") as tf:
        tf.extractall(lang_dir)
    os.remove(archive)
    return lang_dir


def filter_language(lang_dir: str) -> int:
    """Keep only zero-downvote validated clips
    (normalize_comvoi.sh: awk over validated.tsv + clip pruning).
    Returns the number of clips kept."""
    validated = None
    for cand in glob(os.path.join(lang_dir, "**", "validated.tsv"),
                     recursive=True):
        validated = cand
        break
    if validated is None:
        raise FileNotFoundError(f"no validated.tsv under {lang_dir}")

    base = os.path.dirname(validated)
    keep_rows = []
    keep_files = set()
    with open(validated, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        down_idx = header.index("down_votes") if "down_votes" in header else 4
        path_idx = header.index("path") if "path" in header else 1
        for row in reader:
            if len(row) > down_idx and row[down_idx] == "0":
                keep_rows.append(row)
                keep_files.add(os.path.basename(row[path_idx]))

    with open(validated, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(header)
        writer.writerows(keep_rows)

    # drop other tsvs and unreferenced clips
    for tsv in glob(os.path.join(base, "*.tsv")):
        if os.path.basename(tsv) != "validated.tsv":
            os.remove(tsv)
    clips = os.path.join(base, "clips")
    if os.path.isdir(clips):
        for clip in os.listdir(clips):
            if clip not in keep_files:
                os.remove(os.path.join(clips, clip))
    return len(keep_rows)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--target", type=str, required=True)
    parser.add_argument("--languages", type=str, nargs="+",
                        default=sorted(DOWNLOAD_URLS))
    parser.add_argument("--filter_only", action="store_true")
    args = parser.parse_args(argv)

    for lang in args.languages:
        lang_dir = os.path.join(args.target, lang)
        if not args.filter_only:
            lang_dir = download(lang, args.target)
        kept = filter_language(lang_dir)
        print(f"{lang}: kept {kept} validated clips")


if __name__ == "__main__":
    main()
