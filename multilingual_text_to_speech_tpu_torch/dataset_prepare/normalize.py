"""Transcript normalization for CSS10 and M-AILABS.

Port of the JAX package's ``dataset_prepare/normalize.py`` (the reference
model's ``dataset_prepare/normalize_css10.sh`` and
``normalize_mailabs.sh``) — the sed pipelines that clean raw transcripts
(rare-character substitution, punctuation collapsing, dash cleanup) before
metafile creation.

Usage:
    python -m multilingual_text_to_speech_tpu_torch.dataset_prepare.normalize \
        --corpus css10 --root /data/css10
"""

from __future__ import annotations

import os
import re
from glob import glob

# rare-character substitutions (normalize_css10.sh:15-32)
_CSS10_CHAR_MAP = [
    (r"[―—－–]", "-"),
    (r"œ", "oe"),
    (r"æ", "ae"),
    (r"々", ""),
    (r"å", "a"),
    (r"ǚ", "u"),
    (r"ǜ", "u"),
    (r"ë", "e"),
    (r"[îïΐ]", "í"),
    (r"ϋ", "υ"),
    (r"ϊ", "ι"),
    (r"！", "!"),
    (r"：", ":"),
    (r"；", ";"),
    (r"？", "?"),
    (r"·", "."),
    (r"’", "'"),
]


def normalize_css10_text(text: str) -> str:
    """Clean one CSS10 transcript line's text field."""
    for pattern, repl in _CSS10_CHAR_MAP:
        text = re.sub(pattern, repl, text)
    # remove spaces before sentence punctuation
    text = re.sub(r"\s+([、。，?!,\.:;]+)", r"\1", text)
    # collapse repeated sentence ends
    text = re.sub(r":(\s*[、。，?!,\.:;]+)+", ":", text)
    text = re.sub(r"([?!;\.,])[?!;\.,]+", r"\1", text)
    # comma-dash tightening
    text = re.sub(r",\s+-", ",-", text)
    # runs of dashes
    text = re.sub(r"(\s+)(-+\s*)(-+\s*)+", r"\1", text)
    text = re.sub(r"(\s+)(-+\s*)(-+\s*)+", r"\1", text)
    # lone dash surrounded by sentence ends
    text = re.sub(r"^([^\-]*)-[ \.?!]+([^\-]*)$", r"\1\2", text)
    text = re.sub(r"^([^\-]*)[ \.?!]+-([^\-]*)$", r"\1\2", text)
    # leading punctuation
    text = re.sub(r"^\s*([、。，?!,\.:;\-]+\s*)+", "", text)
    # minus after sentence end
    text = re.sub(r"([¿?!¡\.:;]\s*)-+\s*", r"\1", text)
    # collapse whitespace
    return " ".join(text.split())


def _is_punct_only(text: str) -> bool:
    return re.fullmatch(r"(\s*[、。，(),\.:;¿?¡!\-])*\s*", text) is not None


def normalize_css10_transcript(path: str) -> int:
    """Rewrite a CSS10 transcript.txt in place: keeps ``file|_|text`` columns
    (dropping the duration column like the reference), cleans text, drops
    empty/punctuation-only lines.  Returns lines kept."""
    out_lines = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            if len(cols) < 3:
                continue
            text = normalize_css10_text(cols[2])
            if not text or _is_punct_only(text):
                continue
            out_lines.append(f"{cols[0]}|{cols[1]}|{text}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out_lines) + "\n")
    return len(out_lines)


def normalize_mailabs_text(text: str) -> str:
    """Clean one M-AILABS metadata.csv text field (normalize_mailabs.sh)."""
    text = re.sub(r"^\s*\.+\s*", "", text)
    text = re.sub(r"^\s*[–\-]+\s*", "", text)
    text = re.sub(r"\s*[–\-]+\s*$", "", text)
    text = re.sub(r"^\s*[)(]+\s*", "", text)
    text = re.sub(r"\s*[)(]+\s*$", "", text)
    text = re.sub(r"\s*\.+\s*$", ".", text)
    text = re.sub(r"\.\.+", "-", text)
    text = re.sub(r"([?!\.:;]\s*)[–\-]+", r"\1", text)
    return " ".join(text.split())


def normalize_mailabs_metadata(path: str) -> int:
    """Rewrite a metadata.csv in place; drops chapter-number lines (I., IV.)
    and utterances containing digits (normalize_mailabs.sh:37-41)."""
    out_lines = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            if len(cols) < 3:
                continue
            text = normalize_mailabs_text(cols[2])
            if not text:
                continue
            if re.fullmatch(r"[IVXCDM]+\.", text):
                continue
            if re.search(r"[0-9]", text):
                continue
            out_lines.append(f"{cols[0]}|{cols[1]}|{text}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out_lines) + "\n")
    return len(out_lines)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus", choices=["css10", "mailabs"], required=True)
    parser.add_argument("--root", type=str, required=True)
    args = parser.parse_args(argv)

    if args.corpus == "css10":
        files = glob(os.path.join(args.root, "*", "transcript.txt"))
        fn = normalize_css10_transcript
    else:
        files = glob(os.path.join(args.root, "*/*/*/*/metadata.csv"))
        fn = normalize_mailabs_metadata
    for path in sorted(files):
        kept = fn(path)
        print(f"Cleaned {path}: {kept} lines kept")


if __name__ == "__main__":
    main()
