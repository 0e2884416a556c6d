"""Batch silence trimming of wav trees (sox-free).

Port of the JAX package's ``dataset_prepare/trim.py`` (the reference
model's ``data/comvoi_clean/silence.sh``: sox
``silence 1 0.05 0`` front+back trimming) using this framework's own
energy-based trimmer — no sox dependency, runs anywhere.

Usage:
    python -m multilingual_text_to_speech_tpu_torch.dataset_prepare.trim \
        --root /data/comvoi --top_db 50
"""

from __future__ import annotations

import os
from glob import glob


def trim_tree(root: str, top_db: float = 50.0, window_ms: float = 25.0,
              hop_ms: float = 10.0, sample_rate: int | None = None,
              suffix: str = ".wav") -> int:
    """Trim every wav under ``root`` in place, preserving each file's OWN
    sample rate (like the reference's sox pipeline, which never resamples).
    Pass ``sample_rate`` to instead fail loudly on any file at another rate."""
    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.ops.audio import trim_silence
    from multilingual_text_to_speech_tpu_torch.ops.io import (
        load_wav_with_rate,
        save_wav,
    )

    hp = HParams()
    count = 0
    for path in glob(os.path.join(root, "**", f"*{suffix}"), recursive=True):
        data, sr = load_wav_with_rate(path)
        if sample_rate is not None and sr != sample_rate:
            raise ValueError(
                f"{path}: sample rate {sr} != required {sample_rate}"
            )
        hp.sample_rate = sr  # window/hop ms->samples at the file's true rate
        trimmed, (start, end) = trim_silence(
            data, window_ms, hop_ms, hp, top_db=top_db
        )
        if len(trimmed) and len(trimmed) < len(data):
            save_wav(trimmed, path, sr)
            count += 1
    return count


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--top_db", type=float, default=50.0)
    parser.add_argument("--sample_rate", type=int, default=None,
                        help="if set, fail on files at any other rate "
                             "(default: keep each file's own rate)")
    args = parser.parse_args(argv)

    n = trim_tree(args.root, args.top_db, sample_rate=args.sample_rate)
    print(f"Trimmed {n} files")


if __name__ == "__main__":
    main()
