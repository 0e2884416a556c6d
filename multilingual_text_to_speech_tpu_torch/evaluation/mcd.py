"""Offline MCD between synthesized and ground-truth spectrograms, with CIs.

Port of the JAX package's ``evaluation/mcd.py`` (the reference model's
``evaluation/mcd_request.py``), on the port's ``ops/dtw.py`` and
``ops/mel.py``: 13 MFCCs (c0
dropped), DTW alignment (exact DTW here instead of approximate fastdtw),
per-language mean/std/95% CI reports.

Usage:
    python -m multilingual_text_to_speech_tpu_torch.evaluation.mcd \
        --language german --model generated --where eval_data
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from multilingual_text_to_speech_tpu_torch.evaluation.cer import (
    confidence_interval,
    write_report,
)
from multilingual_text_to_speech_tpu_torch.ops.dtw import dtw_path
from multilingual_text_to_speech_tpu_torch.ops.mel import dct_matrix


def _mfcc(S: np.ndarray, num_mfcc: int) -> np.ndarray:
    """librosa.feature.mfcc(S=S/10) (reference: mcd_request.py:23-24)."""
    D = dct_matrix(num_mfcc, S.shape[0])
    return D @ (np.asarray(S, np.float32) / 10.0)


def mel_cepstral_distortion_specs(S1: np.ndarray, S2: np.ndarray,
                                  num_mfcc: int = 13) -> float:
    """DTW-aligned MCD between two [bins, frames] dB mel spectrograms
    (reference: mcd_request.py:27-40)."""
    x = _mfcc(S1, num_mfcc)[1:]
    y = _mfcc(S2, num_mfcc)[1:]
    px, py = dtw_path(x.T, y.T)
    diff = x[:, px] - y[:, py]
    return float(np.mean(np.sqrt(np.sum(diff * diff, axis=0))))


def evaluate_language(language: str, model: str, where: str,
                      num_mfcc: int = 13) -> List[Tuple[str, float]]:
    """Score one language's synthesized spectrograms vs ground truth
    (reference: mcd_request.py:62-82)."""
    mcds: List[Tuple[str, float]] = []
    meta_file = os.path.join(where, "all_meta_files", f"{language}.txt")
    with open(meta_file, "r", encoding="utf-8") as f:
        for line in f:
            idx = line.rstrip().split("|")[0]
            spec_path = os.path.join(
                where, model, "spectrograms", language, f"{idx}.npy"
            )
            if not os.path.exists(spec_path):
                print(f"Missing spectrogram of {idx}!")
                continue
            gen = np.load(spec_path)
            ref = np.load(os.path.join(
                where, "ground-truth", "spectrograms", f"{idx}.npy"
            ))
            mcds.append((idx, mel_cepstral_distortion_specs(gen, ref, num_mfcc)))
    return mcds


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--language", type=str, required=True)
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--num_mfcc", type=int, default=13)
    parser.add_argument("--where", type=str, required=True)
    args = parser.parse_args(argv)

    mcds = evaluate_language(args.language, args.model, args.where,
                             args.num_mfcc)
    out = os.path.join(args.where, args.model, "mcd", f"{args.language}.txt")
    write_report(mcds, out, "MCD")
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
