"""Corpus preparation CLI: build metafiles + spectrogram caches.

    python3 -m multilingual_text_to_speech_tpu_torch.cli.prepare \
        --dataset css10 --root data/css10 [--no_phonemes] [--cpu]
    python3 -m multilingual_text_to_speech_tpu_torch.cli.prepare \
        --fill_metafile data/corpus/train.txt --root data/corpus

Port of the JAX package's ``cli/prepare.py``, with its flags: a metafile
from a corpus loader (``data.create_meta_file``), or, with
``--fill_metafile``, the caches of an existing metafile, whose
spectrogram-path columns are rewritten.  The spectrograms are computed on
the card, which must be there, unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os


def fill_metafile_spectrograms(metafile: str, root: str, hp,
                               progress=None, device=None) -> int:
    """Compute mel+linear caches for every line of an existing metafile on
    ``device`` (the card unless ``"cpu"``) and rewrite columns 4/5
    (reference: data/prepare_css_spectrograms.py:46-77).  Returns the
    number of items processed."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.device import resolve_device
    from multilingual_text_to_speech_tpu_torch.ops import audio as audio_ops
    from multilingual_text_to_speech_tpu_torch.ops.io import load_wav

    dev = resolve_device(device)
    spec_dirs = [os.path.join(root, "spectrograms"),
                 os.path.join(root, "linear_spectrograms")]
    for d in spec_dirs:
        os.makedirs(d, exist_ok=True)

    with open(metafile, "r", encoding="utf-8") as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]

    out_lines = []
    for i, line in enumerate(lines):
        tokens = line.split("|")
        idx, audio_path = tokens[0], tokens[3]
        name = f"{idx}.npy"
        wav = load_wav(os.path.join(root, audio_path), hp.sample_rate)
        np.save(os.path.join(spec_dirs[0], name),
                audio_ops.spectrogram(wav, hp, mel=True, device=dev))
        np.save(os.path.join(spec_dirs[1], name),
                audio_ops.spectrogram(wav, hp, mel=False, device=dev))
        tokens[4] = os.path.join("spectrograms", name)
        tokens[5] = os.path.join("linear_spectrograms", name)
        out_lines.append("|".join(tokens))
        if progress is not None:
            progress((i + 1) / len(lines))

    with open(metafile, "w", encoding="utf-8") as f:
        f.write("\n".join(out_lines) + "\n")
    return len(out_lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default=None,
                        help="Loader name: css10, ljspeech, vctk, mailabs, "
                             "my_blizzard, my_common_voice.")
    parser.add_argument("--fill_metafile", type=str, default=None,
                        help="Existing metafile: compute spectrogram caches "
                             "and rewrite its mel/linear path columns.")
    parser.add_argument("--root", type=str, required=True,
                        help="Dataset root directory.")
    parser.add_argument("--output", type=str, default="all.txt",
                        help="Output metafile name.")
    parser.add_argument("--hyper_parameters", type=str, default=None,
                        help="Optional hp JSON (languages, DSP settings).")
    parser.add_argument("--sample_rate", type=int, default=22050)
    parser.add_argument("--num_fft", type=int, default=1102)
    parser.add_argument("--no_spectrograms", action="store_true")
    parser.add_argument("--no_phonemes", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="Compute the spectrograms on the CPU instead "
                             "of the card.")
    args = parser.parse_args(argv)

    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.data import create_meta_file
    from multilingual_text_to_speech_tpu_torch.device import resolve_device
    from multilingual_text_to_speech_tpu_torch.training.logging import (
        MetricsLogger,
    )

    device = resolve_device("cpu" if args.cpu else None)
    hp = HParams()
    if args.hyper_parameters:
        hp.overlay(args.hyper_parameters)

    if args.fill_metafile:
        hp.sample_rate = args.sample_rate
        hp.num_fft = args.num_fft
        n = fill_metafile_spectrograms(
            args.fill_metafile, args.root, hp,
            progress=lambda f: MetricsLogger.progress(f, "Filling caches:"),
            device=device,
        )
        print(f"Computed spectrogram caches for {n} items")
        return

    if not args.dataset:
        parser.error("either --dataset or --fill_metafile is required")

    path = create_meta_file(
        args.dataset, args.root, args.output, hp,
        audio_sample_rate=args.sample_rate,
        num_fft_freqs=args.num_fft,
        spectrograms=not args.no_spectrograms,
        phonemes=not args.no_phonemes,
        progress=lambda f: MetricsLogger.progress(f, "Building metafile:"),
        device=device,
    )
    print(f"Wrote {path}")


if __name__ == "__main__":
    main()
