"""Synthesis CLI: stdin lines -> spectrograms (.npy) and Griffin-Lim WAVs.

    echo "01|Guten Tag.|speaker|de" | python3 -m \
        multilingual_text_to_speech_tpu_torch.cli.synthesize \
        --checkpoint CKPT --output out --save_spec

Port of the JAX package's ``cli/synthesize.py``, with its flags.  Input
line formats:

    mono-lingual single-speaker:   id|utterance
    otherwise:                     id|utterance|speaker|language
    per-character language:        id|utterance|speaker|de-10,fr-9,de
    accent control:                id|utterance|speaker|de-10,fr*0.75:de*0.25-9,de

It runs on the card, and raises without one, unless ``--cpu`` is given.
Spectrograms are saved in the layout [bins, frames].
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Model checkpoint.")
    parser.add_argument("--output", type=str, default=".",
                        help="Output directory.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the prenet dropout and the Griffin-Lim "
                             "phases.")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the card.")
    parser.add_argument("--save_spec", action="store_true",
                        help="Also save spectrograms as .npy.")
    parser.add_argument("--ignore_wav", action="store_true",
                        help="Skip Griffin-Lim waveform rendering.")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Synthesize this many stdin lines per batched "
                             "decode.")
    args = parser.parse_args(argv)

    import numpy as np

    from multilingual_text_to_speech_tpu_torch.ops.io import save_wav
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    print("Building model ...", file=sys.stderr)
    synth = Synthesizer.from_checkpoint(
        args.checkpoint, device="cpu" if args.cpu else None)

    inputs = [line.rstrip() for line in sys.stdin.readlines() if line.strip()]
    os.makedirs(args.output, exist_ok=True)

    def emit(item, spec, wav):
        item_id = item.split("|")[0] or "out"
        if args.save_spec:
            np.save(os.path.join(args.output, f"{item_id}.npy"), spec)
        if wav is not None:
            save_wav(wav, os.path.join(args.output, f"{item_id}.wav"),
                     synth.hp.sample_rate)

    if args.batch_size > 1:
        for start in range(0, len(inputs), args.batch_size):
            group = inputs[start:start + args.batch_size]
            print(f"Synthesizing batch {start}..{start + len(group) - 1}",
                  file=sys.stderr)
            specs = synth.synthesize_batch_lines(group, seed=args.seed + start)
            wavs = (synth.vocode_batch(specs, seed=args.seed + start)
                    if not args.ignore_wav else [None] * len(specs))
            for item, spec, wav in zip(group, specs, wavs):
                emit(item, spec, wav)
    else:
        for i, item in enumerate(inputs):
            print(f"Synthesizing {i + 1}/{len(inputs)}: {item!r}",
                  file=sys.stderr)
            spec = synth.synthesize_line(item, seed=args.seed + i)
            wav = (synth.vocode(spec, seed=args.seed + i)
                   if not args.ignore_wav else None)
            emit(item, spec, wav)


if __name__ == "__main__":
    main()
