"""GTA (ground-truth-aligned) spectrogram export for vocoder training.

    python3 -m multilingual_text_to_speech_tpu_torch.cli.gta \
        --checkpoint CKPT --data_root data --output gta [--cpu]

Port of the JAX package's ``cli/gta.py``, with its flags: the checkpoint's
model (``Synthesizer.from_checkpoint(...).model``, in ``model.eval()``)
runs the teacher-forced forward at teacher forcing 1.0 (K2's eval variant
on the card) over the train metafile of ``<data_root>/<hp.dataset>``,
optionally filtered to ``--speakers``, and saves each item's denormalized
postnet output as ``{serial:05}-{speaker}.npy`` in the layout [bins, F].
Grouped encoders take language-interleaved batches (the perfect sampler).
Each batch's decoder seeds come from a generator seeded with the batch's
first serial.  It runs on the card, and raises without one, unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--output", type=str, default="gta")
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--speakers", type=str, nargs="+", default=None,
                        help="Speaker IDs to export (default: all).")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the card.")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from multilingual_text_to_speech_tpu_torch.data import (
        Collate,
        PerfectBatchSampler,
        SimpleBatchSampler,
        TextToSpeechDataset,
        batch_iterator,
    )
    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        GROUPED_ENCODERS,
    )
    from multilingual_text_to_speech_tpu_torch.ops import audio as audio_ops
    from multilingual_text_to_speech_tpu_torch.ops.fused_decoder import (
        draw_seeds,
    )
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    synth = Synthesizer.from_checkpoint(args.checkpoint,
                                        device="cpu" if args.cpu else None)
    hp, model, dev = synth.hp, synth.model.eval(), synth.device

    root = os.path.join(args.data_root, hp.dataset)
    dataset = TextToSpeechDataset(os.path.join(root, "train.txt"), root, hp,
                                  device=dev)
    if args.speakers:
        wanted = {list(hp.unique_speakers).index(s)
                  for s in args.speakers} if hp.multi_speaker else set()
        dataset.items = [it for it in dataset.items
                         if not hp.multi_speaker or it["speaker"] in wanted]

    # grouped encoders need language-interleaved batches divisible by L
    # (reference: gta.py:64-70 uses the perfect sampler too)
    if hp.multi_language and hp.encoder_type in GROUPED_ENCODERS:
        n_langs = len(hp.languages)
        batch = max(args.batch_size // n_langs, 1) * n_langs
        sampler = PerfectBatchSampler(
            [it["language"] for it in dataset.items], n_langs, batch,
            shuffle=False, drop_last=False)
    else:
        sampler = SimpleBatchSampler(len(dataset), args.batch_size,
                                     shuffle=False, drop_last=False)
    os.makedirs(args.output, exist_ok=True)

    def on(x, dtype=torch.long):
        return None if x is None else torch.as_tensor(x, device=dev,
                                                      dtype=dtype)

    serial = 0
    for batch in batch_iterator(dataset, sampler, Collate(hp)):
        frames = batch.mel_spectrograms.shape[1]
        seeds = draw_seeds(torch.Generator().manual_seed(serial))
        with torch.no_grad():
            out = model(on(batch.utterances), on(batch.utterance_lengths),
                        on(batch.mel_spectrograms, torch.float32),
                        on(batch.spectrogram_lengths), on(batch.speakers),
                        on(batch.languages), [1] * frames, seeds)
        post = out["post_prediction"].float().cpu().numpy()
        for j in range(post.shape[0]):
            f = int(batch.spectrogram_lengths[j])
            mel = post[j, :f].T  # [bins, F]
            if hp.normalize_spectrogram:
                mel = audio_ops.denormalize_spectrogram(
                    mel, hp, not hp.predict_linear)
            speaker = (hp.unique_speakers[int(batch.speakers[j])]
                       if hp.multi_speaker else "0")
            np.save(os.path.join(args.output, f"{serial:05}-{speaker}.npy"),
                    mel)
            serial += 1
        print(f"Exported {serial} GTA spectrograms", file=sys.stderr)


if __name__ == "__main__":
    main()
