"""Training CLI.

    python3 -m multilingual_text_to_speech_tpu_torch.cli.train \
        --hyper_parameters params/my_config.json --data_root data [--cpu]

Port of the JAX package's ``cli/train.py``, with its flags.  The
hyper-parameters resolve as there: the checkpoint's (``--checkpoint NAME``
in the checkpoint directory, or with ``--resume`` the newest file there)
first, then the JSON overlay of ``--hyper_parameters``, a path or a name
looked up as ``<base_directory>/params/<name>.json``.  The corpus is
``<data_root>/<hp.dataset>`` with ``train.txt`` and ``val.txt``.  It trains
on the card, and raises without one, unless ``--cpu`` is given.

Data parallel: start one process a rank with ``torch.distributed.run`` and
pass ``--distributed``, e.g. two ranks on the CPU::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m multilingual_text_to_speech_tpu_torch.cli.train \
        --distributed --cpu --hyper_parameters ... --data_root ...

Each rank takes ``cuda:LOCAL_RANK % device_count`` (or the CPU with
``--cpu``) and its rows of every global batch of ``hp.batch_size``
(``parallel.make_mesh``: ``hp.mesh_data_parallel`` x
``hp.mesh_model_parallel`` ranks); rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import os


def _overlay_path(name: str, base_directory: str) -> str:
    candidates = [name, os.path.join(base_directory, "params", f"{name}.json")]
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"hyper-parameter file '{name}' not found in {candidates}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_directory", type=str, default=".",
                        help="Base directory of the project.")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Name of the initial checkpoint.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the newest checkpoint in the "
                             "checkpoint directory (crash recovery).")
    parser.add_argument("--checkpoint_root", type=str, default="checkpoints",
                        help="Base directory of checkpoints.")
    parser.add_argument("--data_root", type=str, default="data",
                        help="Base directory of datasets.")
    parser.add_argument("--flush_seconds", type=int, default=60,
                        help="Metrics flush interval.")
    parser.add_argument("--hyper_parameters", type=str, default=None,
                        help="Hyper-parameters JSON: a path, or a name in "
                             "<base_directory>/params/.")
    parser.add_argument("--logging_start", type=int, default=1,
                        help="First epoch to be logged.")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override hp.epochs.")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--distributed", action="store_true",
                        help="Data parallel over the ranks that "
                             "torch.distributed.run starts.")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="Trace this many steps of the first epoch with "
                             "torch.profiler.")
    parser.add_argument("--cpu", action="store_true",
                        help="Train on the CPU instead of the card.")
    args = parser.parse_args(argv)

    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.data import (
        TextToSpeechDatasetCollection,
    )
    from multilingual_text_to_speech_tpu_torch.device import resolve_device
    from multilingual_text_to_speech_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
    )
    from multilingual_text_to_speech_tpu_torch.training.checkpoint import (
        find_latest_checkpoint,
        load_checkpoint,
    )
    from multilingual_text_to_speech_tpu_torch.training.trainer import (
        Trainer,
    )

    if args.distributed:
        device = init_distributed(cpu=args.cpu)
    else:
        device = resolve_device("cpu" if args.cpu else None)
    checkpoint_dir = os.path.join(args.base_directory, args.checkpoint_root)
    os.makedirs(checkpoint_dir, exist_ok=True)

    # checkpoint hp first, then the JSON overlay (reference: train.py:211-220)
    hp = HParams()
    checkpoint_path = None
    if args.resume and not args.checkpoint:
        checkpoint_path = find_latest_checkpoint(checkpoint_dir)
        if checkpoint_path:
            print(f"Resuming from {checkpoint_path}")
            hp = load_checkpoint(checkpoint_path)["hp"]
    elif args.checkpoint:
        checkpoint_path = os.path.join(checkpoint_dir, args.checkpoint)
        hp = load_checkpoint(checkpoint_path)["hp"]
    if args.hyper_parameters is not None:
        hp.overlay(_overlay_path(args.hyper_parameters, args.base_directory))

    data = TextToSpeechDatasetCollection(
        os.path.join(args.data_root, hp.dataset), hp, device=device)
    trainer = Trainer(
        hp, data,
        checkpoint_dir=checkpoint_dir,
        log_dir=os.path.join(args.base_directory, "logs"),
        seed=args.seed,
        device=device,
        from_checkpoint=checkpoint_path,
        flush_seconds=args.flush_seconds,
        mesh=make_mesh(hp, device=device),
    )
    if args.profile_steps:
        trainer.train_epoch(args.logging_start,
                            profile_steps=args.profile_steps)
        trainer.epoch += 1
    trainer.fit(epochs=args.epochs, logging_start_epoch=args.logging_start)
    if trainer.logger is not None:
        trainer.logger.close()
    if args.distributed:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
