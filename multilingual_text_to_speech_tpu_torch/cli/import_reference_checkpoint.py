"""Convert a PyTorch checkpoint of the reference model into the port's
checkpoint file.

Port of the JAX package's ``cli/import_reference_checkpoint.py``, with the
same arguments.  The reference model ships pretrained checkpoints and
rebuilds models from them (``utils/__init__.py:29-37``: ``torch.load`` ->
strip DataParallel prefixes -> ``Params.load_state_dict(
state['parameters'])`` -> ``load_state_dict``).  This CLI writes such a
file as the port's single-file checkpoint (``training/checkpoint.py``), so
it drives ``Synthesizer.from_checkpoint``, ``cli/synthesize.py``,
``cli/gta.py`` or fine-tuning with ``cli/train.py --checkpoint`` in either
package::

    python -m multilingual_text_to_speech_tpu_torch.cli.import_reference_checkpoint \
        generated_switching_loss-111-0.122 -o checkpoints/imported.msgpack

Ported: model weights (all layouts translated, batch-norm running
statistics included), hyper-parameters, guided-attention criterion state,
epoch.  Not ported: the torch Adam and scheduler state (fine-tuning
restarts the optimizer, as the reference model itself does when
fine-tuning, train.py:276-281).  Runs on the CPU: no card is needed.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a reference (PyTorch) checkpoint into the "
        "port's checkpoint format.")
    parser.add_argument("checkpoint", type=str,
                        help="Path to the torch checkpoint file.")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="Output path (default: <checkpoint>.msgpack).")
    parser.add_argument("--hyper_parameters", type=str, default=None,
                        help="Optional JSON overlay applied AFTER the "
                        "checkpoint's own parameters (fine-tuning order, "
                        "reference train.py:211-219).")
    args = parser.parse_args(argv)

    from multilingual_text_to_speech_tpu_torch.interop import (
        params_from_jax,
        reference_import,
    )
    from multilingual_text_to_speech_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )

    hp, variables, criterion_state, meta = (
        reference_import.import_reference_checkpoint(args.checkpoint))
    if args.hyper_parameters:
        hp.overlay(args.hyper_parameters)

    out = args.output or args.checkpoint + ".msgpack"
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(
        out, epoch=meta["epoch"],
        step=0,  # the reference checkpoint does not record a global step
        state_dict=params_from_jax(variables), hp=hp,
        criterion_state=criterion_state)
    n_params = _count(variables["params"])
    print(f"imported {args.checkpoint} -> {out}")
    print(f"  encoder_type={hp.encoder_type}  epoch={meta['epoch']}  "
          f"parameters={n_params:,}")
    return 0


def _count(tree) -> int:
    import numpy as np

    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(np.size(tree))


if __name__ == "__main__":
    sys.exit(main())
