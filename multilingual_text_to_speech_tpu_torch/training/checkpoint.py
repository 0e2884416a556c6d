"""Single-file checkpoints in the JAX package's format, without flax.

Port of the JAX package's ``training/checkpoint.py``.  One msgpack file
(``interop.msgpack_codec``, flax's bytes) holds the sections

    epoch, step                  integers (numpy int64)
    model.{params,batch_stats}   the JAX package's weight tree
    optimizer                    the optimizer state, a nested dict of arrays
    parameters                   the hyper-parameters as JSON
    criterion                    the loss state (guided-attention weight)

The model section is the JAX layout (``interop.params_to_jax`` writes it,
``params_from_jax`` reads it), so a file either package writes, the other
restores: the JAX ``Synthesizer.from_checkpoint`` reads a port-written file
and the port's reads a JAX-written one.

The optimizer section is optax's state of the JAX package's
``make_optimizer`` chain; ``interop.optax_state`` maps torch's Adam state
and ``LambdaLR`` step onto it and back, so the JAX ``Trainer`` resumes a
file the port's ``Trainer`` wrote, with its Adam moments, and the other way
round.  ``save_checkpoint`` writes the section it is given (empty by
default) as it is.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
from torch import nn

from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.interop import (
    msgpack_codec,
    params_from_jax,
    params_to_jax,
)


def save_checkpoint(path: str, *, epoch: int, step: int, state_dict, hp,
                    criterion_state: Dict[str, Any],
                    optimizer: Optional[Dict[str, Any]] = None) -> None:
    """Write the five sections to ``path`` (through a temporary file and
    ``os.replace``, so a crash never leaves half a checkpoint)."""
    payload = {
        "epoch": np.int64(epoch),
        "step": np.int64(step),
        "model": params_to_jax(state_dict, hp),
        "optimizer": optimizer if optimizer is not None else {},
        "parameters": json.dumps(hp.state_dict(), ensure_ascii=False),
        "criterion": {k: np.float64(v) for k, v in criterion_state.items()},
    }
    chunks = msgpack_codec.pack_chunks(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(chunks)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw payload, with the hyper-parameters decoded into the port's
    ``HParams`` under ``"hp"``."""
    with open(path, "rb") as f:
        payload = msgpack_codec.unpack(f.read())
    payload["hp"] = HParams.from_state_dict(json.loads(payload["parameters"]))
    return payload


def _merge_matching(template, loaded):
    """Fine-tuning partial restore: the loaded value wherever the key path
    exists in both trees with the same shape, the template's otherwise."""
    if isinstance(template, dict) and isinstance(loaded, dict):
        return {k: _merge_matching(tv, loaded[k]) if k in loaded else tv
                for k, tv in template.items()}
    t_shape = getattr(template, "shape", None)
    l_shape = getattr(loaded, "shape", None)
    if t_shape is not None and l_shape is not None and t_shape != l_shape:
        return template
    return loaded


def restore(payload: Dict[str, Any], model: nn.Module, hp,
            partial: bool = False) -> nn.Module:
    """Load the payload's model section into ``model`` (built for ``hp``),
    strictly; with ``partial`` only the weights whose path and shape match
    the model's, the model keeping its own elsewhere (fine-tuning a changed
    architecture).  Returns the model."""
    loaded = payload["model"]
    if partial:
        loaded = _merge_matching(params_to_jax(model.state_dict(), hp),
                                 loaded)
    model.load_state_dict(params_from_jax(loaded), strict=True)
    return model


def _is_checkpoint_file(path: str) -> bool:
    """Cheap probe: the payload is a msgpack map whose first key is one of
    the sections, so that a stray file in the directory is not taken for
    the checkpoint."""
    try:
        with open(path, "rb") as f:
            head = f.read(64)
    except OSError:
        return False
    if not head or not (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return False  # not a msgpack map (fixmap/map16/map32)
    # the writer sorts keys: "criterion" leads
    return any(k in head for k in (b"criterion", b"epoch", b"model"))


def find_latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest checkpoint file in a directory, skipping temporary files
    and files that are not checkpoints; None if there is none."""
    if not os.path.isdir(checkpoint_dir):
        return None
    candidates = [
        os.path.join(checkpoint_dir, f)
        for f in os.listdir(checkpoint_dir)
        if not f.endswith(".tmp")
        and os.path.isfile(os.path.join(checkpoint_dir, f))
        and _is_checkpoint_file(os.path.join(checkpoint_dir, f))
    ]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)
