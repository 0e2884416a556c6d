"""JAX weight tree -> the port's state_dict.

The port's module names mirror the flax parameter paths (``/`` becomes
``.``), so the mapping is mostly renames and transposes:

- a Dense ``kernel`` [in, out] becomes an ``nn.Linear`` ``weight`` [out, in]
  (this also holds for the generated-conv kernel Dense, whose output columns
  keep the JAX ``(k, cin, cout)`` order in the port);
- an ``nn.Conv`` ``kernel`` [k, cin, cout] becomes ``weight`` [cout, cin, k];
- ``embedding`` and batch-norm ``scale`` become ``weight``; the postnet's
  batch-norm statistics become ``running_mean``/``running_var`` (plus a
  zero ``num_batches_tracked``);
- the attention parameters and the generated batch norms' ``mean``/``var``
  keep their JAX names and layouts.

Every module of the flagship model maps over, the speaker classifier
included.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _convert(path: Tuple[str, ...], value: np.ndarray, collection: str):
    *parents, leaf = path
    parent = parents[-1] if parents else ""
    if collection == "batch_stats":
        if parent == "BatchNorm_0":
            leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
        return parents + [leaf], value
    if leaf == "kernel":
        if parent.startswith("Conv_"):
            return parents + ["weight"], np.transpose(value, (2, 1, 0))
        return parents + ["weight"], value.T
    if leaf in ("embedding", "scale"):
        return parents + ["weight"], value
    return parents + [leaf], value


def params_from_jax(variables_np: Dict[str, Any], hp=None
                    ) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays -> a state_dict
    for ``Tacotron.load_state_dict(strict=True)``.  ``hp`` is accepted for
    symmetry with the model constructor and is not needed."""
    del hp
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables_np.get(collection, {})):
            names, arr = _convert(path, value, collection)
            out[".".join(names)] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))
            if names[-1] == "running_mean":
                out[".".join(names[:-1] + ["num_batches_tracked"])] = (
                    torch.tensor(0, dtype=torch.long))
    return out
