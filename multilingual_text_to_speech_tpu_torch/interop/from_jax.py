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
  keep their JAX names and layouts;
- a BiLSTM's two flax ``OptimizedLSTMCell``s, ``OptimizedLSTMCell_0``
  (forward) and ``OptimizedLSTMCell_1`` (backward) in the encoder's own
  scope, become the port's ``bilstm`` (``nn.LSTM``): the per-gate kernels
  ``ii/if/ig/io`` and ``hi/hf/hg/ho`` [in, units], gate order i, f, g, o,
  stack into ``weight_ih_l0`` and ``weight_hh_l0`` (``_reverse`` for the
  backward cell), the ``h*`` biases into ``bias_ih_l0`` and a zero
  ``bias_hh_l0`` (the inverse of the JAX package's
  ``interop/torch_port.py::bilstm``);
- ``MultiEncoder``'s ``encoders`` (one flax module vmapped over the
  languages, every leaf stacked ``[L, ...]``) become ``encoders.0`` ..
  ``encoders.{L-1}``.

Every module of every encoder type maps over, the speaker classifier
included.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_LSTM_CELLS = {"OptimizedLSTMCell_0": "", "OptimizedLSTMCell_1": "_reverse"}
_GATES = ("i", "f", "g", "o")


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


def _unstacked(path: Tuple[str, ...], value: np.ndarray):
    """A leaf of a vmapped ``encoders`` module -> one leaf a language."""
    if "encoders" not in path:
        yield path, value
        return
    i = path.index("encoders") + 1
    for lang in range(value.shape[0]):
        yield path[:i] + (str(lang),) + path[i:], value[lang]


def _lstm_weights(cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]]):
    """``{(*scope, cell, gate_dense): {"kernel", "bias"}}`` of the
    OptimizedLSTMCells -> ``(name, array)`` of each ``nn.LSTM`` tensor."""
    scopes = {key[:-2] for key in cells}
    for scope in sorted(scopes):
        for cell, suffix in _LSTM_CELLS.items():
            def dense(name, leaf):
                return cells[scope + (cell, name)][leaf]

            w_ih = np.concatenate([dense(f"i{g}", "kernel").T
                                   for g in _GATES])
            w_hh = np.concatenate([dense(f"h{g}", "kernel").T
                                   for g in _GATES])
            bias = np.concatenate([dense(f"h{g}", "bias") for g in _GATES])
            prefix = ".".join(scope + ("bilstm",))
            yield f"{prefix}.weight_ih_l0{suffix}", w_ih
            yield f"{prefix}.weight_hh_l0{suffix}", w_hh
            yield f"{prefix}.bias_ih_l0{suffix}", bias
            yield f"{prefix}.bias_hh_l0{suffix}", np.zeros_like(bias)


def params_from_jax(variables_np: Dict[str, Any], hp=None
                    ) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays -> a state_dict
    for ``Tacotron.load_state_dict(strict=True)``.  ``hp`` is accepted for
    symmetry with the model constructor and is not needed."""
    del hp
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = torch.from_numpy(np.ascontiguousarray(arr,
                                                          dtype=np.float32))

    cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for collection in ("params", "batch_stats"):
        for leaf_path, leaf in _leaves(variables_np.get(collection, {})):
            for path, value in _unstacked(leaf_path, leaf):
                if any(p in _LSTM_CELLS for p in path):
                    cells.setdefault(path[:-1], {})[path[-1]] = value
                    continue
                names, arr = _convert(path, value, collection)
                put(".".join(names), arr)
                if names[-1] == "running_mean":
                    out[".".join(names[:-1] + ["num_batches_tracked"])] = (
                        torch.tensor(0, dtype=torch.long))
    for name, arr in _lstm_weights(cells):
        put(name, arr)
    return out
