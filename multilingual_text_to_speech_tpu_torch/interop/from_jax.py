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
- the CBHG postnet's two flax ``GRUCell``s, ``GRUCell_0`` (forward) and
  ``GRUCell_1`` (backward) in the postnet's scope, become its ``bigru``
  (``nn.GRU``): the kernels ``ir/iz/in`` and ``hr/hz/hn`` [in, units],
  gate order r, z, n, stack into ``weight_ih_l0`` and ``weight_hh_l0``
  (``_reverse`` for the backward cell), the ``i*`` biases into
  ``bias_ih_l0``, and ``hn``'s bias into the last third of
  ``bias_hh_l0``, whose r and z thirds are zero (flax's ``hr`` and ``hz``
  have no bias; the inverse of the JAX package's
  ``interop/torch_port.py::bigru``);
- ``MultiEncoder``'s ``encoders`` (one flax module vmapped over the
  languages, every leaf stacked ``[L, ...]``) become ``encoders.0`` ..
  ``encoders.{L-1}``.

Every module of every encoder type and of both postnets maps over, both
speaker classifiers included.  ``params_to_jax`` is the inverse: the port's state_dict back to
the ``{"params", "batch_stats"}`` tree that the JAX ``Tacotron.init`` makes
(the checkpoint writer's model section).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_LSTM_CELLS = {"OptimizedLSTMCell_0": "", "OptimizedLSTMCell_1": "_reverse"}
_GATES = ("i", "f", "g", "o")
_GRU_CELLS = {"GRUCell_0": "", "GRUCell_1": "_reverse"}
_GRU_GATES = ("r", "z", "n")


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


def _gru_weights(cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]]):
    """``{(*scope, cell, gate_dense): {"kernel"[, "bias"]}}`` of the
    GRUCells -> ``(name, array)`` of each ``nn.GRU`` tensor."""
    scopes = {key[:-2] for key in cells}
    for scope in sorted(scopes):
        for cell, suffix in _GRU_CELLS.items():
            def dense(name, leaf):
                return cells[scope + (cell, name)][leaf]

            hn_bias = dense("hn", "bias")
            prefix = ".".join(scope + ("bigru",))
            yield f"{prefix}.weight_ih_l0{suffix}", np.concatenate(
                [dense(f"i{g}", "kernel").T for g in _GRU_GATES])
            yield f"{prefix}.weight_hh_l0{suffix}", np.concatenate(
                [dense(f"h{g}", "kernel").T for g in _GRU_GATES])
            yield f"{prefix}.bias_ih_l0{suffix}", np.concatenate(
                [dense(f"i{g}", "bias") for g in _GRU_GATES])
            yield f"{prefix}.bias_hh_l0{suffix}", np.concatenate(
                [np.zeros_like(hn_bias), np.zeros_like(hn_bias), hn_bias])


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
    gru_cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for collection in ("params", "batch_stats"):
        for leaf_path, leaf in _leaves(variables_np.get(collection, {})):
            for path, value in _unstacked(leaf_path, leaf):
                if any(p in _LSTM_CELLS for p in path):
                    cells.setdefault(path[:-1], {})[path[-1]] = value
                    continue
                if any(p in _GRU_CELLS for p in path):
                    gru_cells.setdefault(path[:-1], {})[path[-1]] = value
                    continue
                names, arr = _convert(path, value, collection)
                put(".".join(names), arr)
                if names[-1] == "running_mean":
                    out[".".join(names[:-1] + ["num_batches_tracked"])] = (
                        torch.tensor(0, dtype=torch.long))
    for name, arr in _lstm_weights(cells):
        put(name, arr)
    for name, arr in _gru_weights(gru_cells):
        put(name, arr)
    return out


def _put(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _stacked(trees):
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _restacked(tree):
    """``encoders.{0..L-1}`` subtrees -> one ``encoders`` subtree whose
    leaves stack the languages ``[L, ...]`` (flax's vmapped module)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "encoders" and isinstance(v, dict) and all(
                s.isdigit() for s in v):
            v = _stacked([v[str(i)] for i in range(len(v))])
        out[k] = _restacked(v)
    return out


def _lstm_cells(scope, weights: Dict[str, np.ndarray]):
    """An ``nn.LSTM``'s tensors -> ``(path, array)`` of the flax
    OptimizedLSTMCells' per-gate kernels and biases.  flax's cell has one
    bias a gate, so it takes ``bias_ih + bias_hh``."""
    for cell, suffix in _LSTM_CELLS.items():
        w_ih = weights["weight_ih_l0" + suffix]
        w_hh = weights["weight_hh_l0" + suffix]
        bias = weights["bias_ih_l0" + suffix] + weights["bias_hh_l0" + suffix]
        h = w_hh.shape[1]
        for g, gate in enumerate(_GATES):
            rows = slice(g * h, (g + 1) * h)
            yield scope + (cell, f"i{gate}", "kernel"), w_ih[rows].T
            yield scope + (cell, f"h{gate}", "kernel"), w_hh[rows].T
            yield scope + (cell, f"h{gate}", "bias"), bias[rows]


def _gru_cells(scope, weights: Dict[str, np.ndarray]):
    """An ``nn.GRU``'s tensors -> ``(path, array)`` of the flax GRUCells'
    per-gate kernels and biases: ``ir``/``iz`` take ``bias_ih + bias_hh``
    of their gate (torch's r and z biases act the same from either
    side), ``in`` takes ``bias_ih``'s n third and ``hn`` ``bias_hh``'s."""
    for cell, suffix in _GRU_CELLS.items():
        w_ih = weights["weight_ih_l0" + suffix]
        w_hh = weights["weight_hh_l0" + suffix]
        b_ih = weights["bias_ih_l0" + suffix]
        b_hh = weights["bias_hh_l0" + suffix]
        h = w_hh.shape[1]
        for g, gate in enumerate(_GRU_GATES):
            rows = slice(g * h, (g + 1) * h)
            yield scope + (cell, f"i{gate}", "kernel"), w_ih[rows].T
            yield scope + (cell, f"h{gate}", "kernel"), w_hh[rows].T
            yield scope + (cell, f"i{gate}", "bias"), (
                b_ih[rows] if gate == "n" else b_ih[rows] + b_hh[rows])
        yield scope + (cell, "hn", "bias"), b_hh[2 * h:]


def params_to_jax(state_dict: Dict[str, torch.Tensor], hp
                  ) -> Dict[str, Any]:
    """The port's state_dict -> the JAX package's ``{"params",
    "batch_stats"}`` tree of float32 numpy arrays, the inverse of
    ``params_from_jax``: the key set is exactly the one the JAX
    ``Tacotron.init`` makes for ``hp``, which flax's ``from_state_dict``
    requires.  Each ``weight``'s flax name and layout follows the type of
    its module in ``Tacotron(hp)`` (built on the meta device): a Linear's
    transposed ``kernel``, a Conv1d's ``(2, 1, 0)`` ``kernel``, an
    Embedding's ``embedding``, a batch norm's ``scale``; buffers go to
    ``batch_stats`` (``running_*`` as ``mean``/``var``,
    ``num_batches_tracked`` dropped); an ``nn.LSTM``'s and an
    ``nn.GRU``'s tensors become flax's per-gate cells."""
    from multilingual_text_to_speech_tpu_torch.models.tacotron import Tacotron

    with torch.device("meta"):
        model = Tacotron(hp)
    modules = dict(model.named_modules())
    buffers = {name for name, _ in model.named_buffers()}
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    lstms: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    grus: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for name, tensor in state_dict.items():
        *parents, leaf = name.split(".")
        module = modules[".".join(parents)]
        arr = np.ascontiguousarray(tensor.detach().cpu().numpy())
        if leaf == "num_batches_tracked":
            continue
        if isinstance(module, nn.LSTM):
            lstms.setdefault(tuple(parents[:-1]), {})[leaf] = arr
            continue
        if isinstance(module, nn.GRU):
            grus.setdefault(tuple(parents[:-1]), {})[leaf] = arr
            continue
        if name in buffers:
            leaf = {"running_mean": "mean", "running_var": "var"}.get(
                leaf, leaf)
            _put(tree["batch_stats"], parents + [leaf], arr)
            continue
        if leaf == "weight":
            if isinstance(module, nn.Linear):
                leaf, arr = "kernel", arr.T
            elif isinstance(module, nn.Conv1d):
                leaf, arr = "kernel", np.transpose(arr, (2, 1, 0))
            elif isinstance(module, nn.Embedding):
                leaf = "embedding"
            elif isinstance(module, nn.modules.batchnorm._BatchNorm):
                leaf = "scale"
            else:
                raise ValueError(f"no flax name for {name} "
                                 f"({type(module).__name__})")
        _put(tree["params"], parents + [leaf], arr)
    for scope, weights in lstms.items():
        for path, arr in _lstm_cells(scope, weights):
            _put(tree["params"], list(path), np.ascontiguousarray(arr))
    for scope, weights in grus.items():
        for path, arr in _gru_cells(scope, weights):
            _put(tree["params"], list(path), np.ascontiguousarray(arr))
    return _restacked(tree)
