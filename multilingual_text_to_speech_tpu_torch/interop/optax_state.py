"""torch's Adam state <-> the JAX package's optax chain state.

The checkpoint's ``optimizer`` section is what the JAX package writes with
``flax.serialization.to_state_dict(opt_state)`` for the chain of its
``training/trainer.py::make_optimizer``:

    {"0": {},                                   clip_by_global_norm
     "1": {"0": {},                             add_decayed_weights
           "1": {"count", "mu", "nu"},          scale_by_adam
           "2": {"count"}}}                     scale_by_learning_rate

``mu`` and ``nu`` are trees of the model's weight layout (``params_to_jax``)
and the counts int32 scalars.  With ``hp.encoder_optimizer`` the inner chain
is an ``optax.multi_transform`` over the groups "encoder" (the weights under
the top-level ``encoder``) and "other":

    "1": {"inner_states": {"encoder": {"inner_state": <chain>},
                           "other": {"inner_state": <chain>}}}

where each group's ``mu``/``nu`` hold ``{}`` at the other group's leaves.
The port's ``make_optimizer`` is ``torch.optim.Adam`` (``exp_avg``,
``exp_avg_sq`` and ``step`` per parameter, the same moments as optax's
``mu``/``nu``) with a ``LambdaLR`` whose ``last_epoch`` is the schedule's
count.  A moment maps like its weight (transposes, the LSTM's gates and
its frozen second bias, whose moments are zero).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from multilingual_text_to_speech_tpu_torch.interop.from_jax import (
    params_from_jax,
    params_to_jax,
)

GROUPS = ("encoder", "other")


def _param_states(model: nn.Module, optimizer) -> Dict[str, Dict[str, Any]]:
    by_id = {id(p): n for n, p in model.named_parameters()}
    return {by_id[id(p)]: st for p, st in optimizer.state.items()
            if id(p) in by_id}


def _moment_tree(model: nn.Module, states, key: str, hp, keep=None):
    """The ``key`` moments (zeros where a parameter has none) as the JAX
    weight tree; leaves outside ``keep`` become ``{}`` (optax's masked
    nodes)."""
    moments = {}
    for name, p in model.named_parameters():
        st = states.get(name)
        moments[name] = (st[key].detach().float().cpu() if st is not None
                         else torch.zeros(p.shape))
    tree = params_to_jax(moments, hp)["params"]
    if keep is None:
        return tree
    return {k: v if (k == "encoder") == (keep == "encoder") else _masked(v)
            for k, v in tree.items()}


def _masked(tree):
    if isinstance(tree, dict):
        return {k: _masked(v) for k, v in tree.items()}
    return {}


def _chain(adam_count: int, sched_count: int, mu, nu) -> Dict[str, Any]:
    return {"0": {},
            "1": {"count": np.asarray(adam_count, np.int32), "mu": mu,
                  "nu": nu},
            "2": {"count": np.asarray(sched_count, np.int32)}}


def optimizer_to_optax(model: nn.Module, optimizer, scheduler, hp
                       ) -> Dict[str, Any]:
    """The checkpoint's ``optimizer`` section for ``make_optimizer``'s
    state: float32 moments in the JAX weight layout, Adam's step as
    ``scale_by_adam``'s count and the scheduler's ``last_epoch`` as
    ``scale_by_learning_rate``'s."""
    states = _param_states(model, optimizer)
    steps = {int(st["step"]) for st in states.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters are at different steps {steps}"
                         "; optax keeps one count")
    adam_count = steps.pop() if steps else 0
    sched_count = int(scheduler.last_epoch)
    if not hp.encoder_optimizer:
        inner = _chain(adam_count, sched_count,
                       _moment_tree(model, states, "exp_avg", hp),
                       _moment_tree(model, states, "exp_avg_sq", hp))
    else:
        inner = {"inner_states": {
            g: {"inner_state": _chain(
                adam_count, sched_count,
                _moment_tree(model, states, "exp_avg", hp, keep=g),
                _moment_tree(model, states, "exp_avg_sq", hp, keep=g))}
            for g in GROUPS}}
    return {"0": {}, "1": inner}


def _merged(a, b):
    """Two masked trees -> one: each leaf from the tree that holds it."""
    if isinstance(a, dict) and not a:
        return b
    if isinstance(b, dict) and not b:
        return a
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            raise KeyError("masked trees differ in keys "
                           f"{sorted(set(a) ^ set(b))}")
        return {k: _merged(a[k], b[k]) for k in a}
    raise ValueError("a leaf is present in both optimizer groups")


def _count(chain, *path) -> int:
    node = chain
    for k in path:
        node = node[k]
    arr = np.asarray(node)
    if arr.shape != ():
        raise ValueError(f"optimizer count {path} has shape {arr.shape}")
    return int(arr)


def optimizer_from_optax(section: Dict[str, Any], model: nn.Module,
                         optimizer, scheduler, hp) -> None:
    """Load a checkpoint's ``optimizer`` section into the port's Adam and
    ``LambdaLR`` (from ``make_optimizer(model, hp)``).  Raises ValueError,
    KeyError or TypeError, touching neither, when the section's structure
    does not match the model and ``hp.encoder_optimizer``."""
    if not isinstance(section, dict) or set(section) != {"0", "1"}:
        raise KeyError("the optimizer section is not make_optimizer's "
                       f"chain: {section if not section else sorted(section)}")
    if hp.encoder_optimizer:
        chains = [section["1"]["inner_states"][g]["inner_state"]
                  for g in GROUPS]
        mu = _merged(*(c["1"]["mu"] for c in chains))
        nu = _merged(*(c["1"]["nu"] for c in chains))
        counts = {(_count(c, "1", "count"), _count(c, "2", "count"))
                  for c in chains}
        if len(counts) > 1:
            raise ValueError(f"the groups' counts differ: {counts}")
        adam_count, sched_count = counts.pop()
    else:
        chain = section["1"]
        if "inner_states" in chain:
            raise KeyError("the section holds encoder and other groups but "
                           "hp.encoder_optimizer is off")
        mu, nu = chain["1"]["mu"], chain["1"]["nu"]
        adam_count = _count(chain, "1", "count")
        sched_count = _count(chain, "2", "count")
    exp_avg = params_from_jax({"params": mu})
    exp_avg_sq = params_from_jax({"params": nu})
    params = dict(model.named_parameters())
    if set(exp_avg) != set(params) or set(exp_avg_sq) != set(params):
        raise KeyError("the optimizer's moments do not cover the model's "
                       f"parameters: {sorted(set(exp_avg) ^ set(params))[:8]}")
    for name, p in params.items():
        for m in (exp_avg[name], exp_avg_sq[name]):
            if tuple(m.shape) != tuple(p.shape):
                raise ValueError(f"moment of {name} has shape "
                                 f"{tuple(m.shape)}, the parameter "
                                 f"{tuple(p.shape)}")

    index = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            index[id(p)] = len(index)
    sd = optimizer.state_dict()
    sd["state"] = {
        index[id(p)]: {"step": torch.tensor(float(adam_count)),
                       "exp_avg": exp_avg[name].clone(),
                       "exp_avg_sq": exp_avg_sq[name].clone()}
        for name, p in params.items() if p.requires_grad and id(p) in index}
    optimizer.load_state_dict(sd)
    scheduler.last_epoch = sched_count
    lrs = [base * f(sched_count)
           for f, base in zip(scheduler.lr_lambdas, scheduler.base_lrs)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
