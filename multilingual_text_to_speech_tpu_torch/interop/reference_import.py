"""The reference model's PyTorch checkpoints -> the port.

Port of the JAX package's ``interop/torch_port.py``.  The reference model
ships pretrained PyTorch checkpoints and rebuilds models from them
(reference ``utils/__init__.py:20-37``: ``torch.load`` + DataParallel
prefix strip + ``Params.load_state_dict(state['parameters'])``).  This
module turns such a checkpoint into the JAX package's
``{"params", "batch_stats"}`` weight tree, the layout the port's
checkpoint file holds (``interop.params_from_jax`` maps it onto the port's
modules):

- torch ``Linear``/``Conv1d``/``LSTMCell``/``nn.LSTM``/``nn.GRU`` weights
  are transposed and reordered into the flax kernel layouts (including the
  fused-gate LSTM cells and the generated convolutions' generators, whose
  columns are ordered ``(k, cin, cout)``);
- batch-norm running statistics land in ``batch_stats``;
- the hyper-parameter section translates through the shared schema
  (``config.HParams`` mirrors the reference ``params/params.py``).

The functions are the JAX package's, copied as they are, so both packages
import a checkpoint to the same tree bit for bit.  The strict merge
template is ``params_to_jax`` of the port's own ``Tacotron(hp)`` instead
of a flax init.  Used by ``cli/import_reference_checkpoint.py``.
Everything here is plain numpy; ``import_reference_checkpoint`` reads the
file with ``torch.load``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np


def t2j(t) -> np.ndarray:
    """torch tensor (or array-like) -> float32 numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(np.float32)


def strip_dataparallel_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.`` key prefix DataParallel training leaves behind
    (reference utils/__init__.py:20-26)."""
    return {
        (k[7:] if k.startswith("module.") else k): v for k, v in sd.items()
    }


def lin_kernel(w) -> np.ndarray:
    """torch Linear weight [out, in] -> flax Dense kernel [in, out]."""
    return t2j(w).T


def conv_kernel(w) -> np.ndarray:
    """torch Conv1d weight [out, in/g, k] -> flax/lax kernel [k, in/g, out]."""
    return t2j(w).transpose(2, 1, 0)


def dense(sd, prefix) -> dict:
    return {
        "kernel": lin_kernel(sd[f"{prefix}.weight"]),
        "bias": t2j(sd[f"{prefix}.bias"]),
    }


def fused_lstm(sd, prefix) -> dict:
    """torch LSTMCell weights -> this repo's fused-gate LSTMCell params.

    torch keeps (i, f, g, o) gate blocks in weight_ih [4h, in] /
    weight_hh [4h, h] and two bias vectors; the fused cell concatenates
    [x, h] and uses one [(in+h), 4h] kernel with a single bias.
    """
    w_ih, w_hh = sd[f"{prefix}.weight_ih"], sd[f"{prefix}.weight_hh"]
    b = t2j(sd[f"{prefix}.bias_ih"]) + t2j(sd[f"{prefix}.bias_hh"])
    kernel = np.concatenate([t2j(w_ih).T, t2j(w_hh).T], axis=0)
    return {"cell": {"gates": {"kernel": kernel, "bias": b}}}


def bigru(sd, prefix) -> dict:
    """torch nn.GRU(bidirectional, 1 layer) weights -> flax GRUCell params.

    torch stacks (r, z, n) gate blocks in weight_ih [3h, in] / weight_hh
    [3h, h]; flax GRUCell keeps per-gate denses ``ir/iz/in`` (with bias) and
    ``hr/hz/hn`` (bias only on ``hn``).  Both factor the candidate gate as
    ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``, so torch's b_hn maps
    to the flax ``hn`` bias while b_ir/b_iz fold into ``ir``/``iz``."""

    def one_direction(suffix):
        w_ih = t2j(sd[f"{prefix}.weight_ih_l0{suffix}"])
        w_hh = t2j(sd[f"{prefix}.weight_hh_l0{suffix}"])
        b_ih = t2j(sd[f"{prefix}.bias_ih_l0{suffix}"])
        b_hh = t2j(sd[f"{prefix}.bias_hh_l0{suffix}"])
        h = w_hh.shape[1]
        p = {}
        for gi, gate in enumerate(("r", "z", "n")):
            sl = slice(gi * h, (gi + 1) * h)
            p[f"i{gate}"] = {
                "kernel": w_ih[sl].T,
                "bias": b_ih[sl] + (b_hh[sl] if gate != "n" else 0.0),
            }
            p[f"h{gate}"] = {"kernel": w_hh[sl].T}
        p["hn"]["bias"] = b_hh[2 * h:3 * h]
        return p

    return {
        "GRUCell_0": one_direction(""),
        "GRUCell_1": one_direction("_reverse"),
    }


def bilstm(sd, prefix) -> dict:
    """torch nn.LSTM(bidirectional) weights -> flax OptimizedLSTMCell params
    (per-gate denses, order i/f/g/o).  The two cells live directly in the
    Encoder's scope as OptimizedLSTMCell_{0,1} (fwd, bwd)."""

    def one_direction(suffix):
        w_ih = t2j(sd[f"{prefix}.weight_ih_l0{suffix}"])
        w_hh = t2j(sd[f"{prefix}.weight_hh_l0{suffix}"])
        b = t2j(sd[f"{prefix}.bias_ih_l0{suffix}"]) + t2j(
            sd[f"{prefix}.bias_hh_l0{suffix}"]
        )
        h = w_hh.shape[1]
        p = {}
        for gi, gate in enumerate(("i", "f", "g", "o")):
            p[f"i{gate}"] = {"kernel": w_ih[gi * h:(gi + 1) * h].T}
            p[f"h{gate}"] = {
                "kernel": w_hh[gi * h:(gi + 1) * h].T,
                "bias": b[gi * h:(gi + 1) * h],
            }
        return p

    return {
        "OptimizedLSTMCell_0": one_direction(""),
        "OptimizedLSTMCell_1": one_direction("_reverse"),
    }


def gen_kernel_dense(sd, prefix, cout, cin, k) -> dict:
    """torch ``Conv1dGenerated._kernel`` Linear -> this repo's generating
    Dense: the flax generator's columns are ordered ``(k, cin, cout)`` per
    group instead of torch's ``(cout, cin, k)`` (see the JAX package's
    ``Conv1dGenerated.generate``), so permute the torch rows first."""
    w = t2j(sd[f"{prefix}.weight"])   # [cout*cin*k, bottleneck]
    b = t2j(sd[f"{prefix}.bias"])
    w = w.reshape(cout, cin, k, -1).transpose(2, 1, 0, 3).reshape(
        k * cin * cout, -1
    )
    b = b.reshape(cout, cin, k).transpose(2, 1, 0).reshape(-1)
    return {"kernel": w.T, "bias": b}


def port_convblock(sd, prefix, batch_norm=True):
    """Reference ConvBlock state (Sequential: 0 pad, 1 conv, 2 bn, ...) ->
    (params, batch_stats) for this repo's ConvBlock."""
    params = {"Conv_0": {"kernel": conv_kernel(sd[f"{prefix}_block.1.weight"])}}
    stats = {}
    if batch_norm:
        params["BatchNorm_0"] = {
            "scale": t2j(sd[f"{prefix}_block.2.weight"]),
            "bias": t2j(sd[f"{prefix}_block.2.bias"]),
        }
        stats["BatchNorm_0"] = {
            "mean": t2j(sd[f"{prefix}_block.2.running_mean"]),
            "var": t2j(sd[f"{prefix}_block.2.running_var"]),
        }
    else:
        params["Conv_0"]["bias"] = t2j(sd[f"{prefix}_block.1.bias"])
    return params, stats


def port_generated_block(sd, prefix, cout, cin, k, batch_norm=True):
    """Reference ConvBlockGenerated state -> (params, batch_stats).
    ``cout``/``cin`` are PER-GROUP channel counts of the inner conv."""
    conv = {
        "bottleneck": dense(sd, f"{prefix}_convolution._bottleneck"),
        "kernel": gen_kernel_dense(
            sd, f"{prefix}_convolution._kernel", cout, cin, k
        ),
    }
    if not batch_norm:
        conv["bias"] = dense(sd, f"{prefix}_convolution._bias")
    params = {"Conv1dGenerated_0": conv}
    stats = {}
    if batch_norm:
        params["BatchNorm1dGenerated_0"] = {
            "bottleneck": dense(sd, f"{prefix}_regularizer._bottleneck"),
            "affine": dense(sd, f"{prefix}_regularizer._affine"),
        }
        stats["BatchNorm1dGenerated_0"] = {
            "mean": t2j(sd[f"{prefix}_regularizer.running_mean"]),
            "var": t2j(sd[f"{prefix}_regularizer.running_var"]),
        }
    return params, stats


def port_lsa(sd, prefix="_attention"):
    """Reference LocationSensitiveAttention -> this repo's explicit params
    (the memory projection lives on the Decoder, ported separately)."""
    return {
        "query_kernel": lin_kernel(sd[f"{prefix}._query.weight"]),
        "energy_kernel": lin_kernel(sd[f"{prefix}._energy.weight"]),
        "location_kernel": lin_kernel(sd[f"{prefix}._location.weight"]),
        "loc_filter": t2j(sd[f"{prefix}._loc_features.weight"]).transpose(2, 1, 0),
        "bias": t2j(sd[f"{prefix}._bias"]),
    }


def port_forward_attention(sd, prefix="_attention", transition=False):
    """Reference ForwardAttention(/WithTransition) -> this repo's params
    (models/attention.py::_ForwardEnergy tree; reference
    modules/attention.py:89-160)."""
    att = {
        "energy_net": {
            "query": {"kernel": lin_kernel(sd[f"{prefix}._query.weight"])},
            "energy": {"kernel": lin_kernel(sd[f"{prefix}._energy.weight"])},
            "bias": t2j(sd[f"{prefix}._bias"]),
        }
    }
    if transition:
        att["transition_agent"] = dense(sd, f"{prefix}._transition_agent")
    return att


def port_attention(sd, hp, prefix="_attention"):
    """Family-dispatching attention port (hp.attention_type)."""
    kind = hp.attention_type
    if kind == "location_sensitive":
        return port_lsa(sd, prefix)
    if kind == "forward":
        return port_forward_attention(sd, prefix, transition=False)
    if kind == "forward_transition_agent":
        return port_forward_attention(sd, prefix, transition=True)
    raise ValueError(f"unknown attention_type: {kind!r}")


def port_decoder(sd, hp, prefix=""):
    """Reference Decoder + attention + prenet -> this repo's Decoder tree."""
    dec = {"memory": {"kernel": lin_kernel(sd[f"{prefix}_attention._memory.weight"])}}
    if hp.multi_speaker and hp.speaker_embedding_dimension > 0:
        dec["speaker_embedding"] = {
            "embedding": t2j(sd[f"{prefix}_decoder._speaker_embedding.weight"])
        }
    if hp.multi_language and hp.language_embedding_dimension > 0:
        dec["language_embedding"] = {
            "embedding": t2j(sd[f"{prefix}_decoder._language_embedding.weight"])
        }
    dec["cell"] = {
        "prenet": {
            f"fc{i}": dense(sd, f"{prefix}_prenet._layers.{i}")
            for i in range(hp.prenet_layers)
        },
        "attention_lstm": fused_lstm(sd, f"{prefix}_decoder._attention_lstm"),
        "generator_lstm": fused_lstm(sd, f"{prefix}_decoder._generator_lstm"),
        "attention": port_attention(sd, hp, f"{prefix}_attention"),
        "frame_prediction": dense(sd, f"{prefix}_decoder._frame_prediction"),
        "stop_prediction": dense(sd, f"{prefix}_decoder._stop_prediction"),
    }
    return dec


# generated encoder stack: 2 conv + 8 dilated highway + 2 highway + 2 k=1
N_GENERATED_LAYERS = 14


def _stack_trees(trees):
    """Stack same-structured numpy pytrees along a new leading axis (for the
    vmapped MultiEncoder whose parameters carry a leading language axis)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def port_simple_encoder(sd, prefix, hp):
    """Reference vanilla Encoder (conv stack + packed BiLSTM,
    modules/encoder.py:9-45) under ``prefix`` -> (params, batch_stats)."""
    enc, stats = {}, {}
    for i in range(hp.encoder_blocks):
        blk, st = port_convblock(sd, f"{prefix}._convs.{i}.")
        enc[f"conv{i}"] = blk
        stats[f"conv{i}"] = st
    enc.update(bilstm(sd, f"{prefix}._lstm"))
    return enc, stats


def port_convolutional_encoder(sd, prefix, generated, hp):
    """Reference (Generated)ConvolutionalEncoder stack
    (modules/encoder.py:100-221) -> (params, batch_stats) for this repo's
    grouped group-major stack (models/encoder.py::_GroupedConvStack)."""
    e_dim = hp.encoder_dimension
    enc, enc_stats = {}, {}
    if generated:
        enc["generator_embedding"] = {
            "embedding": t2j(sd[f"{prefix}._embedding.weight"])
        }
    stack, stack_stats = {}, {}
    specs = (  # per-group (kernel, cin, cout) of each stack layer
        [(1, hp.embedding_dimension, e_dim), (1, e_dim, e_dim)]
        + [(3, e_dim, 2 * e_dim)] * 10
        + [(1, e_dim, 2 * e_dim)] * 2
    )
    for i, (k, cin, cout) in enumerate(specs):
        if generated:
            blk, st = port_generated_block(
                sd, f"{prefix}._layers.{i}.", cout=cout, cin=cin, k=k
            )
            wrap = "ConvBlockGenerated_0"
        else:
            blk, st = port_convblock(sd, f"{prefix}._layers.{i}.")
            wrap = "ConvBlock_0"
        if i >= 2:  # highway blocks wrap the inner conv block
            blk = {wrap: blk}
            st = {wrap: st}
        stack[f"layer{i}"] = blk
        stack_stats[f"layer{i}"] = st
    enc["stack"] = stack
    enc_stats["stack"] = stack_stats
    return enc, enc_stats


def port_cbhg(sd, hp, prefix="_postnet"):
    """Reference PostnetCBHG (modules/cbhg.py:8-69) -> (params, batch_stats)
    for this repo's PostnetCBHG (models/postnet.py)."""
    params, stats = {}, {}
    for i in range(hp.cbhg_bank_kernels):
        blk, st = port_convblock(sd, f"{prefix}._bank.{i}.")
        params[f"bank{i + 1}"] = blk
        stats[f"bank{i + 1}"] = st
    for name, idx in (("projection1", 2), ("projection2", 3)):
        blk, st = port_convblock(sd, f"{prefix}._pool_and_project.{idx}.")
        params[name] = blk
        stats[name] = st
    params["pre_highway"] = dense(sd, f"{prefix}._highway_layers.0")
    for i in range(4):
        hw = f"{prefix}._highway_layers.{2 + i}"
        params[f"highway{i}"] = {
            "linear": dense(sd, f"{hw}._linear.0"),
            "gate": dense(sd, f"{hw}._gate.0"),
        }
    params.update(bigru(sd, f"{prefix}._gru"))
    params["output"] = dense(sd, f"{prefix}._output_layer")
    return params, stats


def port_state_dict(sd: Mapping[str, Any], hp) -> Dict[str, dict]:
    """Full reference Tacotron ``state_dict`` (all five encoder types, conv
    or CBHG postnet) -> ``{'params', 'batch_stats'}`` pytrees for this
    repo's Tacotron (reference module tree: modules/tacotron2.py:222-312,
    encoder dispatch utils/__init__.py:29-37 via tacotron2.py:286-303)."""
    params = {"embedding": {"embedding": t2j(sd["_embedding.weight"])}}
    stats = {}

    if hp.encoder_type in ("generated", "convolutional"):
        enc, enc_stats = port_convolutional_encoder(
            sd, "_encoder", hp.encoder_type == "generated", hp
        )
        params["encoder"] = enc
        stats["encoder"] = enc_stats
    elif hp.encoder_type == "simple":
        enc, enc_stats = port_simple_encoder(sd, "_encoder", hp)
        params["encoder"] = enc
        stats["encoder"] = enc_stats
    elif hp.encoder_type == "shared":
        enc, enc_stats = port_simple_encoder(sd, "_encoder._encoder", hp)
        params["encoder"] = {
            "language_embedding": {
                "embedding": t2j(sd["_encoder._language_embedding.weight"])
            },
            "encoder": enc,
        }
        stats["encoder"] = {"encoder": enc_stats}
    elif hp.encoder_type == "separate":
        per_lang = [
            port_simple_encoder(sd, f"_encoder._encoders.{l}", hp)
            for l in range(hp.language_number)
        ]
        params["encoder"] = {
            "encoders": _stack_trees([p for p, _ in per_lang])
        }
        stats["encoder"] = {
            "encoders": _stack_trees([s for _, s in per_lang])
        }
    else:
        raise ValueError(
            f"unknown reference encoder_type {hp.encoder_type!r} "
            "(expected generated/convolutional/simple/shared/separate, "
            "reference modules/tacotron2.py:286-303)"
        )

    if hp.reversal_classifier:
        params["classifier"] = {
            "fc1": dense(sd, "_reversal_classifier._classifier.0"),
            "fc2": dense(sd, "_reversal_classifier._classifier.1"),
        }

    params["decoder"] = port_decoder(sd, hp)

    if hp.predict_linear:  # CBHG linear-prediction postnet (tacotron2.py:284)
        postnet, postnet_stats = port_cbhg(sd, hp)
    else:
        postnet, postnet_stats = {}, {}
        for i in range(hp.postnet_blocks):
            blk, st = port_convblock(sd, f"_postnet._convs.{i}.")
            postnet[f"conv{i}"] = blk
            postnet_stats[f"conv{i}"] = st
    params["postnet"] = postnet
    stats["postnet"] = postnet_stats
    return {"params": params, "batch_stats": stats}


def port_tacotron(torch_model, hp) -> Dict[str, dict]:
    """Port a live reference Tacotron module."""
    return port_state_dict(torch_model.state_dict(), hp)


def merge_into(base, over, path="", strict=False):
    """Replace leaves of ``base`` with same-shaped leaves of ``over``.

    Keys in ``over`` must exist in ``base``; with ``strict`` every key of
    ``base`` must be covered (full-model ports may not silently miss
    parameters).  Returns plain float32 numpy leaves."""
    out = {}
    missing = set(base) - set(over)
    extra = set(over) - set(base)
    if extra:
        raise KeyError(f"ported keys not in model at {path}: {sorted(extra)}")
    if strict and missing:
        raise KeyError(f"model keys not ported at {path}: {sorted(missing)}")
    for k, v in base.items():
        if k not in over:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = merge_into(v, over[k], f"{path}/{k}", strict)
        else:
            if np.shape(v) != np.shape(over[k]):
                raise ValueError(
                    f"{path}/{k}: model {np.shape(v)} vs ported "
                    f"{np.shape(over[k])}"
                )
            out[k] = np.asarray(over[k], np.float32)
    return out


def hp_from_reference_state(parameters: Mapping[str, Any]):
    """Reference ``Params.state_dict()`` section -> this framework's
    ``HParams`` (shared ~90-key schema; unknown extra keys carry over as
    plain attributes, framework-only keys keep their defaults)."""
    from multilingual_text_to_speech_tpu_torch.config import HParams

    return HParams.from_state_dict(dict(parameters))


def criterion_state_from_reference(state: Mapping[str, Any], hp
                                   ) -> Dict[str, float]:
    """Reference ``TacotronLoss.state_dict()`` (``{'_g', '_g_steps'}``,
    tacotron2.py:433-438) -> this framework's guided-attention schedule."""
    return {
        "guided_att_variance": float(
            state.get("_g", hp.guided_attention_toleration)),
        "guided_att_steps": int(
            state.get("_g_steps", hp.guided_attention_steps)),
        "guided_att_gamma": float(hp.guided_attention_gain),
    }


def import_reference_checkpoint(path: str) -> Tuple[Any, dict, dict, dict]:
    """Load a reference torch checkpoint file and port everything portable.

    Returns ``(hp, variables, criterion_state, meta)`` where ``variables``
    is ``{'params', 'batch_stats'}`` merged into a freshly initialized
    model tree (strict: every model parameter must be covered) and ``meta``
    carries ``{'epoch'}``.  Optimizer/scheduler state is NOT ported (torch
    Adam moments do not transfer to optax pytrees) — fine-tuning restarts
    the optimizer, synthesis does not need it.
    """
    import torch

    state = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "parameters"):
        if key not in state:
            raise ValueError(
                f"{path!r} does not look like a reference checkpoint "
                f"(missing {key!r}; reference train.py:302-308 saves "
                "epoch/model/optimizer/scheduler/parameters/criterion)"
            )
    hp = hp_from_reference_state(state["parameters"])
    sd = strip_dataparallel_prefix(state["model"])
    ported = port_state_dict(sd, hp)
    variables = _init_template(hp)
    merged = {
        "params": merge_into(variables["params"], ported["params"],
                             strict=True),
        "batch_stats": merge_into(
            dict(variables.get("batch_stats", {})), ported["batch_stats"],
            strict=True),
    }
    criterion = criterion_state_from_reference(
        state.get("criterion", {}) or {}, hp)
    meta = {"epoch": int(state.get("epoch", 0))}
    return hp, merged, criterion, meta


def _init_template(hp):
    """The strict merge template: ``params_to_jax`` of a port ``Tacotron``
    for ``hp`` on the CPU (its values are all overwritten; its paths and
    shapes are the flax init's)."""
    from multilingual_text_to_speech_tpu_torch.interop.from_jax import (
        params_to_jax,
    )
    from multilingual_text_to_speech_tpu_torch.models.tacotron import Tacotron

    return params_to_jax(Tacotron(hp).state_dict(), hp)
