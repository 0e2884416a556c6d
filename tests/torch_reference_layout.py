"""A seeded weight tree in the reference model's PyTorch layout.

The inverse of ``port_state_dict`` (the JAX package's
``interop/torch_port.py`` and the port's ``interop/reference_import.py``):
a ``{"params", "batch_stats"}`` tree in the flax layout becomes the
``state_dict`` of the reference model (``modules/tacotron2.py``) that those
importers read, for all five encoders, either postnet and the reversal
classifier.  Each LSTM's second bias and each GRU's r and z ``bias_hh``
are zero, so importing the result gives the tree back bit for bit.  The
reference checkout is not needed: the tests write the dict with
``torch.save`` as the reference's ``train.py`` does.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _convblock(sd, prefix, p, st):
    sd[f"{prefix}_block.1.weight"] = _t(
        np.transpose(p["Conv_0"]["kernel"], (2, 1, 0)))
    bn, bs = p["BatchNorm_0"], st["BatchNorm_0"]
    sd[f"{prefix}_block.2.weight"] = _t(bn["scale"])
    sd[f"{prefix}_block.2.bias"] = _t(bn["bias"])
    sd[f"{prefix}_block.2.running_mean"] = _t(bs["mean"])
    sd[f"{prefix}_block.2.running_var"] = _t(bs["var"])
    sd[f"{prefix}_block.2.num_batches_tracked"] = torch.tensor(3)


def _generated_block(sd, prefix, p, st, cout, cin, k):
    conv = p["Conv1dGenerated_0"]
    _dense(sd, f"{prefix}_convolution._bottleneck", conv["bottleneck"])
    w = np.asarray(conv["kernel"]["kernel"]).T        # [k*cin*cout, bn]
    w = w.reshape(k, cin, cout, -1).transpose(2, 1, 0, 3).reshape(
        cout * cin * k, -1)
    b = np.asarray(conv["kernel"]["bias"]).reshape(k, cin, cout).transpose(
        2, 1, 0).reshape(-1)
    sd[f"{prefix}_convolution._kernel.weight"] = _t(w)
    sd[f"{prefix}_convolution._kernel.bias"] = _t(b)
    reg = p["BatchNorm1dGenerated_0"]
    _dense(sd, f"{prefix}_regularizer._bottleneck", reg["bottleneck"])
    _dense(sd, f"{prefix}_regularizer._affine", reg["affine"])
    sd[f"{prefix}_regularizer.running_mean"] = _t(
        st["BatchNorm1dGenerated_0"]["mean"])
    sd[f"{prefix}_regularizer.running_var"] = _t(
        st["BatchNorm1dGenerated_0"]["var"])


def _fused_lstm(sd, prefix, p):
    kernel = np.asarray(p["cell"]["gates"]["kernel"])
    h = kernel.shape[1] // 4
    n_in = kernel.shape[0] - h
    bias = np.asarray(p["cell"]["gates"]["bias"])
    sd[f"{prefix}.weight_ih"] = _t(kernel[:n_in].T)
    sd[f"{prefix}.weight_hh"] = _t(kernel[n_in:].T)
    sd[f"{prefix}.bias_ih"] = _t(bias)
    sd[f"{prefix}.bias_hh"] = _t(np.zeros_like(bias))


def _bilstm(sd, prefix, p):
    for cell, suffix in (("OptimizedLSTMCell_0", ""),
                         ("OptimizedLSTMCell_1", "_reverse")):
        c = p[cell]
        gates = ("i", "f", "g", "o")
        sd[f"{prefix}.weight_ih_l0{suffix}"] = _t(np.concatenate(
            [np.asarray(c[f"i{g}"]["kernel"]).T for g in gates]))
        sd[f"{prefix}.weight_hh_l0{suffix}"] = _t(np.concatenate(
            [np.asarray(c[f"h{g}"]["kernel"]).T for g in gates]))
        bias = np.concatenate([c[f"h{g}"]["bias"] for g in gates])
        sd[f"{prefix}.bias_ih_l0{suffix}"] = _t(bias)
        sd[f"{prefix}.bias_hh_l0{suffix}"] = _t(np.zeros_like(bias))


def _bigru(sd, prefix, p):
    for cell, suffix in (("GRUCell_0", ""), ("GRUCell_1", "_reverse")):
        c = p[cell]
        gates = ("r", "z", "n")
        sd[f"{prefix}.weight_ih_l0{suffix}"] = _t(np.concatenate(
            [np.asarray(c[f"i{g}"]["kernel"]).T for g in gates]))
        sd[f"{prefix}.weight_hh_l0{suffix}"] = _t(np.concatenate(
            [np.asarray(c[f"h{g}"]["kernel"]).T for g in gates]))
        sd[f"{prefix}.bias_ih_l0{suffix}"] = _t(np.concatenate(
            [c[f"i{g}"]["bias"] for g in gates]))
        hn = np.asarray(c["hn"]["bias"])
        sd[f"{prefix}.bias_hh_l0{suffix}"] = _t(np.concatenate(
            [np.zeros_like(hn), np.zeros_like(hn), hn]))


def _simple_encoder(sd, prefix, p, st, hp):
    for i in range(hp.encoder_blocks):
        _convblock(sd, f"{prefix}._convs.{i}.", p[f"conv{i}"], st[f"conv{i}"])
    _bilstm(sd, f"{prefix}._lstm", p)


def _convolutional_encoder(sd, prefix, p, st, generated, hp):
    e = hp.encoder_dimension
    if generated:
        sd[f"{prefix}._embedding.weight"] = _t(
            p["generator_embedding"]["embedding"])
    specs = ([(1, hp.embedding_dimension, e), (1, e, e)]
             + [(3, e, 2 * e)] * 10 + [(1, e, 2 * e)] * 2)
    wrap = "ConvBlockGenerated_0" if generated else "ConvBlock_0"
    for i, (k, cin, cout) in enumerate(specs):
        blk, bst = p["stack"][f"layer{i}"], st["stack"][f"layer{i}"]
        if i >= 2:
            blk, bst = blk[wrap], bst[wrap]
        if generated:
            _generated_block(sd, f"{prefix}._layers.{i}.", blk, bst, cout,
                             cin, k)
        else:
            _convblock(sd, f"{prefix}._layers.{i}.", blk, bst)


def _attention(sd, prefix, p, hp):
    if hp.attention_type == "location_sensitive":
        for name in ("query", "energy", "location"):
            sd[f"{prefix}._{name}.weight"] = _t(
                np.asarray(p[f"{name}_kernel"]).T)
        sd[f"{prefix}._loc_features.weight"] = _t(
            np.transpose(p["loc_filter"], (2, 1, 0)))
        sd[f"{prefix}._bias"] = _t(p["bias"])
        return
    net = p["energy_net"]
    sd[f"{prefix}._query.weight"] = _t(np.asarray(net["query"]["kernel"]).T)
    sd[f"{prefix}._energy.weight"] = _t(np.asarray(net["energy"]["kernel"]).T)
    sd[f"{prefix}._bias"] = _t(net["bias"])
    if hp.attention_type == "forward_transition_agent":
        _dense(sd, f"{prefix}._transition_agent", p["transition_agent"])


def _decoder(sd, p, hp):
    sd["_attention._memory.weight"] = _t(np.asarray(p["memory"]["kernel"]).T)
    if "speaker_embedding" in p:
        sd["_decoder._speaker_embedding.weight"] = _t(
            p["speaker_embedding"]["embedding"])
    if "language_embedding" in p:
        sd["_decoder._language_embedding.weight"] = _t(
            p["language_embedding"]["embedding"])
    cell = p["cell"]
    for i in range(hp.prenet_layers):
        _dense(sd, f"_prenet._layers.{i}", cell["prenet"][f"fc{i}"])
    _fused_lstm(sd, "_decoder._attention_lstm", cell["attention_lstm"])
    _fused_lstm(sd, "_decoder._generator_lstm", cell["generator_lstm"])
    _attention(sd, "_attention", cell["attention"], hp)
    _dense(sd, "_decoder._frame_prediction", cell["frame_prediction"])
    _dense(sd, "_decoder._stop_prediction", cell["stop_prediction"])


def _cbhg(sd, p, st, hp):
    for i in range(hp.cbhg_bank_kernels):
        _convblock(sd, f"_postnet._bank.{i}.", p[f"bank{i + 1}"],
                   st[f"bank{i + 1}"])
    for name, idx in (("projection1", 2), ("projection2", 3)):
        _convblock(sd, f"_postnet._pool_and_project.{idx}.", p[name],
                   st[name])
    _dense(sd, "_postnet._highway_layers.0", p["pre_highway"])
    for i in range(4):
        hw = f"_postnet._highway_layers.{2 + i}"
        _dense(sd, f"{hw}._linear.0", p[f"highway{i}"]["linear"])
        _dense(sd, f"{hw}._gate.0", p[f"highway{i}"]["gate"])
    _bigru(sd, "_postnet._gru", p)
    _dense(sd, "_postnet._output_layer", p["output"])


def reference_state_dict(variables, hp):
    """``{"params", "batch_stats"}`` (flax layout, numpy) -> the reference
    model's ``state_dict`` for ``hp``."""
    p, st = variables["params"], variables["batch_stats"]
    sd = {"_embedding.weight": _t(p["embedding"]["embedding"])}
    enc, est = p["encoder"], st.get("encoder", {})
    kind = hp.encoder_type
    if kind in ("generated", "convolutional"):
        _convolutional_encoder(sd, "_encoder", enc, est,
                               kind == "generated", hp)
    elif kind == "simple":
        _simple_encoder(sd, "_encoder", enc, est, hp)
    elif kind == "shared":
        sd["_encoder._language_embedding.weight"] = _t(
            enc["language_embedding"]["embedding"])
        _simple_encoder(sd, "_encoder._encoder", enc["encoder"],
                        est["encoder"], hp)
    elif kind == "separate":
        for lang in range(hp.language_number):
            pick = _index(lang)
            _simple_encoder(sd, f"_encoder._encoders.{lang}",
                            pick(enc["encoders"]), pick(est["encoders"]), hp)
    else:
        raise ValueError(kind)
    if hp.reversal_classifier:
        _dense(sd, "_reversal_classifier._classifier.0", p["classifier"]["fc1"])
        _dense(sd, "_reversal_classifier._classifier.1", p["classifier"]["fc2"])
    _decoder(sd, p["decoder"], hp)
    if hp.predict_linear:
        _cbhg(sd, p["postnet"], st["postnet"], hp)
    else:
        for i in range(hp.postnet_blocks):
            _convblock(sd, f"_postnet._convs.{i}.", p["postnet"][f"conv{i}"],
                       st["postnet"][f"conv{i}"])
    return sd


def _index(lang):
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return np.asarray(tree)[lang]
    return pick


def save_reference_checkpoint(path, variables, hp, epoch=7,
                              criterion=None, data_parallel=True):
    """``torch.save`` a reference training checkpoint (``train.py``'s
    ``epoch/model/optimizer/scheduler/parameters/criterion`` sections);
    with ``data_parallel`` every model key carries DataParallel's
    ``module.`` prefix."""
    sd = reference_state_dict(variables, hp)
    if data_parallel:
        sd = {f"module.{k}": v for k, v in sd.items()}
    torch.save({"epoch": epoch, "model": sd, "optimizer": {},
                "scheduler": {}, "parameters": hp.state_dict(),
                "criterion": criterion if criterion is not None
                else {"_g": 0.35, "_g_steps": 17}}, path)
