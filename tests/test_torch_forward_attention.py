"""The port's forward-attention family (``forward`` and
``forward_transition_agent``) against the JAX package, on the CPU in
float32.

Both packages get the same numpy-seeded weights through ``params_from_jax``.
The JAX side runs its modules, its XLA decode scan, and its two Pallas
kernels in interpret mode (``fused_decode_chunk(..., interpret=True)``,
``make_train_decode_fn(..., interpret=True)``); the port runs the plain
PyTorch versions of its kernels, which is what its kernel wrappers run on a
CPU tensor.  Texts are shorter than their bucket, so that the unmasked
softmax and the 1e-6 floor meet padded positions.  Bounds start from the
JAX package's own forward-family tests (3e-5 a chunk, 2e-4 chained, 5e-6
for the train forward).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.models import attention as jax_attention
from multilingual_text_to_speech_tpu.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu.ops import pallas_decoder
from multilingual_text_to_speech_tpu.ops import pallas_train_decoder as ptd
from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models.attention import (
    init_attention_state,
)
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from tests.torch_port_utils import (
    batch,
    jax_variables,
    port_hp,
    port_model,
    tiny_hp,
    to_np,
    variables_np,
)

KINDS = ["forward", "forward_transition_agent"]


@functools.lru_cache(maxsize=None)
def _models(attention_type):
    hp = tiny_hp(attention_type=attention_type)
    v_np = variables_np(attention_type=attention_type)
    return (hp, Tacotron(hp, train=False), jax_variables(v_np), v_np,
            port_model(hp, v_np))


def _step_inputs(hp, b=3, t=16, seed=3):
    """One attention step's inputs; row 0 fills the bucket, the others end
    inside it."""
    rng = np.random.RandomState(seed)
    mem = hp.encoder_dimension + hp.speaker_embedding_dimension \
        + hp.language_embedding_dimension
    lengths = np.array([t, t - 5, t - 9][:b])
    prev = np.exp(rng.randn(b, t)).astype(np.float32)
    prev[:, -3:] = 0.0          # as after a renorm: masked positions small
    prev /= prev.sum(-1, keepdims=True)
    return {
        "query": rng.randn(b, hp.decoder_dimension).astype(np.float32),
        "memory": rng.randn(b, t, mem).astype(np.float32),
        "mt": (rng.randn(b, t, hp.attention_dimension) * 0.5).astype(
            np.float32),
        "mask": np.arange(t)[None, :] < lengths[:, None],
        "prev": prev,
        "t_prob": rng.uniform(0.1, 0.9, (b, 1)).astype(np.float32),
        "x": rng.randn(b, hp.prenet_dimension).astype(np.float32),
    }


@pytest.mark.parametrize("attention_type", KINDS)
def test_attention_step_matches_jax_module(attention_type):
    """``fwd_attention_plain`` against flax ``ForwardAttention`` /
    ``ForwardAttentionWithTransition`` on the same weights: context,
    weights and t_prob within atol 1e-5 (float32 sums in another order;
    the port adds the energy bias to the memory transform first, as the
    TPU kernel does).  The weights are a distribution that is 1e-6-floored
    at the masked positions."""
    hp, _, _, v_np, port = _models(attention_type)
    att_np = v_np["params"]["decoder"]["cell"]["attention"]
    x = _step_inputs(hp)
    cls = (jax_attention.ForwardAttention if attention_type == "forward"
           else jax_attention.ForwardAttentionWithTransition)
    state = {"weights": jnp.asarray(x["prev"])}
    if attention_type != "forward":
        state["t_prob"] = jnp.asarray(x["t_prob"])
    ctx_r, w_r, st_r = cls(representation_dim=hp.attention_dimension).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, att_np)},
        jnp.asarray(x["query"]), jnp.asarray(x["memory"]),
        jnp.asarray(x["mt"]), jnp.asarray(x["mask"]), state,
        jnp.asarray(x["x"]))

    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, torch.float32, quantize_gates=False)
    assert bundle.att_kind == ("fwd" if attention_type == "forward"
                               else "fwd_trans")
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    memory, mtb, mask_add = fused_decoder.chunk_operands(
        bundle, t["memory"], t["mt"], t["mask"])
    ctx, w, tp = fused_decoder.fwd_attention_plain(
        t["query"], t["prev"], None if attention_type == "forward"
        else t["t_prob"], memory, mtb, mask_add, t["x"], bundle)
    np.testing.assert_allclose(to_np(ctx), np.asarray(ctx_r), atol=1e-5)
    np.testing.assert_allclose(to_np(w), np.asarray(w_r), atol=1e-5)
    np.testing.assert_allclose(to_np(w), np.asarray(st_r["weights"]),
                               atol=1e-5)
    np.testing.assert_allclose(to_np(w).sum(-1), 1.0, rtol=1e-6)
    assert float(to_np(w)[~x["mask"]].min()) > 0.0
    if attention_type == "forward":
        assert tp is None and set(st_r) == {"weights"}
    else:
        np.testing.assert_allclose(to_np(tp), np.asarray(st_r["t_prob"]),
                                   atol=1e-5)


@pytest.mark.parametrize("attention_type", ["location_sensitive", *KINDS])
def test_initial_state_matches_jax(attention_type):
    """``init_attention_state``: zeros (location-sensitive), all mass on
    token 0 (the family), and t_prob at 0.5 for the agent."""
    ref = jax_attention.init_attention_state(attention_type, 3, 7)
    got = init_attention_state(attention_type, 3, 7)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(ref[k]))


def _decode_setup(attention_type, b=3, t=16):
    hp, model, variables, _, port = _models(attention_type)
    text, lengths, speakers = batch(hp, b, t, seed=7)
    langs = np.arange(b, dtype=np.int32) % 2
    memory, mt, mask, carry = jax.jit(functools.partial(
        model.apply, method=Tacotron.encode_for_inference))(
            variables, jnp.asarray(text), jnp.asarray(lengths),
            jnp.asarray(speakers), jnp.asarray(langs))
    t_in = tuple(torch.as_tensor(np.array(v)) for v in (memory, mt, mask))
    return hp, variables, port, (memory, mt, mask), carry, t_in


def _torch_carry(carry):
    return jax.tree_util.tree_map(lambda v: torch.as_tensor(np.array(v)),
                                  carry)


@pytest.mark.parametrize("attention_type", KINDS)
def test_decode_chunk_matches_pallas_kernel(attention_type):
    """``decode_chunk_plain`` against the JAX serving kernel in interpret
    mode (one batch block, prenet dropout 0.5, the same seed pair): 3
    steps within atol 3e-5 (spec, stop, the carried weights and t_prob),
    then a second chunk from each side's own carry within 2e-4 (the JAX
    kernel's own chaining bound).  Texts end inside the 16-wide bucket."""
    hp, variables, port, jx, carry, t_in = _decode_setup(attention_type)
    b = t_in[0].shape[0]
    jb = pallas_decoder.extract_decoder_bundle(variables, jnp.float32)
    bundle = fused_decoder.extract_decoder_bundle(
        port.decoder.cell, torch.float32, quantize_gates=False)
    kw = dict(dropout_rate=0.5, zoneout_h=hp.zoneout_hidden,
              zoneout_c=hp.zoneout_cell)
    carry_j, carry_p = carry, _torch_carry(carry)
    for chunk, (key, atol) in enumerate(((3, 3e-5), (9, 2e-4))):
        rng = jax.random.PRNGKey(key)
        carry_j, (spec_j, stop_j) = pallas_decoder.fused_decode_chunk(
            jb, carry_j, *jx, rng, 3, block_cap=b, interpret=True, **kw)
        bits = np.asarray(jax.random.bits(rng, (1, 1, 2), jnp.uint32))
        carry_p, (spec_p, stop_p) = fused_decoder.decode_chunk_plain(
            bundle, carry_p, *t_in, (int(bits[0, 0, 0]), int(bits[0, 0, 1])),
            3, **kw)
        for name, g, r in (
                ("spec", spec_p, spec_j), ("stop", stop_p, stop_j),
                ("weights", carry_p["att_state"]["weights"],
                 carry_j["att_state"]["weights"]),
                ("context", carry_p["context"], carry_j["context"])):
            np.testing.assert_allclose(to_np(g), np.asarray(r), atol=atol,
                                       err_msg=f"chunk {chunk} {name}")
        assert set(carry_p["att_state"]) == set(carry_j["att_state"])
        if attention_type != "forward":
            assert carry_p["att_state"]["t_prob"].shape == (b, 1)
            np.testing.assert_allclose(
                to_np(carry_p["att_state"]["t_prob"]),
                np.asarray(carry_j["att_state"]["t_prob"]), atol=atol,
                err_msg=f"chunk {chunk} t_prob")
        np.testing.assert_allclose(
            to_np(carry_p["att_state"]["weights"]).sum(-1), 1.0, rtol=1e-5)


def _syn_hp(attention_type):
    return tiny_hp(attention_type=attention_type, max_output_length=16,
                   decode_chunk_frames=8)


@pytest.mark.parametrize("attention_type", KINDS)
def test_synthesizer_matches_jax(attention_type):
    """A whole tiny Synthesizer of the family (encode, two chunks of 8
    frames, postnet, denormalization) on the CPU against the JAX
    ``Synthesizer`` on the same weights, stop bias -10: every spectrogram
    within rtol 1e-3, atol 1e-4, as the location-sensitive slice's test."""
    hp = _syn_hp(attention_type)
    v_np = variables_np(-10.0, attention_type=attention_type)
    jax_syn = Synthesizer(hp, jax_variables(v_np))
    port_syn = PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                               device="cpu")
    text, lengths, speakers = batch(hp, 3, 13, seed=11)
    seqs = [text[i, :lengths[i]] for i in range(3)]
    weights = []
    for i, seq in enumerate(seqs):
        w = np.zeros((1, len(seq), 2), np.float32)
        w[0, :, i % 2] = 1.0
        weights.append(w)
    args = (seqs, [int(s) for s in speakers], weights)
    ref = jax_syn.spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (hp.num_mels, 16)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# training: K2 (train and eval forward) and K3 against the JAX kernels
# ---------------------------------------------------------------------------

B, T, MEM, FRAMES = 3, 12, 12, 6


def _train_hp(attention_type):
    return tiny_hp(attention_type=attention_type, dropout=0.5,
                   zoneout_hidden=0.1, zoneout_cell=0.1)


def _cell_params(hp, seed=0):
    """numpy weights of one forward-family DecoderCell (flax layout, scale
    0.3)."""
    rng = np.random.RandomState(seed)
    h, p, a, m = (hp.decoder_dimension, hp.prenet_dimension,
                  hp.attention_dimension, hp.num_mels)

    def r(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    attention = {"energy_net": {"query": {"kernel": r(h, a)},
                                "bias": r(1, a),
                                "energy": {"kernel": r(a, 1)}}}
    if hp.attention_type == "forward_transition_agent":
        attention["transition_agent"] = {"kernel": r(MEM + h + p, 1),
                                         "bias": r(1)}
    return {
        "prenet": {f"fc{i}": {"kernel": r(m if i == 0 else p, p),
                              "bias": r(p)}
                   for i in range(hp.prenet_layers)},
        "attention_lstm": {"cell": {"gates": {
            "kernel": r(p + MEM + h, 4 * h), "bias": r(4 * h)}}},
        "attention": attention,
        "generator_lstm": {"cell": {"gates": {
            "kernel": r(h + MEM + h, 4 * h), "bias": r(4 * h)}}},
        "frame_prediction": {"kernel": r(h + MEM, m), "bias": r(m)},
        "stop_prediction": {"kernel": r(h + MEM, 1), "bias": r(1)},
    }


def _port_cell(hp, params):
    from multilingual_text_to_speech_tpu_torch.models.decoder import (
        DecoderCell,
    )

    cell = DecoderCell(port_hp(hp), MEM)
    sd = params_from_jax({"params": {"decoder": {"cell": params}}})
    cell.load_state_dict({k[len("decoder.cell."):]: v for k, v in sd.items()},
                         strict=True)
    return cell


def _train_inputs(hp, ratio=0.5, seed=1):
    rng = np.random.RandomState(seed)
    memory = rng.randn(B, T, MEM).astype(np.float32)
    mt = (rng.randn(B, T, hp.attention_dimension) * 0.5).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, T - 4, 5])[:, None]
    shifted = rng.randn(B, FRAMES, hp.num_mels).astype(np.float32)
    teacher = (rng.uniform(size=FRAMES) < ratio).astype(np.int32)
    teacher[:2] = (1, 0)
    key = jax.random.PRNGKey(seed + 7)
    seeds = tuple(int(s) for s in np.asarray(
        jax.random.bits(key, (2,), jnp.uint32)))
    return memory, mt, mask, shifted, teacher, key, seeds


def _port_cfg(hp, train=True):
    return ftd.TrainConfig.from_hp(port_hp(hp), MEM, torch.float32,
                                   train=train)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("attention_type", KINDS)
def test_train_forward_matches_interpret_kernel(attention_type, train):
    """Plain K2 (through ``decode``) against the JAX train kernel in
    interpret mode, train and eval variants, at prenet dropout 0.5 and
    zoneout 0.1: spec, stop and the alignments within atol 5e-6 (the JAX
    package's own bound for its family's train forward).  The alignments
    are floored distributions over the bucket."""
    hp = _train_hp(attention_type)
    params = _cell_params(hp)
    memory, mt, mask, shifted, teacher, key, seeds = _train_inputs(hp)
    decode = ptd.make_train_decode_fn(hp, dtype=jnp.float32, interpret=True,
                                      fwd_chunk=3, bwd_chunk=2, train=train)
    ref = decode(jax.tree_util.tree_map(jnp.asarray, params),
                 jnp.asarray(memory), jnp.asarray(mt), jnp.asarray(mask),
                 jnp.asarray(shifted), jnp.asarray(teacher), key)
    cell = _port_cell(hp, params)
    cfg = _port_cfg(hp, train)
    assert cfg.att_kind == ("fwd" if attention_type == "forward"
                            else "fwd_trans")
    with torch.no_grad():
        got = ftd.decode(cell, cfg, *(torch.as_tensor(x) for x in (
            memory, mt, mask, shifted)), teacher.tolist(), seeds)
    for g, r, name in zip(got, ref, ("spec", "stop", "alignment")):
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=5e-6,
                                   err_msg=name)
    w = to_np(got[2])
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-5)
    assert w[2, :, 5:].min() > 0.0     # the floor at masked positions


def _cotangents(hp, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, FRAMES, hp.num_mels).astype(np.float32),
            rng.randn(B, FRAMES).astype(np.float32),
            rng.randn(B, FRAMES, T).astype(np.float32))


def _flat_grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat_grads(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("attention_type", KINDS)
def test_train_backward_matches_jax_vjp(attention_type):
    """Plain K3 through ``TrainDecode`` against the JAX custom VJP (the
    interpret-mode K3: the replayed softmax and recurrence, the renorm,
    floor and shift backward, the transition agent's backward and its
    weight gradients outside the kernel): every parameter gradient, the
    agent's included, and the memory and memory-transform gradients
    within 1e-4 of that tensor's largest value."""
    hp = _train_hp(attention_type)
    params = _cell_params(hp)
    memory, mt, mask, shifted, teacher, key, seeds = _train_inputs(hp)
    cts = _cotangents(hp)
    decode = ptd.make_train_decode_fn(hp, dtype=jnp.float32, interpret=True,
                                      fwd_chunk=3, bwd_chunk=2)

    def f(cp, mem, mtr):
        return decode(cp, mem, mtr, jnp.asarray(mask), jnp.asarray(shifted),
                      jnp.asarray(teacher), key)

    _, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(memory), jnp.asarray(mt))
    g_cell, g_mem, g_mt = vjp(tuple(jnp.asarray(c) for c in cts))
    ref = _flat_grads(g_cell)
    ref["memory"], ref["memory_transform"] = np.asarray(g_mem), np.asarray(g_mt)

    cell = _port_cell(hp, params)
    mem_t = torch.as_tensor(memory).requires_grad_()
    mt_t = torch.as_tensor(mt).requires_grad_()
    out = ftd.decode(cell, _port_cfg(hp), mem_t, mt_t, torch.as_tensor(mask),
                     torch.as_tensor(shifted), teacher.tolist(), seeds)
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(out, cts))
    names = [n for n, _ in cell.named_parameters()]
    grads = torch.autograd.grad(loss, list(cell.parameters()) + [mem_t, mt_t])
    got = {}
    for name, g in zip(names, grads[:-2]):
        path, leaf = "/".join(name.split(".")[:-1]), name.split(".")[-1]
        got[f"{path}/kernel" if leaf == "weight" else f"{path}/{leaf}"] = (
            to_np(g).T if leaf == "weight" else to_np(g))
    got["memory"], got["memory_transform"] = to_np(grads[-2]), to_np(grads[-1])
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    if attention_type != "forward":
        assert np.abs(ref["attention/transition_agent/kernel"]).max() > 0
    for name, r in ref.items():
        scale = np.abs(r).max() + 1e-6
        err = np.abs(got[name].reshape(r.shape) - r).max() / scale
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("attention_type", KINDS)
def test_plain_backward_matches_autograd(attention_type):
    """Plain K3 (``TrainDecode.backward``, the agent's backward and weight
    gradients included) against ``torch.autograd.grad`` through the plain
    K2 in differentiable ops: every operand, memory and memory-transform
    gradient within 1e-4 of its largest value."""
    hp = _train_hp(attention_type)
    cfg = _port_cfg(hp)
    cell = _port_cell(hp, _cell_params(hp))
    ops = {k: v.detach().clone().requires_grad_()
           for k, v in ftd.train_operands(cell, cfg).items()}
    keys = ftd.operand_keys(cfg)
    assert "lc" not in keys and (("ta_w" in keys) == (cfg.att_kind
                                                     == "fwd_trans"))
    memory, mt, mask, shifted, teacher, _, seeds = _train_inputs(hp)
    mem = torch.as_tensor(memory).requires_grad_()
    mtb = torch.as_tensor(mt).requires_grad_()
    mask_add = torch.where(torch.as_tensor(mask), 0.0, -1e9)
    sh = torch.as_tensor(shifted).transpose(0, 1).contiguous()
    cts = [torch.as_tensor(c) for c in _cotangents(hp)]
    cts = [cts[0].transpose(0, 1), cts[1].t(), cts[2].transpose(0, 1)]
    inputs = [mem, mtb] + [ops[k] for k in keys]

    def loss_of(outs):
        return sum((o * c).sum() for o, c in zip(outs, cts))

    ref = torch.autograd.grad(loss_of(ftd.train_decode_forward_plain(
        ops, cfg, mem, mtb, mask_add, sh, teacher.tolist(), seeds)), inputs)
    got = torch.autograd.grad(loss_of(ftd.TrainDecode.apply(
        cfg, tuple(teacher.tolist()), seeds, mem, mtb, mask_add, sh,
        *[ops[k] for k in keys])), inputs)
    for name, g, r in zip(["memory", "mtb", *keys], got, ref):
        scale = float(r.abs().max()) + 1e-6
        assert float((g - r).abs().max()) / scale < 1e-4, name


# ---------------------------------------------------------------------------
# the whole model: the training step and the eval forward
# ---------------------------------------------------------------------------

def _model_batch(hp, b=4, t=8, frames=8):
    text, lengths, speakers = batch(hp, b, t, seed=7)
    rng = np.random.RandomState(3)
    target = rng.randn(b, frames, hp.num_mels).astype(np.float32)
    tlen = np.array([frames, frames - 2, frames - 1, 5][:b], np.int32)
    target[np.arange(frames)[None, :] >= tlen[:, None]] = 0.0
    stop = np.zeros((b, frames), np.float32)
    for i, n in enumerate(tlen):
        stop[i, max(n - hp.stop_frames, 0):] = 1.0
    return (text, lengths, speakers, np.arange(b) % hp.language_number,
            target, tlen, stop)


def _port_train_model(hp, v_np):
    from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac
    from multilingual_text_to_speech_tpu_torch.models.layers import (
        ConvBlockGenerated,
    )

    model = ptac.Tacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v_np, hp), strict=True)
    for m in model.modules():          # the JAX side runs with dropout 0
        if isinstance(m, ConvBlockGenerated):
            m.dropout = 0.0
    return model.train()


def test_training_step_matches_jax(monkeypatch):
    """The whole tiny model of the family in training (teacher forcing
    0.5, the fused train decoder in interpret mode on the JAX side, every
    dropout at 0: the JAX package draws the postnet's and the encoder's
    from flax streams, which torch cannot repeat; the decoder-level tests
    above hold the prenet's at 0.5): every loss term within rtol
    1e-5 and every parameter gradient, the attention's and the transition
    agent's included, within 1e-4 of that tensor's largest value, as the
    location-sensitive slice's test.  At the transition agent, whose
    backward covers the plain forward variant's; the decoder-level tests
    above hold both kinds' K2 and K3 against the JAX kernels."""
    from multilingual_text_to_speech_tpu.models import tacotron as jtac
    from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac

    attention_type = "forward_transition_agent"
    hp = tiny_hp(attention_type=attention_type)
    v_np = variables_np(attention_type=attention_type)
    data = _model_batch(hp)
    text, lengths, speakers, languages, target, tlen, stop = data
    key = jax.random.PRNGKey(11)
    monkeypatch.setenv("MTTS_PALLAS_TRAIN_DECODER", "interpret")
    orig = jtac.GeneratedConvolutionalEncoder
    monkeypatch.setattr(jtac, "GeneratedConvolutionalEncoder",
                        lambda *a, **kw: orig(*a, **{**kw, "dropout": 0.0}))
    model = jtac.Tacotron(hp, train=True)
    variables = jax_variables(v_np)

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *(jnp.asarray(x) for x in (text, lengths, target, tlen, speakers,
                                       languages)), 0.5, key,
            mutable=["batch_stats"],
            rngs={"dropout": jax.random.fold_in(key, 1)})
        return jtac.tacotron_loss(
            out, hp=hp, input_lengths=jnp.asarray(lengths),
            target_lengths=jnp.asarray(tlen), pre_target=jnp.asarray(target),
            post_target=jnp.asarray(target), stop_target=jnp.asarray(stop),
            speakers=jnp.asarray(speakers), guided_att_variance=0.3)

    (_, ref_losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    ref_grads = params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})
    rng_tf, rng_steps = jax.random.split(key)
    teacher = np.asarray(jax.random.bernoulli(rng_tf, 0.5, (8,)))
    seeds = tuple(int(s) for s in np.asarray(
        jax.random.bits(rng_steps, (2,), jnp.uint32)))
    assert 0 < teacher.sum() < 8

    port = _port_train_model(hp, v_np)
    t = [torch.as_tensor(x) for x in data]
    out = port(t[0], t[1], t[4], t[5], t[2], t[3],
               teacher.astype(int).tolist(), seeds)
    total, losses = ptac.tacotron_loss(
        out, hp=port.hp, input_lengths=t[1], target_lengths=t[5],
        pre_target=t[4], post_target=t[4], stop_target=t[6],
        speakers=t[2], guided_att_variance=0.3)
    total.backward()
    assert set(losses) == set(ref_losses)
    for k, r in ref_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(r),
                                   rtol=1e-5, err_msg=k)
    params = dict(port.named_parameters())
    assert set(params) == set(ref_grads)
    assert any("energy_net" in n for n in params)
    for name, r in ref_grads.items():
        g = to_np(params[name].grad)
        scale = float(np.abs(to_np(r)).max()) + 1e-6
        assert np.abs(g - to_np(r)).max() / scale < 1e-4, name


@pytest.mark.parametrize("attention_type", KINDS)
def test_train_step_moves_every_parameter(attention_type):
    """``trainer.train_step`` of the family on the CPU: finite losses, and
    every parameter, the energy net's and the transition agent's included,
    moves."""
    from multilingual_text_to_speech_tpu_torch.models import tacotron as ptac
    from multilingual_text_to_speech_tpu_torch.training import trainer

    hp = tiny_hp(attention_type=attention_type)
    text, lengths, speakers, languages, target, tlen, stop = _model_batch(hp)
    php = port_hp(hp)
    step_model = ptac.init_random_weights(ptac.Tacotron(php), 3)
    before = {k: v.detach().clone() for k, v in step_model.named_parameters()}
    opt, sched = trainer.make_optimizer(step_model, php)
    res = trainer.train_step(
        step_model, opt, sched,
        trainer.Batch(text, lengths, target, None, tlen, stop, speakers,
                      languages),
        ptac.TacotronLossState.init(php), torch.Generator().manual_seed(5),
        device="cpu")
    assert all(np.isfinite(float(v)) for v in res.losses.values())
    for name, p in step_model.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name


@pytest.mark.parametrize("attention_type", KINDS)
def test_eval_forward_matches_jax(attention_type):
    """``model.eval()``'s teacher-forced forward of the family (K2's eval
    variant) against ``Tacotron(train=False)`` on the JAX package's XLA
    path at prenet dropout 0: predictions, stop logits and alignments
    within atol 1e-5, as the location-sensitive slice's test."""
    from multilingual_text_to_speech_tpu.models import tacotron as jtac

    hp = tiny_hp(attention_type=attention_type)
    v_np = variables_np(attention_type=attention_type)
    data = _model_batch(hp)
    text, lengths, speakers, languages, target, tlen, _ = data
    key = jax.random.PRNGKey(13)
    ref = jtac.Tacotron(hp, train=False).apply(
        jax_variables(v_np), *(jnp.asarray(x) for x in (
            text, lengths, target, tlen, speakers, languages)), 0.5, key)
    teacher = np.asarray(jax.random.bernoulli(jax.random.split(key)[0], 0.5,
                                              (8,)))
    port = _port_train_model(hp, v_np).eval()
    out = port(*(torch.as_tensor(x) for x in (text, lengths, target, tlen,
                                              speakers, languages)),
               teacher.astype(int).tolist(), (5, 6))
    for k in ("pre_prediction", "post_prediction", "stop_token",
              "alignment"):
        np.testing.assert_allclose(to_np(out[k]), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    assert out["alignment"].grad_fn is None
