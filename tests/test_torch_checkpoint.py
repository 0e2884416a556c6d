"""The port's checkpoint files against the JAX package's, on the CPU.

The codec (``interop/msgpack_codec.py``, no msgpack or flax) against
``msgpack`` + ``flax.serialization``; ``params_to_jax`` as the exact
inverse of ``params_from_jax`` for every encoder type; checkpoints written
by either package restored by the other, their spectrograms within the
bounds of ``tests/test_torch_synthesis.py`` (rtol 1e-3, atol 1e-4); the
hyper-parameter and criterion sections, ``partial=`` and
``find_latest_checkpoint``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from multilingual_text_to_speech_tpu.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu.training import checkpoint as jax_ckpt
from multilingual_text_to_speech_tpu_torch.interop import (
    msgpack_codec,
    params_from_jax,
    params_to_jax,
)
from multilingual_text_to_speech_tpu_torch.models.tacotron import (
    Tacotron as PortTacotron,
)
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from multilingual_text_to_speech_tpu_torch.training import checkpoint
from tests.test_torch_synthesis import _inputs
from tests.torch_port_utils import (
    _randomize,
    jax_variables,
    port_hp,
    tiny_hp,
    variables_np,
)

ENCODERS = ("generated", "simple", "shared", "separate", "convolutional")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _bits(x):
    """A leaf as comparable numpy: bfloat16 as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    if isinstance(x, np.ndarray) and x.dtype == jnp.bfloat16:
        return x.view(np.uint16)
    return x


def _assert_same_tree(got, ref):
    g, r = list(_leaves(got)), list(_leaves(ref))
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        a, b = _bits(a), _bits(b)
        assert type(a) is type(b), (path, type(a), type(b))
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        elif isinstance(a, float) and np.isnan(a):
            assert np.isnan(b), path
        else:
            assert a == b, path


def _sample_tree():
    """Every kind of leaf a checkpoint holds, at every length header."""
    rng = np.random.RandomState(0)
    return {
        "arrays": {
            "f32": rng.randn(3, 5).astype(np.float32),
            "f64": rng.randn(7).astype(np.float64),
            "i8": rng.randint(-128, 127, (2, 2, 2)).astype(np.int8),
            "i64": rng.randint(-2 ** 40, 2 ** 40, 4).astype(np.int64),
            "u16": rng.randint(0, 2 ** 16, 9).astype(np.uint16),
            "bool": rng.rand(6) > 0.5,
            "empty": np.zeros((0, 4), np.float32),
            "scalar0d": np.float32(2.5) * np.ones((), np.float32),
            "ext16": rng.randn(40000).astype(np.float32),     # ext 32
            "ext8": rng.randn(20).astype(np.float32),
            "fix16": np.arange(2, dtype=np.float64),          # 16+ bytes
            "bf16": np.asarray(jnp.asarray(rng.randn(4, 3), jnp.bfloat16)),
        },
        "scalars": {"i64": np.int64(-7), "f64": np.float64(0.125),
                    "f32": np.float32(3.0), "bool": np.bool_(True),
                    "u8": np.uint8(200)},
        "python": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                   2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768,
                   -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0,
                   float("inf"), True, False, None],
        "strings": {"short": "ja", "utf8": "héllo ünïcödé 中文",
                    "s8": "x" * 200, "s16": "y" * 300, "s32": "z" * 70000,
                    "empty": ""},
        "bin": {"b8": b"\x00\x01" * 10, "b16": b"q" * 300,
                "b32": b"r" * 70000, "empty": b""},
        "maps": {"m16": {f"k{i:02d}": i for i in range(20)}, "empty": {},
                 "nested": {"a": {"b": {"c": [1, [2, {"d": 3}]]}}}},
        "list16": list(range(20)),
    }


def test_codec_reads_flax_bytes():
    """Bytes from ``flax.serialization.msgpack_serialize`` decode leaf for
    leaf as ``flax.serialization.msgpack_restore`` decodes them (bfloat16
    as torch.bfloat16 tensors of the same bits, arrays writable)."""
    tree = _sample_tree()
    blob = serialization.msgpack_serialize(tree)
    got = msgpack_codec.unpack(blob)
    _assert_same_tree(got, serialization.msgpack_restore(blob))
    assert isinstance(got["arrays"]["bf16"], torch.Tensor)
    assert got["arrays"]["f32"].flags.writeable


def test_codec_writes_flax_bytes():
    """Port-written bytes restore in flax equal to the tree written, and
    decode back in the port to what they came from; keys sorted."""
    tree = msgpack_codec.unpack(serialization.msgpack_serialize(
        _sample_tree()))
    blob = msgpack_codec.pack(tree)
    restored = serialization.msgpack_restore(blob)
    _assert_same_tree(msgpack_codec.unpack(serialization.msgpack_serialize(
        restored)), tree)
    _assert_same_tree(msgpack_codec.unpack(blob), tree)
    raw = msgpack.unpackb(blob, strict_map_key=False,
                          ext_hook=lambda c, d: (c, len(d)))
    assert list(raw) == sorted(raw)
    assert list(raw["maps"]["m16"]) == sorted(raw["maps"]["m16"])


@pytest.mark.parametrize("direction", ["flax_to_port", "port_to_flax"])
def test_codec_chunked_arrays(monkeypatch, direction):
    """flax's chunked layout of arrays above MAX_CHUNK_SIZE bytes (made
    small here in both packages), at the top and nested."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(5, 7).astype(np.float32),
            "deep": {"big64": rng.randn(33).astype(np.float64),
                     "small": np.arange(3, dtype=np.float32)},
            "bf": np.asarray(jnp.asarray(rng.randn(50), jnp.bfloat16))}
    if direction == "flax_to_port":
        blob = serialization.msgpack_serialize(dict(tree))
        raw = msgpack.unpackb(blob, ext_hook=lambda c, d: d)
        assert msgpack_codec.CHUNK_KEY in raw["big"]
        _assert_same_tree(msgpack_codec.unpack(blob),
                          serialization.msgpack_restore(blob))
    else:
        port_tree = msgpack_codec.unpack(serialization.msgpack_serialize(
            dict(tree)))
        blob = msgpack_codec.pack(port_tree)
        raw = msgpack.unpackb(blob, ext_hook=lambda c, d: d)
        assert msgpack_codec.CHUNK_KEY in raw["deep"]["big64"]
        assert len(raw["big"]["chunks"]) == 3         # 140 bytes, 16 a chunk
        restored = serialization.msgpack_restore(blob)
        for path, a in _leaves(tree):
            b = restored
            for k in path:
                b = b[k]
            np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("blob", [
    serialization.msgpack_serialize({"c": 1 + 2j}),
    msgpack.packb({"x": msgpack.ExtType(7, b"abc")}),
    b"\xc1",
    msgpack.packb([1, 2, 3])[:-1],
], ids=["complex_ext2", "unknown_ext", "reserved_byte", "truncated"])
def test_codec_refuses_what_it_does_not_read(blob):
    with pytest.raises(msgpack_codec.MsgpackError):
        msgpack_codec.unpack(blob)


def test_codec_refuses_to_write_complex():
    with pytest.raises(msgpack_codec.MsgpackError):
        msgpack_codec.pack({"c": 1 + 2j})


@functools.lru_cache(maxsize=None)
def _init_variables(encoder, classifier):
    """The JAX ``Tacotron.init`` tree of ``tiny_hp`` at ``encoder``, numpy,
    with random weights and batch statistics."""
    hp = tiny_hp(encoder_type=encoder, reversal_classifier=classifier)
    model = Tacotron(hp, train=False)
    b, t = 2, 8
    key = jax.random.PRNGKey(0)
    v = jax.jit(model.init)(
        key, jnp.ones((b, t), jnp.int32), jnp.full((b,), t),
        jnp.zeros((b, 8, hp.num_mels)), jnp.full((b,), 8),
        jnp.zeros((b,), jnp.int32), jnp.arange(b) % 2, 0.0, key)
    rng = np.random.RandomState(7)
    return hp, {col: _randomize(jax.tree_util.tree_map(np.asarray, v[col]),
                                rng, col)
                for col in ("params", "batch_stats")}


@pytest.mark.parametrize("classifier", [False, True])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_params_to_jax_inverts_params_from_jax(encoder, classifier):
    """``params_to_jax(params_from_jax(v))`` is ``v`` bit for bit: the same
    key set (what flax's ``from_state_dict`` requires), shapes, dtypes and
    values, every encoder type with and without the classifier."""
    hp, v = _init_variables(encoder, classifier)
    back = params_to_jax(params_from_jax(v, hp), port_hp(hp))
    _assert_same_tree(back, v)


def test_params_to_jax_folds_both_lstm_biases():
    """A torch-trained ``nn.LSTM`` has a nonzero ``bias_hh``: flax's one
    bias a gate is ``bias_ih + bias_hh``, and the model restored from the
    tree computes what the trained one does."""
    hp, v = _init_variables("simple", False)
    model = PortTacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v, hp))
    sd = model.state_dict()
    rng = np.random.RandomState(3)
    for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
        key = f"encoder.bilstm.{name}"
        sd[key] = torch.from_numpy(rng.randn(*sd[key].shape).astype(
            np.float32))
    tree = params_to_jax(sd, port_hp(hp))
    cell = tree["params"]["encoder"]["OptimizedLSTMCell_1"]
    h = sd["encoder.bilstm.weight_hh_l0"].shape[1]
    folded = (sd["encoder.bilstm.bias_ih_l0_reverse"]
              + sd["encoder.bilstm.bias_hh_l0_reverse"]).numpy()
    np.testing.assert_array_equal(cell["hf"]["bias"], folded[h:2 * h])

    trained = PortTacotron(port_hp(hp), torch.float32)
    trained.load_state_dict(sd)
    restored = PortTacotron(port_hp(hp), torch.float32)
    restored.load_state_dict(params_from_jax(tree))
    text = torch.randint(3, hp.total_symbols(), (2, 9))
    lengths = torch.tensor([9, 6])
    with torch.no_grad():
        a = trained.eval().encoder(trained.embedding(text), lengths)
        b = restored.eval().encoder(restored.embedding(text), lengths)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _hp():
    return tiny_hp(max_output_length=32, decode_chunk_frames=8)


def _jax_checkpoint(path, hp, v_np, opt_state=None):
    jax_ckpt.save_checkpoint(
        path, epoch=3, step=1234, params=jax_variables(v_np["params"]),
        batch_stats=jax_variables(v_np["batch_stats"]),
        opt_state=opt_state if opt_state is not None else {}, hp=hp,
        criterion_state={"guided_att_weight": 0.25, "step": 9.0})


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX ``save_checkpoint`` file through the port's
    ``Synthesizer.from_checkpoint(device="cpu")``: the JAX package's
    weights exactly, and spectrograms within rtol 1e-3, atol 1e-4 of the
    JAX ``Synthesizer.from_checkpoint`` on the same file."""
    hp, v_np = _hp(), variables_np(-10.0)
    path = str(tmp_path / "jax.ckpt")
    _jax_checkpoint(path, hp, v_np)
    port_syn = PortSynthesizer.from_checkpoint(path, device="cpu")
    assert port_syn.device == torch.device("cpu")
    ref_sd = params_from_jax(v_np, hp)
    got_sd = port_syn.model.state_dict()
    assert set(got_sd) == set(ref_sd)
    for k, t in ref_sd.items():
        torch.testing.assert_close(got_sd[k], t, rtol=0, atol=0)

    args = _inputs(False)
    ref = Synthesizer.from_checkpoint(path).spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (20, 32)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port-written file through the JAX ``load_checkpoint`` and
    ``Synthesizer.from_checkpoint``: the weights bit for bit, and its
    spectrograms within rtol 1e-3, atol 1e-4 of the port's."""
    hp, v_np = _hp(), variables_np(-10.0)
    path = str(tmp_path / "port.ckpt")
    port_syn = PortSynthesizer(port_hp(hp), params_from_jax(v_np, hp),
                               device="cpu")
    checkpoint.save_checkpoint(
        path, epoch=1, step=2, state_dict=port_syn.model.state_dict(),
        hp=port_syn.hp, criterion_state={"guided_att_weight": 0.5})
    payload = jax_ckpt.load_checkpoint(path)
    _assert_same_tree(payload["model"], v_np)

    args = _inputs(False)
    ref = Synthesizer.from_checkpoint(path).spectrograms_from_batch(*args)
    got = port_syn.spectrograms_from_batch(*args)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (20, 32)
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)


def test_sections_round_trip(tmp_path):
    """epoch, step, the hyper-parameters and the criterion state through a
    port-written file, read by the port and by the JAX package; a JAX
    optimizer section (optax Adam) read and written back untouched."""
    import optax

    hp, v_np = _hp(), variables_np(-10.0)
    opt_state = optax.adam(1e-3).init(jax_variables(v_np["params"]))
    jax_path = str(tmp_path / "jax.ckpt")
    _jax_checkpoint(jax_path, hp, v_np, opt_state)
    payload = checkpoint.load_checkpoint(jax_path)
    assert payload["epoch"] == 3 and payload["step"] == 1234
    assert isinstance(payload["step"], np.int64)
    assert payload["hp"].state_dict() == port_hp(hp).state_dict()
    assert payload["criterion"] == {"guided_att_weight": 0.25, "step": 9.0}
    assert isinstance(payload["criterion"]["guided_att_weight"], np.float64)

    port_path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(
        port_path, epoch=int(payload["epoch"]), step=int(payload["step"]),
        state_dict=params_from_jax(payload["model"]), hp=payload["hp"],
        criterion_state=payload["criterion"],
        optimizer=payload["optimizer"])
    assert not os.path.exists(port_path + ".tmp")
    ours, theirs = (checkpoint.load_checkpoint(port_path),
                    jax_ckpt.load_checkpoint(port_path))
    reference = jax_ckpt.load_checkpoint(jax_path)
    for got in (ours, theirs):
        assert got["epoch"] == 3 and got["step"] == 1234
        assert got["criterion"] == reference["criterion"]
        assert json.loads(got["parameters"]) == hp.state_dict()
    assert theirs["hp"].state_dict() == hp.state_dict()
    _assert_same_tree(theirs["optimizer"], reference["optimizer"])
    _assert_same_tree(theirs["model"], reference["model"])
    restored = jax_ckpt.restore_into(theirs, opt_state=opt_state)
    assert jax.tree_util.tree_structure(restored["opt_state"]) == (
        jax.tree_util.tree_structure(opt_state))


def test_partial_restore_keeps_mismatched_weights(tmp_path):
    """``partial=True`` takes every weight whose path and shape match and
    keeps the model's own elsewhere (here a speaker table of another
    size); without it the mismatch raises."""
    hp, v_np = _hp(), variables_np(-10.0)
    path = str(tmp_path / "jax.ckpt")
    _jax_checkpoint(path, hp, v_np)
    payload = checkpoint.load_checkpoint(path)

    other = port_hp(_hp())
    other.speaker_number = 6
    other.unique_speakers = [f"s{i}" for i in range(6)]
    model = PortTacotron(other, torch.float32)
    own = {k: t.clone() for k, t in model.state_dict().items()}
    with pytest.raises(RuntimeError):
        checkpoint.restore(payload, PortTacotron(other, torch.float32),
                           other)
    checkpoint.restore(payload, model, other, partial=True)
    loaded = params_from_jax(v_np, hp)
    got = model.state_dict()
    changed = {k for k in got if not torch.equal(got[k], own[k])}
    speaker = "decoder.speaker_embedding.weight"
    assert speaker not in changed
    torch.testing.assert_close(got[speaker], own[speaker], rtol=0, atol=0)
    for k, t in loaded.items():
        if k != speaker and k in got and got[k].shape == t.shape:
            torch.testing.assert_close(got[k], t, rtol=0, atol=0)

    same = PortTacotron(port_hp(hp), torch.float32)
    checkpoint.restore(payload, same, port_hp(hp))
    for k, t in loaded.items():
        torch.testing.assert_close(same.state_dict()[k], t, rtol=0, atol=0)


def test_find_latest_checkpoint(tmp_path):
    """The newest checkpoint file of a directory, skipping a stray newer
    file, a newer ``.tmp`` and a subdirectory; port-written files pass the
    JAX probe, which finds the same file."""
    hp, v_np = _hp(), variables_np(-10.0)
    assert checkpoint.find_latest_checkpoint(str(tmp_path / "none")) is None
    assert checkpoint.find_latest_checkpoint(str(tmp_path)) is None
    sd = params_from_jax(v_np, hp)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"ckpt_{i}")
        checkpoint.save_checkpoint(p, epoch=i, step=i, state_dict=sd,
                                   hp=port_hp(hp), criterion_state={})
        os.utime(p, (100 + i, 100 + i))
        paths.append(p)
    with open(tmp_path / "stray.log", "w") as f:
        f.write("epoch 3 loss 0.1\n")
    os.utime(tmp_path / "stray.log", (200, 200))
    with open(tmp_path / "ckpt_2.tmp", "wb") as f:
        f.write(open(paths[0], "rb").read())
    os.utime(tmp_path / "ckpt_2.tmp", (300, 300))
    os.mkdir(tmp_path / "sub")
    assert checkpoint.find_latest_checkpoint(str(tmp_path)) == paths[1]
    assert jax_ckpt.find_latest_checkpoint(str(tmp_path)) == paths[1]
    assert all(jax_ckpt._is_checkpoint_file(p) for p in paths)
    assert not checkpoint._is_checkpoint_file(str(tmp_path / "stray.log"))
    assert not checkpoint._is_checkpoint_file(str(tmp_path / "sub"))
    with open(paths[1], "rb") as f:
        assert b"criterion" in f.read(64)
