"""The port's reference-checkpoint importer and its CLI against the JAX
package's, on the CPU.

Reference-layout checkpoints are made here (``tests/torch_reference_layout``
inverts ``port_state_dict`` on a seeded tree: all five encoders, with the
reversal classifier, and either postnet), since the reference checkout is
not on this machine.  The port's ``import_reference_checkpoint`` gives the
JAX package's tree, hyper-parameters, criterion and epoch bit for bit, and
the seeded tree back; both CLIs write checkpoints that load in both
packages to the same weights; and the port's ``Synthesizer.from_checkpoint``
on the port's file synthesizes what the JAX synthesizer does on the JAX
package's (rtol 1e-3, atol 1e-4, ``tests/test_torch_synthesis.py``'s
bounds).
"""

import functools
import json

import flax.linen as nn
import jax
import numpy as np
import pytest

from multilingual_text_to_speech_tpu.cli import (
    import_reference_checkpoint as jax_cli,
)
from multilingual_text_to_speech_tpu.interop import (
    torch_port as jax_import,
)
from multilingual_text_to_speech_tpu.models import tacotron as jtac
from multilingual_text_to_speech_tpu.synthesis import Synthesizer
from multilingual_text_to_speech_tpu.training import checkpoint as jax_ckpt
from multilingual_text_to_speech_tpu_torch.cli import (
    import_reference_checkpoint as port_cli,
)
from multilingual_text_to_speech_tpu_torch.interop import (
    params_to_jax,
    reference_import,
)
from multilingual_text_to_speech_tpu_torch.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu_torch.synthesis import (
    Synthesizer as PortSynthesizer,
)
from multilingual_text_to_speech_tpu_torch.training import checkpoint
from tests.test_torch_cbhg import cbhg_hp
from tests.torch_port_utils import _randomize, port_hp, tiny_hp
from tests.torch_reference_layout import save_reference_checkpoint

ENCODERS = ("generated", "simple", "shared", "separate", "convolutional")


def _hp(encoder, postnet, **over):
    make = cbhg_hp if postnet == "cbhg" else tiny_hp
    return make(encoder_type=encoder, reversal_classifier=True,
                max_output_length=32, decode_chunk_frames=8, **over)


@functools.lru_cache(maxsize=None)
def _variables(encoder, postnet):
    """Seeded weights at 0.3 in the flax layout (paths and shapes from
    ``params_to_jax`` of a port model, as ``tests/test_torch_cbhg.py``
    holds them to the flax init's)."""
    hp = _hp(encoder, postnet)
    tree = params_to_jax(Tacotron(port_hp(hp)).state_dict(), hp)
    rng = np.random.RandomState(ENCODERS.index(encoder))
    return {col: _randomize(tree[col], rng, col)
            for col in ("params", "batch_stats")}


def _traced_init(self, *args, **kwargs):
    """``Tacotron.init``'s tree, traced and not run: zeros of its shapes."""
    shapes = jax.eval_shape(functools.partial(nn.Module.init, self), *args,
                            **kwargs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.fixture
def traced_jax_init(monkeypatch):
    """The JAX importer's strict merge template from the flax init's
    traced shapes: its values are all overwritten, and running the init
    only costs time."""
    monkeypatch.setattr(jtac.Tacotron, "init", _traced_init)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_same_tree(got, ref):
    g, r = list(_leaves(got)), list(_leaves(ref))
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("postnet", ["conv", "cbhg"])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_importer_matches_jax(encoder, postnet, tmp_path, traced_jax_init):
    """The port's tree equals the JAX importer's and the seeded tree bit
    for bit; the hyper-parameters, the criterion and the epoch equal."""
    hp, v = _hp(encoder, postnet), _variables(encoder, postnet)
    path = str(tmp_path / "reference.pt")
    save_reference_checkpoint(path, v, hp)
    ref_hp, ref_v, ref_crit, ref_meta = jax_import.import_reference_checkpoint(
        path)
    got_hp, got_v, got_crit, got_meta = (
        reference_import.import_reference_checkpoint(path))
    _assert_same_tree(got_v, ref_v)
    _assert_same_tree(got_v, v)
    assert got_hp.state_dict() == ref_hp.state_dict()
    assert got_crit == ref_crit == {"guided_att_variance": 0.35,
                                    "guided_att_steps": 17,
                                    "guided_att_gamma": hp.guided_attention_gain}
    assert got_meta == ref_meta == {"epoch": 7}


def test_importer_refuses_what_is_not_a_checkpoint(tmp_path):
    import torch

    path = str(tmp_path / "bare.pt")
    torch.save({"model": {}}, path)
    with pytest.raises(ValueError, match="parameters"):
        reference_import.import_reference_checkpoint(path)
    hp, v = _hp("generated", "conv"), _variables("generated", "conv")
    save_reference_checkpoint(path, v, hp)
    state = torch.load(path, weights_only=False)
    del state["model"]["module._postnet._convs.1._block.1.weight"]
    torch.save(state, path)
    with pytest.raises(KeyError):
        reference_import.import_reference_checkpoint(path)


def _load_both(path):
    payload = checkpoint.load_checkpoint(path)
    jax_payload = jax_ckpt.load_checkpoint(path)
    return payload, jax_payload


@pytest.mark.parametrize("encoder,postnet", [("generated", "cbhg"),
                                             ("simple", "conv")])
def test_clis_write_checkpoints_both_packages_load(encoder, postnet,
                                                   tmp_path,
                                                   traced_jax_init):
    """Both CLIs, with a hyper-parameter overlay: each file loads in both
    packages to the seeded weights bit for bit, with the overlaid
    hyper-parameters, the criterion and the epoch."""
    hp, v = _hp(encoder, postnet), _variables(encoder, postnet)
    src = str(tmp_path / "reference.pt")
    save_reference_checkpoint(src, v, hp)
    overlay = tmp_path / "overlay.json"
    overlay.write_text(json.dumps({"griffin_lim_iters": 7}))
    outs = {"port": str(tmp_path / "out" / "port.ckpt"),
            "jax": str(tmp_path / "jax.ckpt")}
    assert port_cli.main([src, "-o", outs["port"], "--hyper_parameters",
                          str(overlay)]) == 0
    assert jax_cli.main([src, "-o", outs["jax"], "--hyper_parameters",
                         str(overlay)]) == 0
    for path in outs.values():
        payload, jax_payload = _load_both(path)
        for p in (payload, jax_payload):
            _assert_same_tree(p["model"], v)
            assert int(p["epoch"]) == 7 and int(p["step"]) == 0
        assert payload["hp"].griffin_lim_iters == 7
        assert jax_payload["hp"].griffin_lim_iters == 7
        assert payload["hp"].state_dict() == jax_payload["hp"].state_dict()
        assert {k: float(x) for k, x in payload["criterion"].items()} == {
            "guided_att_variance": 0.35, "guided_att_steps": 17.0,
            "guided_att_gamma": hp.guided_attention_gain}
    port_cli.main([src])
    assert checkpoint.load_checkpoint(src + ".msgpack")["hp"].encoder_type \
        == encoder


def test_from_checkpoint_synthesizes_as_jax(tmp_path, traced_jax_init):
    """The port's file through ``Synthesizer.from_checkpoint(device="cpu")``
    against the JAX file through the JAX ``Synthesizer.from_checkpoint``:
    a batch of two lines' linear spectrograms from the CBHG model (the
    conv postnet's files are held in ``tests/test_torch_checkpoint.py``)."""
    hp, v = _hp("generated", "cbhg"), _variables("generated", "cbhg")
    src = str(tmp_path / "reference.pt")
    save_reference_checkpoint(src, v, hp)
    port_cli.main([src, "-o", str(tmp_path / "port.ckpt")])
    jax_cli.main([src, "-o", str(tmp_path / "jax.ckpt")])
    lines = ["a|hallo welt|s1|de", "b|bonjour tout le monde|s2|fr"]
    got = PortSynthesizer.from_checkpoint(
        str(tmp_path / "port.ckpt"), device="cpu").synthesize_batch_lines(
            lines, seed=4)
    ref = Synthesizer.from_checkpoint(
        str(tmp_path / "jax.ckpt")).synthesize_batch_lines(lines, seed=4)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[0] == 1102 // 2 + 1
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)
