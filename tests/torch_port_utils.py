"""Shared set-up of the PyTorch-port parity tests: one tiny flagship-topology
model whose numpy-seeded weights go to both the JAX package and the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multilingual_text_to_speech_tpu.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu_torch.config import HParams as PortHParams
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models.tacotron import (
    Tacotron as PortTacotron,
)
from tests.corpus_utils import tiny_model_hp

N_MELS = 20


def tiny_hp(**over):
    """``tests/test_pallas_decoder.py``'s tiny config with the generated
    encoder (the flagship topology at laptop widths), float32 compute and
    prenet dropout 0 (tests that need dropout pass it explicitly)."""
    hp = tiny_model_hp(
        multi_speaker=True, multi_language=True, speaker_number=4,
        language_number=2, languages=["de", "fr"],
        decoder_regularization="zoneout", encoder_type="generated",
        compute_dtype="float32", pallas_decoder_int8=False, dropout=0.0)
    hp.unique_speakers = ["s0", "s1", "s2", "s3"]
    hp.mel_normalize_mean = list(np.linspace(-2.0, 1.0, N_MELS))
    hp.mel_normalize_variance = list(np.linspace(0.5, 1.5, N_MELS))
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


def port_hp(hp):
    """The same hyper-parameters as the port's own ``HParams``."""
    return PortHParams.from_state_dict(hp.state_dict())


def _randomize(tree, rng, kind):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(v, rng, kind)
        elif kind == "params":
            out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _variables_np(stop_bias, classifier=False, prenet_layers=2,
                  attention_type="location_sensitive"):
    """numpy weights (random batch_stats too) for ``tiny_hp`` (with the
    reversal classifier when ``classifier``, ``prenet_layers`` prenet
    layers and ``attention_type``).  Random normal weights at 0.3 stand in
    for a trained net; ``stop_bias`` overrides the stop head's bias when not
    None."""
    hp = tiny_hp(reversal_classifier=classifier, prenet_layers=prenet_layers,
                 attention_type=attention_type)
    model = Tacotron(hp, train=False)
    b, t = 2, 8
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init)(
        key, jnp.ones((b, t), jnp.int32), jnp.full((b,), t),
        jnp.zeros((b, 8, hp.num_mels)), jnp.full((b,), 8),
        jnp.zeros((b,), jnp.int32), jnp.arange(b) % 2, 0.0, key)
    rng = np.random.RandomState(1234)
    out = {col: _randomize(jax.tree_util.tree_map(np.asarray,
                                                  variables[col]), rng, col)
           for col in ("params", "batch_stats")}
    if stop_bias is not None:
        stop = out["params"]["decoder"]["cell"]["stop_prediction"]
        stop["bias"] = np.full_like(stop["bias"], stop_bias)
    return out


def variables_np(stop_bias=None, classifier=False, prenet_layers=2,
                 attention_type="location_sensitive"):
    return _variables_np(stop_bias, classifier, prenet_layers,
                         attention_type)


def jax_variables(v_np):
    return jax.tree_util.tree_map(jnp.asarray, v_np)


def port_model(hp, v_np):
    model = PortTacotron(port_hp(hp), torch.float32)
    model.load_state_dict(params_from_jax(v_np, hp), strict=True)
    return model.eval()


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def batch(hp, b, t, seed=0):
    """Random texts [b, t] (zero beyond each length), lengths and
    speakers."""
    rng = np.random.RandomState(seed)
    lengths = np.clip(rng.randint(t // 2, t + 1, b), 2, t).astype(np.int32)
    lengths[0] = t
    text = rng.randint(3, hp.total_symbols(), (b, t)).astype(np.int32)
    text[np.arange(t)[None, :] >= lengths[:, None]] = 0
    speakers = rng.randint(0, hp.speaker_number, b).astype(np.int32)
    return text, lengths, speakers
