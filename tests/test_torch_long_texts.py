"""Texts longer than the JAX package's fused train decoder takes.

Above 512 symbols the JAX ``Tacotron(train=True)`` leaves its Pallas kernels
for its XLA scan (``models/decoder.py:433-448``,
``ops/pallas_train_decoder.py:79``); the same model trains on such texts.
The port's training path has no such split: on the CPU its plain K2/K3, on
the card its kernels at any T (held to the plain versions by the GPU tests).
Here the port's plain training step at T=600 against the JAX scan's.
"""

from tests.test_torch_training import _check_step_against_jax


def test_training_on_long_texts_matches_jax():
    """600-symbol texts at tiny widths, 8 frames: the JAX package's
    ``Tacotron(train=True)`` takes its XLA scan there, and the port's
    training forward, loss and gradients match it at teacher forcing 0.5
    with zoneout and prenet dropout 0 (the scan draws both from
    ``jax.random``): every loss term within rtol 1e-5, every parameter
    gradient within 1e-4 of that tensor's largest value, the batch-norm
    statistics within atol 1e-5 (the tolerances of the 8-symbol test in
    ``tests/test_torch_training.py``)."""
    _check_step_against_jax(0.5, 600, (("zoneout_hidden", 0.0),
                                       ("zoneout_cell", 0.0)))
