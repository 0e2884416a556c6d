"""Weight conversion between the JAX package's layout and the port's."""

from multilingual_text_to_speech_tpu_torch.interop.from_jax import (
    params_from_jax,
    params_to_jax,
)

__all__ = ["params_from_jax", "params_to_jax"]
