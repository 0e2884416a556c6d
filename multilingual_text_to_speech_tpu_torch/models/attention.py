"""Location-sensitive attention: its weights and its state.

Port of ``LocationSensitiveAttention`` in the JAX package's
``models/attention.py``.  The parameters keep the JAX layouts and names;
the step itself (query product, location conv over the cumulative weights,
energy, masked softmax, context and ``cum += weights``) runs in
``ops/fused_decoder.py`` (``lsa_attention`` and its plain version) at
inference and in ``ops/fused_train_decoder.py`` (``train_attention``,
``att_bwd``) in training.  The forward-attention families are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

AttState = Dict[str, torch.Tensor]

NEG_INF = -1e9  # softmax masking (a float32-safe stand-in for -inf)


def init_attention_state(attention_type: str, batch_size: int, max_len: int,
                         device=None) -> AttState:
    if attention_type != "location_sensitive":
        raise NotImplementedError(
            f"attention type {attention_type!r} is not ported")
    return {"weights": torch.zeros(batch_size, max_len, device=device)}


class LocationSensitiveAttention(nn.Module):
    """``energy = v . tanh(W_q q + W_m m + W_l conv(cum) + b)``: the query
    kernel [Q, A], the location filter [K, 1, C], the location kernel
    [C, A], the bias [1, A] and the energy kernel [A, 1]."""

    def __init__(self, query_dim: int, representation_dim: int = 128,
                 kernel_size: int = 31, location_channels: int = 32):
        super().__init__()
        a = representation_dim
        self.query_kernel = nn.Parameter(torch.randn(query_dim, a)
                                         / query_dim ** 0.5)
        self.loc_filter = nn.Parameter(torch.randn(kernel_size, 1,
                                                   location_channels)
                                       / kernel_size ** 0.5)
        self.location_kernel = nn.Parameter(torch.randn(location_channels, a)
                                            / location_channels ** 0.5)
        self.bias = nn.Parameter(torch.zeros(1, a))
        self.energy_kernel = nn.Parameter(torch.randn(a, 1) / a ** 0.5)
