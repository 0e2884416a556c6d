"""The decoder's attention families: their weights and their state.

Port of the JAX package's ``models/attention.py``.  The parameters keep the
flax paths and layouts: the location-sensitive module its JAX names, the
forward family's ``energy_net`` (``query`` Dense without bias, ``bias``
[1, A], ``energy`` Dense to one unit) and the transition agent's
``transition_agent`` Dense as ``nn.Linear``s.  The steps run in
``ops/fused_decoder.py`` (``lsa_attention``, ``fwd_attention`` and their
plain versions) at inference and in ``ops/fused_train_decoder.py``
(``train_attention``, ``att_bwd``) in training:

- location-sensitive: energy, masked softmax, state ``cum + w``;
- forward (``forward``): the unmasked softmax energy over the bucket, the
  monotonic recurrence ``(prev + shift(prev)) * energy``, then the mask,
  a 1e-6 floor and an L1 renorm; the state is ``w`` itself;
- forward with the transition agent (``forward_transition_agent``):
  ``((1 - tp) * prev + tp * shift(prev)) * energy``, and the next ``tp =
  sigmoid(W [context; h_att; prenet output] + b)``, carried as ``t_prob``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

AttState = Dict[str, torch.Tensor]

NEG_INF = -1e9  # softmax masking (a float32-safe stand-in for -inf)

# hp.attention_type -> the kernels' attention kind
ATT_KINDS = {"location_sensitive": "ls", "forward": "fwd",
             "forward_transition_agent": "fwd_trans"}


def att_kind_of(attention_type: str) -> str:
    if attention_type not in ATT_KINDS:
        raise ValueError(f"unknown attention type: {attention_type!r}")
    return ATT_KINDS[attention_type]


def init_attention_state(attention_type: str, batch_size: int, max_len: int,
                         device=None) -> AttState:
    """The state of the first step: zero cumulative weights
    (location-sensitive), or all mass on token 0 (the forward family) and
    ``t_prob`` [B, 1] at 0.5 (the transition agent)."""
    kind = att_kind_of(attention_type)
    weights = torch.zeros(batch_size, max_len, device=device)
    if kind == "ls":
        return {"weights": weights}
    weights[:, 0] = 1.0
    state = {"weights": weights}
    if kind == "fwd_trans":
        state["t_prob"] = torch.full((batch_size, 1), 0.5, device=device)
    return state


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

    @property
    def energy_bias(self) -> torch.Tensor:
        return self.bias


class ForwardEnergy(nn.Module):
    """``softmax(v . tanh(W_q q + m + b))`` of both forward variants: the
    query Dense [Q -> A] without bias, the bias [1, A] and the energy Dense
    [A -> 1] without bias (flax ``_ForwardEnergy``)."""

    def __init__(self, query_dim: int, representation_dim: int = 128):
        super().__init__()
        self.query = nn.Linear(query_dim, representation_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(1, representation_dim))
        self.energy = nn.Linear(representation_dim, 1, bias=False)


class ForwardAttention(nn.Module):
    """Monotonic forward attention (arXiv:1807.06736): the energy net only."""

    def __init__(self, query_dim: int, representation_dim: int = 128):
        super().__init__()
        self.energy_net = ForwardEnergy(query_dim, representation_dim)

    @property
    def energy_bias(self) -> torch.Tensor:
        return self.energy_net.bias


class ForwardAttentionWithTransition(ForwardAttention):
    """Forward attention with the transition agent, a Dense over
    ``[context | h_att | prenet output]`` (``memory_dim + query_dim +
    prenet_dim`` inputs) to one unit, whose sigmoid gates the recurrence of
    the next step."""

    def __init__(self, query_dim: int, memory_dim: int, prenet_dim: int,
                 representation_dim: int = 128):
        super().__init__(query_dim, representation_dim)
        self.transition_agent = nn.Linear(memory_dim + query_dim + prenet_dim,
                                          1)


def make_attention(hp, memory_dim: int) -> nn.Module:
    """The attention module of ``hp.attention_type``."""
    kind = att_kind_of(hp.attention_type)
    h, a = hp.decoder_dimension, hp.attention_dimension
    if kind == "ls":
        return LocationSensitiveAttention(h, a, hp.attention_kernel_size,
                                          hp.attention_location_dimension)
    if kind == "fwd":
        return ForwardAttention(h, a)
    return ForwardAttentionWithTransition(h, memory_dim, hp.prenet_dimension,
                                          a)
