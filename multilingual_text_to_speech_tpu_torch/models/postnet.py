"""The post-nets: the residual conv stack and the CBHG linear-spectrogram
predictor.

Port of ``Postnet``, ``HighwayLayer`` and ``PostnetCBHG`` in the JAX
package's ``models/postnet.py`` (eval and train mode).  The CBHG's
convolutions, dense layers and bidirectional GRU are PyTorch library calls
(cuDNN and cuBLAS on the card): the JAX package computes them in XLA,
outside any TPU kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from multilingual_text_to_speech_tpu_torch.models.layers import ConvBlock


class Postnet(nn.Module):
    """``num_blocks`` ConvBlocks (tanh except the last) plus a skip; in
    train mode each block uses batch statistics and dropout ``dropout``."""

    def __init__(self, input_dim: int, dimension: int = 512,
                 num_blocks: int = 5, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if num_blocks < 2:
            raise ValueError("the postnet needs at least two blocks")
        for i in range(num_blocks):
            last = i == num_blocks - 1
            self.add_module(f"conv{i}", ConvBlock(
                input_dim if i == 0 else dimension,
                input_dim if last else dimension, kernel_size,
                "identity" if last else "tanh", dtype, dropout))
        self.num_blocks = num_blocks

    def forward(self, x: torch.Tensor,
                x_lengths: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` [B, F, M]; ``x_lengths`` is taken and ignored, as in the
        JAX package."""
        residual = x
        for i in range(self.num_blocks):
            x = getattr(self, f"conv{i}")(x)
        return x + residual


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax's ``Dense(dtype=dtype)``: the product in the compute type."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class HighwayLayer(nn.Module):
    """``relu(linear(x)) * p + x * (1 - p)`` with ``p = sigmoid(gate(x))``,
    the gates in float32."""

    def __init__(self, dimension: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = nn.Linear(dimension, dimension)
        self.gate = nn.Linear(dimension, dimension)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(_dense(self.linear, x, self.dtype).float())
        p = torch.sigmoid(_dense(self.gate, x, self.dtype).float())
        return h * p + x * (1.0 - p)


def _zero_rz_grad(units: int, g: torch.Tensor) -> torch.Tensor:
    """A GRU ``bias_hh`` gradient with its r and z thirds zeroed."""
    return torch.cat([torch.zeros_like(g[:2 * units]), g[2 * units:]])


class PostnetCBHG(nn.Module):
    """Mels [B, F, M] -> linear spectrograms [B, F, output_dim] float32:
    a bank of ConvBlocks with kernels 1..``bank_size`` (ReLU,
    concatenated), a width-2 stride-1 max-pool against a zero frame past
    the end (``max(h[t], h[t+1])``, the last frame against 0, as the JAX
    package pads), two projection ConvBlocks (ReLU, then identity back to
    M channels), the residual, ``pre_highway`` (ReLU), four highway layers,
    a bidirectional GRU of ``gru_dim / 2`` units a direction over each
    sample's length and the ``output`` dense layer.

    The GRU is one ``nn.GRU(bidirectional=True)`` over packed sequences
    (cuDNN on the card), in float32 on inputs rounded to the compute type,
    as the encoder's BiLSTM.  flax's ``GRUCell`` has biases on ``ir``,
    ``iz``, ``in`` and ``hn`` only: ``bias_ih`` holds the first three,
    ``bias_hh``'s last third ``hn``'s, and its r and z thirds stay zero
    (their gradient is masked, so Adam never moves them).  Frames past a
    sample's length come out zero; the JAX package's RNN steps on past
    the length there, and both packages mask or crop those frames."""

    def __init__(self, input_dim: int, output_dim: int, bank_size: int = 8,
                 bank_channels: int = 128, projection_channels: int = 256,
                 projection_kernel_size: int = 3, highway_dim: int = 128,
                 gru_dim: int = 128, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if gru_dim % 2:
            raise ValueError(f"the BiGRU needs an even width, got {gru_dim}")
        self.bank_size = bank_size
        for k in range(1, bank_size + 1):
            self.add_module(f"bank{k}", ConvBlock(
                input_dim, bank_channels, k, "relu", dtype, dropout))
        self.projection1 = ConvBlock(
            bank_size * bank_channels, projection_channels,
            projection_kernel_size, "relu", dtype, dropout)
        self.projection2 = ConvBlock(
            projection_channels, input_dim, projection_kernel_size,
            "identity", dtype, dropout)
        self.pre_highway = nn.Linear(input_dim, highway_dim)
        for i in range(4):
            self.add_module(f"highway{i}", HighwayLayer(highway_dim, dtype))
        half = gru_dim // 2
        self.bigru = nn.GRU(highway_dim, half, batch_first=True,
                            bidirectional=True)
        for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
            getattr(self.bigru, name).register_hook(
                functools.partial(_zero_rz_grad, half))
        self.output = nn.Linear(gru_dim, output_dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor
                ) -> torch.Tensor:
        """``x`` [B, F, M] and each sample's length [B]."""
        frames = x.shape[1]
        residual = x
        h = torch.cat([getattr(self, f"bank{k}")(x)
                       for k in range(1, self.bank_size + 1)], dim=-1)
        h = torch.maximum(h, F.pad(h, (0, 0, 0, 1))[:, 1:])
        h = self.projection2(self.projection1(h))
        h = h + residual
        h = torch.relu(_dense(self.pre_highway, h, self.dtype).float())
        for i in range(4):
            h = getattr(self, f"highway{i}")(h)
        h = h.to(self.dtype).float()
        packed = pack_padded_sequence(
            h, torch.clamp(x_lengths.cpu(), min=1), batch_first=True,
            enforce_sorted=False)
        self.bigru.flatten_parameters()
        h, _ = self.bigru(packed)
        h, _ = pad_packed_sequence(h, batch_first=True, total_length=frames)
        return _dense(self.output, h, self.dtype).float()
