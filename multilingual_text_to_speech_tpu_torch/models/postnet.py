"""The residual conv postnet.  Port of ``Postnet`` in the JAX package's
``models/postnet.py`` (eval and train mode); the CBHG postnet is not
ported."""

from __future__ import annotations

import torch
from torch import nn

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # [B, F, M]
        residual = x
        for i in range(self.num_blocks):
            x = getattr(self, f"conv{i}")(x)
        return x + residual
