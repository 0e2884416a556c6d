"""Fused-gate LSTM cells with zoneout or output dropout.

Port of the JAX package's ``models/rnn.py``.  One ``[x, h] @ W`` product
gives the four gates in the order (i, f, g, o), like ``torch.nn.LSTMCell``.
At inference zoneout is the deterministic ``z*old + (1-z)*new`` and the
dropout cell leaves its output alone.  The modules hold the weights under
the flax paths; the inference step runs in ``ops/fused_decoder.py``
(``gate_lstm`` and its plain version, which use the two functions below),
the training step with its hashed zoneout and dropout masks in
``ops/fused_train_decoder.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def lstm_pointwise(gates: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 gates [B, 4H] and cell [B, H] -> (h_new, c_new)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def zoneout(old: torch.Tensor, new: torch.Tensor, z: float) -> torch.Tensor:
    """Eval-mode zoneout: ``z*old + (1-z)*new``."""
    return new if z == 0.0 else z * old + (1.0 - z) * new


class LSTMCell(nn.Module):
    """The fused gate projection ``gates: [x | h] -> 4H``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.gates = nn.Linear(input_size + hidden_size, 4 * hidden_size)


class RegularizedLSTMCell(nn.Module):
    """The decoder's LSTM (zoneout or the output-dropout cell; both are the
    plain cell's weights under ``cell``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.cell = LSTMCell(input_size, hidden_size)
