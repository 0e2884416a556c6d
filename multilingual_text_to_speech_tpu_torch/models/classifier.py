"""The adversarial speaker classifier behind gradient reversal.

Port of ``GradientReversal``, ``ReversalClassifier`` and
``reversal_classifier_loss`` in the JAX package's ``models/classifier.py``.
The cosine-similarity classifier is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class GradientReversal(torch.autograd.Function):
    """Identity forward; backward ``-scale * clamp(g, -clip, clip)``."""

    @staticmethod
    def forward(ctx, x, scale: float, clip: float):
        ctx.scale, ctx.clip = scale, clip
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * torch.clamp(g, -ctx.clip, ctx.clip), None, None


class ReversalClassifier(nn.Module):
    """Two dense layers (``fc1``, ``fc2``) behind gradient reversal (scale
    1); the products run in the compute type, the logits come out in
    float32."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 gradient_clipping_bounds: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, output_dim)
        self.clip = gradient_clipping_bounds
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = GradientReversal.apply(x, 1.0, self.clip).to(self.dtype)
        for fc in (self.fc1, self.fc2):
            x = F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype))
        return x.float()


def reversal_classifier_loss(input_lengths: torch.Tensor,
                             speakers: torch.Tensor,
                             prediction: torch.Tensor) -> torch.Tensor:
    """Per-character speaker cross-entropy over the valid characters:
    ``prediction`` [B, T, n_speakers] logits."""
    b, t, _ = prediction.shape
    mask = (torch.arange(t, device=prediction.device)[None, :]
            < input_lengths[:, None])
    logp = torch.log_softmax(prediction, dim=-1)
    nll = -torch.gather(logp, 2, speakers.long()[:, None, None].expand(
        b, t, 1))[..., 0]
    return (torch.where(mask, nll, torch.zeros_like(nll)).sum()
            / torch.clamp(mask.sum(), min=1))
