"""The adversarial speaker classifiers: behind gradient reversal, and the
cosine-similarity one behind gradient clipping.

Port of the JAX package's ``models/classifier.py``: ``GradientReversal``,
``ReversalClassifier``, ``reversal_classifier_loss``, ``GradientClipping``,
``CosineSimilarityClassifier`` and ``cosine_similarity_classifier_loss``.
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
                             prediction: torch.Tensor,
                             count=None) -> torch.Tensor:
    """Per-character speaker cross-entropy over the valid characters:
    ``prediction`` [B, T, n_speakers] logits.  ``count``, the valid
    characters of the global batch, makes it this shard's contribution:
    its masked sum over that count."""
    b, t, _ = prediction.shape
    mask = (torch.arange(t, device=prediction.device)[None, :]
            < input_lengths[:, None])
    logp = torch.log_softmax(prediction, dim=-1)
    nll = -torch.gather(logp, 2, speakers.long()[:, None, None].expand(
        b, t, 1))[..., 0]
    count = mask.sum() if count is None else count
    return (torch.where(mask, nll, torch.zeros_like(nll)).sum()
            / torch.clamp(count, min=1))


class GradientClipping(torch.autograd.Function):
    """Identity forward; backward ``clamp(g, -clip, clip)``."""

    @staticmethod
    def forward(ctx, x, clip: float):
        ctx.clip = clip
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -ctx.clip, ctx.clip), None


class CosineSimilarityClassifier(nn.Module):
    """One dense layer (``fc``) behind gradient clipping; the product runs
    in the compute type, the logits come out in float32."""

    def __init__(self, input_dim: int, output_dim: int,
                 gradient_clipping_bounds: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.clip = gradient_clipping_bounds
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = GradientClipping.apply(x, self.clip).to(self.dtype)
        return F.linear(x, self.fc.weight.to(self.dtype),
                        self.fc.bias.to(self.dtype)).float()


def cosine_similarity_classifier_loss(input_lengths: torch.Tensor,
                                      speakers: torch.Tensor,
                                      prediction: torch.Tensor,
                                      embeddings: torch.Tensor,
                                      classifier_kernel: torch.Tensor,
                                      count=None, positions=None
                                      ) -> torch.Tensor:
    """``reversal_classifier_loss`` plus the mean over all B x T positions,
    padding included, of ``sum_s |cos(embeddings[b, t], kernel[:, s])|``
    with the norms' product clamped at 1e-8: ``embeddings`` [B, T, C] the
    encoder outputs, ``classifier_kernel`` [C, n_speakers] (the
    classifier's ``fc.weight`` transposed, flax's layout).  An all-zero
    embedding row has no cosine term and no gradient: the JAX package's
    norm gives a NaN gradient there, PyTorch's norm a zero one.  With the
    global batch's valid characters ``count`` and B x T ``positions``, it
    is this shard's contribution: both sums over the global counts."""
    loss = reversal_classifier_loss(input_lengths, speakers, prediction,
                                    count)
    dot = torch.einsum("btc,cs->bts", embeddings, classifier_kernel)
    norm_e = torch.linalg.vector_norm(embeddings, dim=2, keepdim=True)
    norm_w = torch.linalg.vector_norm(classifier_kernel, dim=0)[None, None]
    cosine = torch.abs(dot / torch.clamp(norm_e * norm_w, min=1e-8))
    if positions is None:
        return loss + cosine.sum(dim=2).mean()
    return loss + cosine.sum() / positions
