"""The generated (meta-learning) grouped convolutional encoder.

Port of ``GeneratedConvolutionalEncoder`` in the JAX package's
``models/encoder.py``.  Three paths:

- **language-interleaved groups** (training, and eval on a training batch):
  sample ``k*g + j`` has language j, B is a multiple of the g languages,
  and group j runs samples ``j, g + j, 2g + j, ...`` through language j's
  generated encoder (the perfect sampler's contract); in train mode the
  blocks normalize by batch statistics and apply dropout;
- **row groups** (one-hot languages): the caller sorts the batch by language
  and pads each language's run to whole row groups; row group i (samples
  ``[i*B/r, (i+1)*B/r)``) runs only language ``group_langs[i]``'s generated
  encoder;
- **mixing** (accent blends): every sample runs through all g languages'
  encoders and the outputs are mixed per character with the normalized
  language weights.

Activations beyond each sample's length are zeroed after every block, so the
result does not depend on bucket padding.
"""

from __future__ import annotations

import torch
from torch import nn

from multilingual_text_to_speech_tpu_torch.models.layers import (
    ConvBlockGenerated,
    HighwayConvBlockGenerated,
)


def to_grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, ...] language-interleaved -> group-major [g, B/g, ...]: sample
    ``k*g + j`` becomes row ``[j, k]``."""
    return x.reshape(x.shape[0] // groups, groups, *x.shape[1:]).transpose(
        0, 1)


def from_grouped(x4: torch.Tensor) -> torch.Tensor:
    """Group-major [g, B/g, ...] -> [B, ...] (inverse of ``to_grouped``)."""
    return x4.transpose(0, 1).reshape(-1, *x4.shape[2:])


# (kind, kernel, dilation, activation) of the DCTTS-style stack:
# 2 conv(k=1) + 8 highway(k=3, dilation 3^i twice) + 2 highway(k=3)
# + 2 highway(k=1)
_STACK = (
    [("conv", 1, 1, "relu"), ("conv", 1, 1, "identity")]
    + [("hw", 3, 3 ** i, "identity") for i in range(4)] * 2
    + [("hw", 3, 1, "identity")] * 2
    + [("hw", 1, 1, "identity")] * 2
)


class GeneratedConvolutionalEncoder(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, embedding_dim: int,
                 bottleneck_dim: int, groups: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.groups = groups
        self.generator_embedding = nn.Embedding(groups, embedding_dim)
        layers = {}
        for li, (kind, k, dil, act) in enumerate(_STACK):
            cls = ConvBlockGenerated if kind == "conv" else HighwayConvBlockGenerated
            layers[f"layer{li}"] = cls(
                embedding_dim, bottleneck_dim,
                (input_dim if li == 0 else output_dim) * groups,
                output_dim * groups, k, act, dil, groups, dtype, dropout)
        self.stack = nn.ModuleDict(layers)

    def _run_stack(self, x4, lang_ids, mask):
        """``x4`` [r, Bg, T, c]; ``lang_ids`` [r]; ``mask`` [r, Bg, T, 1]."""
        emb = self.generator_embedding(lang_ids)
        for layer in self.stack.values():
            x4 = layer(emb, x4, lang_ids) * mask.to(x4.dtype)
        return x4

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                lang_weights: torch.Tensor | None = None,
                group_langs: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` [B, T, C] -> [B, T, C_out].  At most one of ``group_langs``
        [r] (row groups) and ``lang_weights`` [B, T, L] (mixing) is given;
        with neither, the batch is language-interleaved."""
        b, t, c = x.shape
        mask = (torch.arange(t, device=x.device)[None, :]
                < lengths[:, None]).float()                     # [B, T]
        if group_langs is None and lang_weights is None:
            g = self.groups
            if b % g:
                raise ValueError(f"batch {b} is not a multiple of the {g} "
                                 "language groups")
            h = self._run_stack(to_grouped(x, g),
                                torch.arange(g, device=x.device),
                                to_grouped(mask[..., None], g))
            return from_grouped(h)
        if group_langs is not None:
            if lang_weights is not None:
                raise ValueError("row groups and accent mixing are exclusive")
            r = group_langs.shape[0]
            h = self._run_stack(x.reshape(r, b // r, t, c), group_langs,
                                mask.reshape(r, b // r, t, 1))
            return h.reshape(b, t, -1)
        g = self.groups
        all_langs = torch.arange(g, device=x.device)
        h = self._run_stack(x[None].expand(g, b, t, c), all_langs,
                            mask[None, :, :, None].expand(g, b, t, 1))
        w = lang_weights / torch.clamp(
            lang_weights.sum(dim=2, keepdim=True), min=1e-8)
        return torch.einsum("btl,lbtc->btc", w, h.float())
