"""The encoders of the paper's parameter-sharing strategies.

Port of the JAX package's ``models/encoder.py``:

- ``Encoder`` (``simple``): a conv stack, then a BiLSTM over each sample's
  true length (packed sequences: padding contributes nothing, the backward
  direction starts at each sample's last token, padded outputs are zero);
- ``ConditionalEncoder`` (``shared``): a language embedding concatenated to
  each character, then an ``Encoder``;
- ``MultiEncoder`` (``separate``): one ``Encoder`` a language, the outputs
  mixed per character by the language weights normalized per sample (the
  reference model normalizes by the first sample's sums by mistake; the
  JAX package does not copy that, nor does the port);
- ``ConvolutionalEncoder`` (``convolutional``) and
  ``GeneratedConvolutionalEncoder`` (``generated``, the meta-learning
  encoder): the DCTTS-style grouped highway conv stack, one group a
  language, with plain or generated weights.

The BiLSTM is PyTorch's ``nn.LSTM`` (cuDNN on the card): the JAX package
runs it outside any TPU kernel.  It runs in float32 on inputs rounded to
the compute type, as flax's ``OptimizedLSTMCell(dtype=bfloat16)`` rounds
its products' inputs.

The two grouped encoders share three paths:

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
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from multilingual_text_to_speech_tpu_torch.models.layers import (
    ConvBlock,
    ConvBlockGenerated,
    GroupedConvBlock,
    GroupedHighwayConvBlock,
    HighwayConvBlockGenerated,
)


def normalize_lang_weights(w: torch.Tensor) -> torch.Tensor:
    """Per-character language weights [B, T, L] scaled to sum to 1."""
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-8)


class Encoder(nn.Module):
    """The vanilla Tacotron 2 encoder: ``num_blocks`` conv blocks (ReLU,
    dropout), then a BiLSTM of ``output_dim / 2`` units a direction over
    each sample's length.  ``lang_weights`` and ``group_langs`` are taken
    and ignored."""

    def __init__(self, input_dim: int, output_dim: int, num_blocks: int = 3,
                 kernel_size: int = 5, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output_dim % 2:
            raise ValueError(f"the BiLSTM needs an even width, got "
                             f"{output_dim}")
        for i in range(num_blocks):
            self.add_module(f"conv{i}", ConvBlock(
                input_dim if i == 0 else output_dim, output_dim, kernel_size,
                "relu", dtype, dropout))
        self.num_blocks = num_blocks
        self.bilstm = nn.LSTM(output_dim, output_dim // 2, batch_first=True,
                              bidirectional=True)
        # flax's cell has one bias a gate: bias_ih holds it, and bias_hh
        # stays zero and out of training (two trained copies would take
        # two optimizer steps a step)
        for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
            getattr(self.bilstm, name).requires_grad_(False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                lang_weights: torch.Tensor | None = None,
                group_langs: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` [B, T, C] -> [B, T, output_dim] float32, zero past each
        length."""
        t = x.shape[1]
        for i in range(self.num_blocks):
            x = getattr(self, f"conv{i}")(x)
        x = x.to(self.dtype).float()
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                      enforce_sorted=False)
        self.bilstm.flatten_parameters()
        out, _ = self.bilstm(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
        return out


class ConditionalEncoder(nn.Module):
    """The ``shared`` strategy: each character's language embedding (the
    argmax of its weights) concatenated to its embedding, then an
    ``Encoder``."""

    def __init__(self, num_langs: int, langs_embedding_dim: int,
                 input_dim: int, output_dim: int, num_blocks: int = 3,
                 kernel_size: int = 5, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.language_embedding = nn.Embedding(num_langs, langs_embedding_dim)
        self.encoder = Encoder(input_dim + langs_embedding_dim, output_dim,
                               num_blocks, kernel_size, dropout, dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                lang_weights: torch.Tensor,
                group_langs: torch.Tensor | None = None) -> torch.Tensor:
        emb = self.language_embedding(torch.argmax(lang_weights, dim=2))
        return self.encoder(torch.cat([x, emb.to(x.dtype)], dim=-1), lengths)


class MultiEncoder(nn.Module):
    """The ``separate`` strategy: ``num_langs`` ``Encoder``s on the same
    input, mixed per character by the normalized language weights."""

    def __init__(self, num_langs: int, input_dim: int, output_dim: int,
                 num_blocks: int = 3, kernel_size: int = 5,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoders = nn.ModuleList(
            Encoder(input_dim, output_dim, num_blocks, kernel_size, dropout,
                    dtype) for _ in range(num_langs))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                lang_weights: torch.Tensor,
                group_langs: torch.Tensor | None = None) -> torch.Tensor:
        outs = torch.stack([enc(x, lengths) for enc in self.encoders])
        return torch.einsum("btl,lbtc->btc",
                            normalize_lang_weights(lang_weights.float()),
                            outs)


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


def _build_stack(conv_cls, highway_cls, input_dim: int, output_dim: int,
                 groups: int, in_scale: int, *lead, **kw) -> nn.ModuleDict:
    """``layer0`` .. ``layer13`` of ``_STACK``, each ``conv_cls`` or
    ``highway_cls`` built as ``cls(*lead, in_scale * c_in, output_dim *
    groups, k, activation, dilation, groups, **kw)`` with c_in the
    per-group input width (``input_dim`` for the first layer)."""
    return nn.ModuleDict({
        f"layer{li}": (conv_cls if kind == "conv" else highway_cls)(
            *lead, in_scale * (input_dim if li == 0 else output_dim),
            output_dim * groups, k, act, dil, groups, **kw)
        for li, (kind, k, dil, act) in enumerate(_STACK)})


class _GroupedEncoder(nn.Module):
    """The three paths (language-interleaved groups, row groups, mixing) of
    both grouped encoders over their ``stack`` of ``_STACK`` blocks; a
    subclass runs the stack on ``[r, Bg, T, c]`` rows with ``_run_stack``,
    whose ``lang_ids`` [r] is None where the rows are the g groups in
    order."""

    groups: int

    def _run_stack(self, x4, lang_ids, mask):
        raise NotImplementedError

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
            h = self._run_stack(to_grouped(x, g), None,
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
        h = self._run_stack(x[None].expand(g, b, t, c), None,
                            mask[None, :, :, None].expand(g, b, t, 1))
        return torch.einsum("btl,lbtc->btc",
                            normalize_lang_weights(lang_weights), h.float())


class ConvolutionalEncoder(_GroupedEncoder):
    """The grouped highway conv stack with plain weights, one group a
    language (the ``separate`` strategy of the convolutional encoder)."""

    def __init__(self, input_dim: int, output_dim: int, groups: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.groups = groups
        self.stack = _build_stack(
            GroupedConvBlock, GroupedHighwayConvBlock, input_dim, output_dim,
            groups, 1, dtype=dtype, dropout=dropout)

    def _run_stack(self, x4, lang_ids, mask):
        """``x4`` [r, Bg, T, c]; ``lang_ids`` [r] or None; ``mask`` [r, Bg,
        T, 1]."""
        for layer in self.stack.values():
            x4 = layer(x4, lang_ids) * mask.to(x4.dtype)
        return x4


class GeneratedConvolutionalEncoder(_GroupedEncoder):
    """The grouped highway conv stack whose kernels and batch-norm affines
    a generator emits from a learned per-language embedding (the paper's
    meta-learning encoder)."""

    def __init__(self, input_dim: int, output_dim: int, embedding_dim: int,
                 bottleneck_dim: int, groups: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.groups = groups
        self.generator_embedding = nn.Embedding(groups, embedding_dim)
        self.stack = _build_stack(
            ConvBlockGenerated, HighwayConvBlockGenerated, input_dim,
            output_dim, groups, groups, embedding_dim, bottleneck_dim,
            dtype=dtype, dropout=dropout)

    def _run_stack(self, x4, lang_ids, mask):
        """``x4`` [r, Bg, T, c]; ``lang_ids`` [r] or None; ``mask`` [r, Bg,
        T, 1]."""
        if lang_ids is None:
            lang_ids = torch.arange(self.groups, device=x4.device)
        emb = self.generator_embedding(lang_ids)
        for layer in self.stack.values():
            x4 = layer(emb, x4, lang_ids) * mask.to(x4.dtype)
        return x4
