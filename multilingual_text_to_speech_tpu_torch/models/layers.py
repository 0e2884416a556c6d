"""Convolutional blocks, plain and meta-generated.

Port of the JAX package's ``models/layers.py``.  Activations are
channels-last ``[batch, time, channels]`` at the public functions, like the
JAX package.  The grouped blocks, plain and generated, work on the
group-major layout ``[r, B, T, c]`` (r row groups, each with its own
language), and their convolutions run as one ``F.conv1d(groups=r)``.

In eval mode batch norm uses running statistics, and the generated blocks
fold them into the generated kernel as the JAX eval path does.  In train
mode (``module.train()``) batch norm normalizes by the batch's own
statistics and updates the running ones, and dropout is on, as the JAX
blocks do with ``train=True``.  Parameters stay float32; ``dtype`` is the
compute type of the convolutions.

A block's ``mesh`` (``Tacotron(mesh=)`` sets it, ``None`` by default) makes
its batch statistics those of the global batch, as JAX computes them under
SPMD: the first and second moments' sums and the count are summed over the
ranks with autograd (``batch_moments``), so the running statistics move
identically on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from multilingual_text_to_speech_tpu_torch.parallel.collectives import (
    all_sum,
    single,
)

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _ACTIVATIONS[name]


def same_pad_amounts(kernel: int, dilation: int) -> tuple[int, int]:
    """'same' padding, even kernels included (one more on the right)."""
    p = (kernel - 1) * dilation // 2
    return (p, p) if kernel % 2 != 0 else (p, p + 1)


def batch_moments(y: torch.Tensor, dims, mesh=None):
    """``(mean, mean of squares, count)`` of ``y`` over ``dims``: this
    process's batch alone, or with a mesh of several ranks the global
    batch's (the sums and counts summed over the ranks, differentiably;
    the count, a tensor then, counts each row once where ranks share
    it)."""
    n = 1
    for d in dims:
        n *= y.shape[d]
    if single(mesh):
        return y.mean(dim=dims), (y * y).mean(dim=dims), n
    sums = torch.stack([y.sum(dim=dims), (y * y).sum(dim=dims)])
    flat = all_sum(torch.cat([sums.reshape(-1), sums.new_full((1,), n)]),
                   mesh)
    moments = flat[:-1].reshape(sums.shape) / flat[-1]
    return moments[0], moments[1], flat[-1].detach() / mesh.replicas


def highway_gate(gate: torch.Tensor, value: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The highway combination ``value * sigmoid(gate) + x * (1 -
    sigmoid(gate))`` of a gated block's two halves."""
    p = torch.sigmoid(gate)
    return value * p + x * (1.0 - p)


def grouped_conv1d(x4: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None, dilation: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """'same' 1-D convolution of each row group with its own kernel.

    ``x4`` [r, B, T, cin], ``kernel`` [k, cin, r, cout] (the JAX package's
    generated layout), ``bias`` [r*cout] or None -> [r, B, T, cout]."""
    r, b, t, cin = x4.shape
    k, _, _, cout = kernel.shape
    xx = x4.to(dtype).permute(1, 0, 3, 2).reshape(b, r * cin, t)
    w = kernel.to(dtype).permute(2, 3, 1, 0).reshape(r * cout, cin, k)
    y = F.conv1d(F.pad(xx, same_pad_amounts(k, dilation)), w,
                 dilation=dilation, groups=r)
    y = y.reshape(b, r, cout, t).permute(1, 0, 3, 2)
    if bias is not None:
        y = y + bias.reshape(r, 1, 1, cout).to(y.dtype)
    return y


class ConvBlock(nn.Module):
    """Conv1d -> BatchNorm -> activation -> dropout, channels-last: the
    postnet's block.

    Train mode follows flax ``nn.BatchNorm`` (momentum 0.9): the batch's
    biased variance normalizes, and the running mean and var move as
    ``0.9 * old + 0.1 * batch`` with that biased variance.
    ``torch.nn.BatchNorm1d`` would update the running var with the unbiased
    estimate, so its module holds only the parameters and statistics here.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 activation: str = "identity",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, out_channels, kernel, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(out_channels, eps=1e-5)
        self.kernel = kernel
        self.activation = get_activation(activation)
        self.dtype = dtype
        self.dropout = dropout
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # [B, F, C]
        xx = F.pad(x.to(self.dtype).transpose(1, 2),
                   same_pad_amounts(self.kernel, 1))
        y = F.conv1d(xx, self.Conv_0.weight.to(self.dtype)).float()
        bn = self.BatchNorm_0
        if not self.training:
            return self.activation(bn(y)).transpose(1, 2)
        mean, mean_sq, _ = batch_moments(y, (0, 2), self.mesh)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(0.9).add_(0.1 * mean)
            bn.running_var.mul_(0.9).add_(0.1 * var)
        inv = torch.rsqrt(var + bn.eps) * bn.weight
        y = (y - mean[:, None]) * inv[:, None] + bn.bias[:, None]
        y = F.dropout(self.activation(y), self.dropout, training=True)
        return y.transpose(1, 2)


class GroupedConvBlock(nn.Module):
    """Grouped conv -> batch norm -> activation (-> dropout in train mode)
    on the group-major ``[r, B, T, c]`` layout: the JAX package's
    ``ConvBlock`` with ``groups`` > 1 (its ``_GroupedConv1d`` and
    ``_GroupedBatchNorm``).  ``Conv_0`` holds the grouped kernel in
    ``nn.Conv1d(groups=g)``'s layout ``[g*cout, cin, k]`` and
    ``BatchNorm_0`` the flat ``[g*cout]`` affine and running statistics,
    group j's channels at ``[j*cout, (j+1)*cout)``; ``group_langs`` [r]
    picks each row group's kernel block, affine and statistics (eval
    only).  Batch norm follows flax: in train mode each group's biased
    batch variance over (B, T), padded positions included, with the running
    statistics moving as ``0.9 * old + 0.1 * batch``; it normalizes in
    float32 and returns float32, as the JAX block does."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 activation: str = "identity", dilation: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels * groups, out_channels, kernel,
                                groups=groups, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(out_channels, eps=1e-5)
        self.groups = groups
        self.activation = get_activation(activation)
        self.dilation = dilation
        self.dtype = dtype
        self.dropout = dropout
        self.mesh = None

    def forward(self, x4: torch.Tensor,
                group_langs: torch.Tensor | None = None) -> torch.Tensor:
        g, bn = self.groups, self.BatchNorm_0
        cout_g, cin, k = self.Conv_0.weight.shape
        cout = cout_g // g
        kernel = self.Conv_0.weight.reshape(g, cout, cin, k).permute(
            3, 2, 0, 1)                                      # [k, cin, g, cout]
        scale, bias = bn.weight.reshape(g, cout), bn.bias.reshape(g, cout)
        if group_langs is not None:
            kernel = kernel[:, :, group_langs]
            scale, bias = scale[group_langs], bias[group_langs]
        y = grouped_conv1d(x4, kernel, None, self.dilation, self.dtype).float()
        if self.training:
            if group_langs is not None:
                raise ValueError("row-group language gathers are "
                                 "inference-only")
            mean, mean_sq, _ = batch_moments(y, (1, 2), self.mesh)
            var = mean_sq - mean * mean                          # [g, cout]
            with torch.no_grad():
                bn.running_mean.mul_(0.9).add_(0.1 * mean.reshape(-1))
                bn.running_var.mul_(0.9).add_(0.1 * var.reshape(-1))
        else:
            mean = bn.running_mean.reshape(g, cout)
            var = bn.running_var.reshape(g, cout)
            if group_langs is not None:
                mean, var = mean[group_langs], var[group_langs]
        inv = torch.rsqrt(var + bn.eps) * scale
        shift = bias - mean * inv
        y = self.activation(y * inv[:, None, None, :]
                            + shift[:, None, None, :])
        return F.dropout(y, self.dropout, training=self.training)


class GroupedHighwayConvBlock(nn.Module):
    """Gated grouped conv (the JAX package's ``HighwayConvBlock`` with
    ``groups`` > 1): a 2c-wide ``GroupedConvBlock`` whose per-group channels
    are ``[gate c | value c]``, then ``highway_gate``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 activation: str = "identity", dilation: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.ConvBlock_0 = GroupedConvBlock(
            in_channels, 2 * out_channels, kernel, activation, dilation,
            groups, dtype, dropout)
        self.c = out_channels // groups

    def forward(self, x4: torch.Tensor,
                group_langs: torch.Tensor | None = None) -> torch.Tensor:
        h = self.ConvBlock_0(x4, group_langs)
        return highway_gate(h[..., :self.c], h[..., self.c:], x4)


class Conv1dGenerated(nn.Module):
    """Grouped conv whose per-group kernel is generated from a language
    embedding: ``embedding [r, E] -> Linear(E, bottleneck) ->
    Linear(bottleneck, k*cin*cout)``.  The generating Linear's outputs are
    ordered ``(k, cin, cout)``, the JAX package's column order, so a JAX
    weight maps over with one transpose.  No conv bias: every generated
    block of the encoder carries batch norm."""

    def __init__(self, embedding_dim: int, bottleneck_dim: int,
                 in_channels: int, out_channels: int, kernel: int,
                 groups: int):
        super().__init__()
        self.cin = in_channels // groups
        self.cout = out_channels // groups
        self.k = kernel
        self.bottleneck = nn.Linear(embedding_dim, bottleneck_dim)
        self.kernel = nn.Linear(bottleneck_dim, self.cout * self.cin * kernel)

    def generate(self, embedding: torch.Tensor) -> torch.Tensor:
        """[r, E] -> kernel [k, cin, r, cout]."""
        r = embedding.shape[0]
        flat = self.kernel(self.bottleneck(embedding))
        return flat.reshape(r, self.k, self.cin, self.cout).permute(1, 2, 0, 3)


class BatchNorm1dGenerated(nn.Module):
    """Batch norm with a generated per-group affine and running statistics
    shared by all groups (flat ``[g*c]`` buffers named as in the JAX
    package's ``batch_stats``)."""

    def __init__(self, embedding_dim: int, bottleneck_dim: int,
                 num_features: int, groups: int, eps: float = 1e-8):
        super().__init__()
        self.c = num_features // groups
        self.groups = groups
        self.eps = eps
        self.bottleneck = nn.Linear(embedding_dim, bottleneck_dim)
        self.affine = nn.Linear(bottleneck_dim, 2 * self.c)
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.mesh = None

    def normalize_train(self, embedding: torch.Tensor,
                        x4: torch.Tensor) -> torch.Tensor:
        """Train mode on the group-major ``x4`` [g, B/g, T, c]: each group's
        own batch statistics over (B/g, T), padded positions included; the
        flat ``[g*c]`` running statistics move with momentum 0.1 and the
        unbiased variance.  Normalizes in float32, returns ``x4``'s type."""
        affine = self.affine(self.bottleneck(embedding))
        scale, bias = affine[:, :self.c], affine[:, self.c:]
        x32 = x4.float()
        mean, mean_sq, n = batch_moments(x32, (1, 2), self.mesh)  # [g, c]
        var = mean_sq - mean * mean
        with torch.no_grad():
            unbiased = var * (n / (max(n - 1.0, 1.0) if isinstance(n, int)
                                   else torch.clamp(n - 1.0, min=1.0)))
            self.mean.mul_(0.9).add_(0.1 * mean.reshape(-1))
            self.var.mul_(0.9).add_(0.1 * unbiased.reshape(-1))
        inv = torch.rsqrt(var + self.eps) * scale
        shift = bias - mean * inv
        return (x4 * inv[:, None, None, :]
                + shift[:, None, None, :]).to(x4.dtype)

    def scale_and_shift(self, embedding: torch.Tensor,
                        lang_ids: torch.Tensor):
        """Per-row-group ``inv = scale / sqrt(var + eps)`` and
        ``shift = bias - mean * inv``, each [r, c]; ``lang_ids`` [r] picks
        each row group's running statistics."""
        affine = self.affine(self.bottleneck(embedding))
        scale, bias = affine[:, :self.c], affine[:, self.c:]
        mean = self.mean.reshape(self.groups, self.c)[lang_ids]
        var = self.var.reshape(self.groups, self.c)[lang_ids]
        inv = scale * torch.rsqrt(var + self.eps)
        return inv, bias - mean * inv


class ConvBlockGenerated(nn.Module):
    """Generated conv -> generated batch norm -> activation (-> dropout in
    train mode); in eval mode the batch norm is folded into the generated
    kernel and bias."""

    def __init__(self, embedding_dim: int, bottleneck_dim: int,
                 in_channels: int, out_channels: int, kernel: int,
                 activation: str = "identity", dilation: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.Conv1dGenerated_0 = Conv1dGenerated(
            embedding_dim, bottleneck_dim, in_channels, out_channels, kernel,
            groups)
        self.BatchNorm1dGenerated_0 = BatchNorm1dGenerated(
            embedding_dim, bottleneck_dim, out_channels, groups)
        self.activation = get_activation(activation)
        self.dilation = dilation
        self.dtype = dtype
        self.dropout = dropout

    def generate_folded(self, embedding, lang_ids):
        """Kernel [k, cin, r, cout] and bias [r*cout] with the batch norm
        folded in."""
        kernel = self.Conv1dGenerated_0.generate(embedding)
        inv, shift = self.BatchNorm1dGenerated_0.scale_and_shift(
            embedding, lang_ids)
        return kernel * inv, shift.reshape(-1)

    def forward(self, embedding, x4, lang_ids):
        if self.training:
            kernel = self.Conv1dGenerated_0.generate(embedding)
            y = self.BatchNorm1dGenerated_0.normalize_train(
                embedding,
                grouped_conv1d(x4, kernel, None, self.dilation, self.dtype))
            return F.dropout(self.activation(y), self.dropout, training=True)
        kernel, bias = self.generate_folded(embedding, lang_ids)
        return self.activation(
            grouped_conv1d(x4, kernel, bias, self.dilation, self.dtype))


class HighwayConvBlockGenerated(nn.Module):
    """Gated generated conv: a 2c-wide generated block whose per-group
    channels are ``[gate c | value c]``; the conv is split at generation time
    into a gate conv and a value conv, then
    ``out = value * sigmoid(gate) + x * (1 - sigmoid(gate))``."""

    def __init__(self, embedding_dim: int, bottleneck_dim: int,
                 in_channels: int, out_channels: int, kernel: int,
                 activation: str = "identity", dilation: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.ConvBlockGenerated_0 = ConvBlockGenerated(
            embedding_dim, bottleneck_dim, in_channels, 2 * out_channels,
            kernel, activation, dilation, groups, dtype, dropout)
        self.c = out_channels // groups

    def forward(self, embedding, x4, lang_ids):
        block = self.ConvBlockGenerated_0
        c = self.c
        if self.training:
            h = block(embedding, x4, lang_ids)
            return highway_gate(h[..., :c], h[..., c:], x4)
        kernel, bias = block.generate_folded(embedding, lang_ids)
        bias = bias.reshape(embedding.shape[0], 2 * c)
        h1 = block.activation(grouped_conv1d(
            x4, kernel[..., :c], bias[:, :c].reshape(-1), block.dilation,
            block.dtype))
        h2 = block.activation(grouped_conv1d(
            x4, kernel[..., c:], bias[:, c:].reshape(-1), block.dilation,
            block.dtype))
        return highway_gate(h1, h2, x4)
