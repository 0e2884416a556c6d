"""The autoregressive Tacotron 2 decoder: teacher-forced training and
chunked free-running inference.

Port of the JAX package's ``models/decoder.py``.  The module tree mirrors
the flax parameter paths (``cell.prenet.fc0``,
``cell.attention_lstm.cell.gates``, ...), so a JAX weight tree maps onto it
by ``interop.from_jax``.  ``DecoderCell`` holds the step's weights.  The
free-running step is ``ops/fused_decoder.py``, whose plain PyTorch chunk
``Decoder.decode_chunk`` runs with exact gates, as the counterpart of the
JAX package's ``lax.scan`` decode; the serving path runs the same chunk
through ``fused_decoder.decode_chunk`` (the CUDA kernels on the card).
``Decoder.forward`` is the teacher-forced decode of
``ops/fused_train_decoder.py`` (its kernels on the card, its plain version
on the CPU), the JAX package's fused train branch, in train or eval mode as
the module is.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from multilingual_text_to_speech_tpu_torch.models.attention import (
    init_attention_state,
    make_attention,
)
from multilingual_text_to_speech_tpu_torch.models.rnn import (
    RegularizedLSTMCell,
)
from multilingual_text_to_speech_tpu_torch.ops import (
    fused_decoder,
    fused_train_decoder,
)

Carry = Dict[str, Any]


class Prenet(nn.Module):
    """Linear + ReLU stack whose dropout stays on at inference, for output
    variety (a quirk of the reference model)."""

    def __init__(self, input_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"fc{i}", nn.Linear(
                input_dim if i == 0 else output_dim, output_dim))
        self.num_layers = num_layers


class DecoderCell(nn.Module):
    """The weights of one free-running step: prenet, attention LSTM,
    attention (``hp.attention_type``), generator LSTM, frame and stop
    heads."""

    def __init__(self, hp, memory_dim: int):
        super().__init__()
        h = hp.decoder_dimension
        self.prenet = Prenet(hp.num_mels, hp.prenet_dimension,
                             hp.prenet_layers)
        self.attention_lstm = RegularizedLSTMCell(
            hp.prenet_dimension + memory_dim, h)
        self.attention = make_attention(hp, memory_dim)
        self.generator_lstm = RegularizedLSTMCell(h + memory_dim, h)
        self.frame_prediction = nn.Linear(h + memory_dim, hp.num_mels)
        self.stop_prediction = nn.Linear(h + memory_dim, 1)


class Decoder(nn.Module):
    """Speaker/language conditioning of the memory, its projection, the
    initial carry, and the chunked free-running decode."""

    def __init__(self, hp, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hp = hp
        mem = hp.encoder_dimension
        if hp.multi_speaker and hp.speaker_embedding_dimension > 0:
            self.speaker_embedding = nn.Embedding(
                hp.speaker_number, hp.speaker_embedding_dimension)
            mem += hp.speaker_embedding_dimension
        if hp.multi_language and hp.language_embedding_dimension > 0:
            self.language_embedding = nn.Embedding(
                hp.language_number, hp.language_embedding_dimension)
            mem += hp.language_embedding_dimension
        self.memory_dim = mem
        self.memory = nn.Linear(mem, hp.attention_dimension, bias=False)
        self.cell = DecoderCell(hp, mem)
        self.dtype = dtype
        zo = hp.decoder_regularization == "zoneout"
        # keyword arguments of fused_decoder.decode_chunk
        self.decode_kwargs = dict(
            dropout_rate=float(hp.dropout),
            zoneout_h=float(hp.zoneout_hidden) if zo else 0.0,
            zoneout_c=float(hp.zoneout_cell) if zo else 0.0)

    def prepare_memory(self, encoded: torch.Tensor,
                       speakers: Optional[torch.Tensor],
                       languages: Optional[torch.Tensor]):
        """encoded [B, T, C] float32; speakers [B]; languages [B, T] ->
        (memory [B, T, Mem], memory_transform [B, T, A]), both in the
        compute type."""
        b, t = encoded.shape[:2]
        parts = [encoded]
        if hasattr(self, "speaker_embedding"):
            parts.append(self.speaker_embedding(speakers)[:, None, :]
                         .expand(b, t, -1))
        if hasattr(self, "language_embedding"):
            parts.append(self.language_embedding(languages))
        memory = torch.cat(parts, dim=-1).to(self.dtype)
        mt = memory @ self.memory.weight.to(self.dtype).t()
        return memory, mt

    def forward(self, encoded: torch.Tensor, text_lengths: torch.Tensor,
                target: torch.Tensor, teacher: Sequence[int],
                seeds: Tuple[int, int], speakers: Optional[torch.Tensor],
                languages: Optional[torch.Tensor]):
        """The teacher-forced decode.  ``encoded`` [B, T, C] float32,
        ``target`` [B, F, M] mel frames, ``teacher`` F flags (1: the step
        reads the previous target frame, 0: its own previous prediction),
        ``seeds`` the two uint32 seeds of the dropout and zoneout hash ->
        ``(spec [B, F, M], stop logits [B, F], alignments [B, F, T])``,
        float32.  In train mode (``self.training``) it is differentiable;
        in eval mode it is the JAX package's ``Tacotron(train=False)``
        decode (zoneout interpolated, no dropout on the LSTM outputs,
        prenet dropout on), for evaluation and GTA, and its outputs carry
        no ``grad_fn``."""
        t = encoded.shape[1]
        memory, mt = self.prepare_memory(encoded, speakers, languages)
        mask = (torch.arange(t, device=encoded.device)[None, :]
                < text_lengths[:, None])
        shifted = torch.cat([torch.zeros_like(target[:, :1]),
                             target[:, :-1]], dim=1)
        cfg = fused_train_decoder.TrainConfig.from_hp(
            self.hp, self.memory_dim, self.dtype, train=self.training)
        return fused_train_decoder.decode(self.cell, cfg, memory, mt, mask,
                                          shifted, teacher, seeds)

    def initial_carry(self, batch_size: int, max_len: int,
                      device=None) -> Carry:
        hp = self.hp

        def z(width):
            return torch.zeros(batch_size, width, device=device)

        h = hp.decoder_dimension
        return {
            "h_att": z(h), "c_att": z(h), "h_gen": z(h), "c_gen": z(h),
            "context": z(self.memory_dim), "frame": z(hp.num_mels),
            "att_state": init_attention_state(
                hp.attention_type, batch_size, max_len, device),
        }

    def decode_chunk(self, carry: Carry, memory, memory_transform, mask,
                     seeds: Tuple[int, int], chunk_frames: int):
        """``chunk_frames`` free-running steps of the plain chunk with exact
        (unquantized) gates -> (carry, (spec [B, S, M], stop logits
        [B, S]))."""
        bundle = fused_decoder.extract_decoder_bundle(
            self.cell, self.dtype, quantize_gates=False)
        return fused_decoder.decode_chunk_plain(
            bundle, carry, memory, memory_transform, mask, seeds,
            chunk_frames, **self.decode_kwargs)
