"""Tacotron 2: the training forward and loss, and the inference pieces
(encode, chunked decode, postnet).

Port of ``Tacotron``, ``TacotronLossState`` and ``tacotron_loss`` in the JAX
package's ``models/tacotron.py``: every encoder of the paper's strategies
(``simple``, ``shared``, ``separate``, ``convolutional`` and the flagship's
``generated``), both speaker classifiers (gradient reversal and cosine
similarity), every attention type, and both postnets (the conv stack, and
the CBHG predicting linear spectrograms with ``hp.predict_linear``).
Spectrograms are channels-last ``[batch, frames, bins]`` like the JAX
package.  ``Tacotron.forward`` is the training forward: call
``model.train()`` first for batch-statistics batch norm and dropout.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multilingual_text_to_speech_tpu_torch.device import exact_float32
from multilingual_text_to_speech_tpu_torch.models.attention import (
    LocationSensitiveAttention,
)
from multilingual_text_to_speech_tpu_torch.models.classifier import (
    CosineSimilarityClassifier,
    ReversalClassifier,
    cosine_similarity_classifier_loss,
    reversal_classifier_loss,
)
from multilingual_text_to_speech_tpu_torch.models.decoder import Decoder
from multilingual_text_to_speech_tpu_torch.models.encoder import (
    ConditionalEncoder,
    ConvolutionalEncoder,
    Encoder,
    GeneratedConvolutionalEncoder,
    MultiEncoder,
)
from multilingual_text_to_speech_tpu_torch.models.layers import (
    BatchNorm1dGenerated,
    Conv1dGenerated,
    ConvBlock,
    GroupedConvBlock,
)
from multilingual_text_to_speech_tpu_torch.parallel.collectives import (
    single,
    total,
)
from multilingual_text_to_speech_tpu_torch.models.postnet import (
    Postnet,
    PostnetCBHG,
)


def lengths_to_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    return (torch.arange(max_length, device=lengths.device)[None, :]
            < lengths[:, None])


# the encoders that take a language-interleaved batch and row groups
GROUPED_ENCODERS = ("convolutional", "generated")
# the modules whose train mode normalizes by batch statistics
BATCH_NORM_SITES = (ConvBlock, GroupedConvBlock, BatchNorm1dGenerated)


def make_encoder(hp, dtype: torch.dtype) -> nn.Module:
    """The encoder of ``hp.encoder_type`` (the JAX package's
    ``Tacotron._make_encoder``).  The grouped convolutional encoders' dropout
    is 0.05 whatever ``hp.dropout`` says, as in the reference model's
    factory; the others take ``hp.dropout``."""
    langs = hp.language_number if hp.multi_language else 1
    e, d = hp.embedding_dimension, hp.encoder_dimension
    common = dict(num_blocks=hp.encoder_blocks,
                  kernel_size=hp.encoder_kernel_size, dropout=hp.dropout,
                  dtype=dtype)
    kind = hp.encoder_type
    if kind == "simple":
        return Encoder(e, d, **common)
    if kind == "separate":
        return MultiEncoder(langs, e, d, **common)
    if kind == "shared":
        return ConditionalEncoder(langs, hp.input_language_embedding, e, d,
                                  **common)
    if kind == "convolutional":
        return ConvolutionalEncoder(e, d, langs, dtype, dropout=0.05)
    if kind == "generated":
        return GeneratedConvolutionalEncoder(
            e, d, hp.generator_dim, hp.generator_bottleneck_dim, langs, dtype,
            dropout=0.05)
    raise ValueError(f"unknown encoder type: {kind!r}")


class Tacotron(nn.Module):
    """``mesh`` (``parallel.make_mesh``), as JAX's ``Tacotron(mesh=)``:
    with several ranks, each runs this model on its rows of the global
    batch, and train mode's batch statistics are the global batch's (every
    batch-norm site's moments summed over the ranks)."""

    def __init__(self, hp, dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.hp = hp
        self.dtype = dtype
        self.mesh = mesh
        self.embedding = nn.Embedding(hp.total_symbols(),
                                      hp.embedding_dimension)
        self.encoder = make_encoder(hp, dtype)
        if hp.reversal_classifier:
            if hp.reversal_classifier_type == "reversal":
                self.classifier = ReversalClassifier(
                    hp.encoder_dimension, hp.reversal_classifier_dim,
                    hp.speaker_number, hp.reversal_gradient_clipping,
                    dtype=dtype)
            else:
                self.classifier = CosineSimilarityClassifier(
                    hp.encoder_dimension, hp.speaker_number,
                    hp.reversal_gradient_clipping, dtype=dtype)
        self.decoder = Decoder(hp, dtype)
        if hp.predict_linear:
            self.postnet = PostnetCBHG(
                hp.num_mels, hp.num_fft // 2 + 1, hp.cbhg_bank_kernels,
                hp.cbhg_bank_dimension, hp.cbhg_projection_dimension,
                hp.cbhg_projection_kernel_size, hp.cbhg_highway_dimension,
                hp.cbhg_rnn_dim, hp.cbhg_dropout, dtype)
        else:
            self.postnet = Postnet(hp.num_mels, hp.postnet_dimension,
                                   hp.postnet_blocks, hp.postnet_kernel_size,
                                   dtype, hp.dropout)
        for m in self.modules():
            if isinstance(m, BATCH_NORM_SITES):
                m.mesh = mesh

    def _language_weights(self, languages: torch.Tensor, t: int):
        """[B] language ids or [B, T, L] weights -> [B, T, L] weights."""
        num_langs = self.hp.language_number if self.hp.multi_language else 1
        if languages.dim() == 1:
            return F.one_hot(languages.long()[:, None].expand(-1, t),
                             num_langs).float()
        return languages.float()

    def _encode(self, text: torch.Tensor, text_lengths: torch.Tensor,
                langs_w: torch.Tensor, mix: bool,
                group_langs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The JAX package's ``Tacotron._encode``: -> [B, T, C] float32.  A
        grouped encoder gets ``group_langs`` (row groups) when given, else
        the language weights when ``mix`` (accent mixing), else nothing (a
        language-interleaved batch); the other encoders always get the
        weights."""
        embedded = self.embedding(text.long())
        embedded = embedded * (text != 0)[..., None]      # PAD embeds to 0
        embedded = embedded.to(self.dtype)
        grouped = self.hp.encoder_type in GROUPED_ENCODERS
        if group_langs is not None and grouped:
            encoded = self.encoder(embedded, text_lengths,
                                   group_langs=group_langs.long())
        else:
            encoded = self.encoder(
                embedded, text_lengths,
                lang_weights=langs_w if mix or not grouped else None)
        return encoded.float()

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                speakers: Optional[torch.Tensor], languages: torch.Tensor,
                teacher: Sequence[int], seeds: Tuple[int, int]
                ) -> Dict[str, Optional[torch.Tensor]]:
        """The teacher-forced training forward (a grouped encoder takes a
        language-interleaved batch: sample ``k*g + j`` has language j):
        ``text`` [B, T],
        ``target`` [B, F, M], ``languages`` [B] ids or [B, T, L] weights,
        ``teacher`` F flags, ``seeds`` the decoder's two uint32 seeds.
        Padded stop logits are 1000 and padded frames of the pre and post
        predictions 0.  A float32 model runs its cuDNN convolutions and
        LSTMs in full float32 (``device.exact_float32``), in train and eval
        mode; a backward outside this call needs the same guard
        (``training.trainer.train_step`` holds it)."""
        with (exact_float32() if self.dtype == torch.float32
              else contextlib.nullcontext()):
            return self._forward(text, text_lengths, target, target_lengths,
                                 speakers, languages, teacher, seeds)

    def _forward(self, text, text_lengths, target, target_lengths, speakers,
                 languages, teacher, seeds):
        langs_w = self._language_weights(languages, text.shape[1])
        encoded = self._encode(text, text_lengths, langs_w, mix=False)
        speaker_prediction = (self.classifier(encoded)
                              if self.hp.reversal_classifier else None)
        pre, stop, alignment = self.decoder(
            encoded, text_lengths, target, teacher, seeds, speakers,
            torch.argmax(langs_w, dim=2))
        post = self.postnet(pre, target_lengths).float()
        target_mask = lengths_to_mask(target_lengths, target.shape[1])
        stop = torch.where(target_mask, stop, torch.full_like(stop, 1000.0))
        pre = pre * target_mask[..., None]
        post = post * target_mask[..., None]
        return {"post_prediction": post, "pre_prediction": pre,
                "stop_token": stop, "alignment": alignment,
                "speaker_prediction": speaker_prediction,
                "encoder_output": encoded}

    @torch.no_grad()
    def encode_for_inference(
        self,
        text: torch.Tensor,                    # [B, T] int
        text_lengths: torch.Tensor,            # [B]
        speakers: Optional[torch.Tensor],      # [B]
        languages: torch.Tensor,               # [B] ids or [B, T, L]
        group_langs: Optional[torch.Tensor] = None,
    ):
        """-> (memory, memory_transform, mask, carry).  ``group_langs`` [r]
        selects a grouped encoder's row-group encode (language-sorted
        batch); without it the language weights are mixed across all
        language groups.  The other encoders take the weights either way."""
        b, t = text.shape
        langs_w = self._language_weights(languages, t)
        encoded = self._encode(text, text_lengths, langs_w,
                               mix=group_langs is None,
                               group_langs=group_langs)
        memory, mt = self.decoder.prepare_memory(
            encoded, speakers, torch.argmax(langs_w, dim=2))
        mask = lengths_to_mask(text_lengths, t)
        carry = self.decoder.initial_carry(b, t, text.device)
        return memory, mt, mask, carry

    @torch.no_grad()
    def decode_chunk(self, carry, memory, memory_transform, mask,
                     seeds: Tuple[int, int], chunk_frames: int):
        return self.decoder.decode_chunk(carry, memory, memory_transform,
                                         mask, seeds, chunk_frames)

    @torch.no_grad()
    def apply_postnet(self, pre: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, F, M] decoder frames and their [B] lengths -> [B, F, M] mels
        (the conv postnet takes no lengths) or, with ``hp.predict_linear``,
        [B, F, num_fft/2+1] linear spectrograms (the CBHG's GRU runs over
        each length), float32."""
        return self.postnet(pre, lengths).float()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@dataclass
class TacotronLossState:
    """The guided-attention schedule carried across steps."""

    guided_att_variance: float
    guided_att_steps: int
    guided_att_gamma: float

    @classmethod
    def init(cls, hp) -> "TacotronLossState":
        return cls(guided_att_variance=hp.guided_attention_toleration,
                   guided_att_steps=hp.guided_attention_steps,
                   guided_att_gamma=hp.guided_attention_gain)

    def update(self) -> "TacotronLossState":
        return TacotronLossState(
            guided_att_variance=self.guided_att_variance
            * self.guided_att_gamma,
            guided_att_steps=max(0, self.guided_att_steps - 1),
            guided_att_gamma=self.guided_att_gamma)

    def state_dict(self):
        return {"guided_att_variance": self.guided_att_variance,
                "guided_att_steps": self.guided_att_steps,
                "guided_att_gamma": self.guided_att_gamma}

    @classmethod
    def from_state_dict(cls, d):
        return cls(**d)


def shard_mean(x: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """The mean of ``x`` over all its elements, or with ``shards`` equal
    shards of a global tensor this shard's contribution to the global
    mean: the sum over ``shards`` times its element count."""
    if shards == 1:
        return torch.mean(x)
    return x.sum() / (x.numel() * shards)


def _bce_with_logits_pos_weight(logits, targets, pos_weight, shards=1):
    """``binary_cross_entropy_with_logits`` with ``pos_weight``, mean
    (``shard_mean``)."""
    log_sig = -F.softplus(-logits)
    log_one_minus = -F.softplus(logits)
    return shard_mean(-(pos_weight * targets * log_sig
                        + (1.0 - targets) * log_one_minus), shards)


def guided_attention_loss(alignments: torch.Tensor,
                          input_lengths: torch.Tensor,
                          target_lengths: torch.Tensor,
                          variance, batch: Optional[int] = None
                          ) -> torch.Tensor:
    """Diagonal-band penalty: ``W[b, f, l] = 1 - exp(-(l/L_b - f/F_b)^2 /
    (2 g^2))`` in the valid rectangle; ``mean_b sum(W * A) / F_b``, or with
    the global batch's ``batch`` rows this shard's contribution, the sum
    over its samples divided by ``batch``."""
    _, frames, tokens = alignments.shape
    dev = alignments.device
    f = torch.arange(frames, device=dev, dtype=torch.float32)[None, :, None]
    l = torch.arange(tokens, device=dev, dtype=torch.float32)[None, None, :]
    fl = target_lengths.float()[:, None, None]
    ll = input_lengths.float()[:, None, None]
    w = 1.0 - torch.exp(-((l / ll - f / fl) ** 2) / (2.0 * variance ** 2))
    w = torch.where((f < fl) & (l < ll), w, torch.zeros_like(w))
    per_sample = (w * alignments).sum((1, 2)) / torch.clamp(
        target_lengths.float(), min=1.0)
    return per_sample.mean() if batch is None else per_sample.sum() / batch


def tacotron_loss(outputs, *, hp, input_lengths, target_lengths, pre_target,
                  post_target, stop_target, speakers, guided_att_variance,
                  guided_att_active=True, classifier_kernel=None, mesh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``2 MSE(pre) + MSE(post) + stop BCE (pos_weight 100) / (M + 2)``, the
    classifier's loss times ``reversal_classifier_w / (M + 2)`` and the
    guided-attention penalty.  Means run over all elements, padding
    included.  The cosine-similarity classifier's loss needs
    ``classifier_kernel``, its ``fc.weight`` transposed [C, n_speakers]
    (``classifier_kernel(model)``).  A Python ``False`` for
    ``guided_att_active`` skips the penalty (the schedule has expired).

    With a ``mesh`` of several ranks, each holding equal shards of the
    global batch, every term is this rank's contribution to the global
    loss: the means over the global element count, the guided penalty's
    sum over the global batch, the classifier's masked sums over the valid
    characters summed over the ranks.  The ranks' contributions sum to the
    loss of the global batch (counting a row that ``replicas`` ranks share
    once), and so do their gradients."""
    shards = 1 if single(mesh) else mesh.size
    rows = None if shards == 1 else pre_target.shape[0] * shards
    losses = {
        "mel_pre": 2.0 * shard_mean(
            (outputs["pre_prediction"] - pre_target) ** 2, shards),
        "mel_pos": shard_mean(
            (outputs["post_prediction"] - post_target) ** 2, shards),
        "stop_token": _bce_with_logits_pos_weight(
            outputs["stop_token"], stop_target, 100.0, shards)
        / (hp.num_mels + 2),
    }
    if hp.reversal_classifier:
        count = positions = None
        if shards > 1:
            b, t = outputs["speaker_prediction"].shape[:2]
            count = total(lengths_to_mask(input_lengths, t).sum(), mesh)
            positions = b * t * shards
        if hp.reversal_classifier_type == "reversal":
            cls_loss = reversal_classifier_loss(
                input_lengths, speakers, outputs["speaker_prediction"],
                count)
        else:
            cls_loss = cosine_similarity_classifier_loss(
                input_lengths, speakers, outputs["speaker_prediction"],
                outputs["encoder_output"], classifier_kernel, count,
                positions)
        losses["lang_class"] = cls_loss * (
            hp.reversal_classifier_w / (hp.num_mels + 2))
    if hp.guided_attention_loss:
        if (isinstance(guided_att_active, (bool, int))
                and not guided_att_active):
            losses["guided_att"] = torch.zeros(
                (), device=pre_target.device)
        else:
            losses["guided_att"] = guided_attention_loss(
                outputs["alignment"], input_lengths, target_lengths,
                guided_att_variance, rows) * guided_att_active
    return sum(losses.values()), losses


def classifier_kernel(model: Tacotron) -> Optional[torch.Tensor]:
    """The cosine-similarity classifier's ``fc`` weight as the loss's
    kernel [C, n_speakers] (the gradient flows into the weight through
    it), None for any other model."""
    hp = model.hp
    if hp.reversal_classifier and hp.reversal_classifier_type == "cosine":
        return model.classifier.fc.weight.t()
    return None


@torch.no_grad()
def init_random_weights(model: Tacotron, seed: int) -> Tacotron:
    """Seeded random weights that keep activations near unit scale, for
    runs without a trained checkpoint.  Dense and conv weights are normal
    with variance 1/fan-in and zero biases; a generated conv's kernel
    generator is scaled so that the generated kernel has variance
    1/(k*cin), and a generated batch norm's affine starts near (1, 0).
    PyTorch's default init would let the 14 generated blocks of the encoder
    grow the activations by orders of magnitude.  An LSTM's weights and
    trained biases are uniform in +-1/sqrt(units), PyTorch's default,
    drawn from the seed; its frozen second biases are zero.  A GRU's
    weights and biases are uniform in the same bound, the r and z thirds
    of its ``bias_hh`` zero."""
    gen = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, var: float) -> None:
        t.copy_(torch.randn(t.shape, generator=gen) * var ** 0.5)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 1.0 / m.in_features)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            normal_(m.weight, 1.0 / (m.in_channels // m.groups
                                     * m.kernel_size[0]))
        elif isinstance(m, nn.LSTM):
            bound = m.hidden_size ** -0.5
            for p in m.parameters():
                p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0)
                        * bound if p.requires_grad else 0.0)
        elif isinstance(m, nn.GRU):
            bound = m.hidden_size ** -0.5
            for name, p in m.named_parameters():
                p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0)
                        * bound)
                if name.startswith("bias_hh"):
                    p[:2 * m.hidden_size] = 0.0
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0)
        elif isinstance(m, LocationSensitiveAttention):
            normal_(m.query_kernel, 1.0 / m.query_kernel.shape[0])
            normal_(m.loc_filter, 1.0 / m.loc_filter.shape[0])
            normal_(m.location_kernel, 1.0 / m.location_kernel.shape[0])
            normal_(m.energy_kernel, 1.0 / m.energy_kernel.shape[0])
            m.bias.zero_()
    for m in model.modules():           # after the generic pass above
        if isinstance(m, Conv1dGenerated):
            normal_(m.kernel.weight,
                    1.0 / (m.kernel.in_features * m.k * m.cin))
        elif isinstance(m, BatchNorm1dGenerated):
            normal_(m.affine.weight, 0.01 / m.affine.in_features)
            m.affine.bias.copy_(torch.cat([torch.ones(m.c),
                                           torch.zeros(m.c)]))
    return model
