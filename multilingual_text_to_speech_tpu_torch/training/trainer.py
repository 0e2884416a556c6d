"""One training step, for every encoder the port builds.

Port of the step machinery of the JAX package's ``training/trainer.py``:
``make_optimizer`` (global-norm clipping, then Adam with the L2 weight
decay folded into the gradient, then the step-decay learning rate, with an
encoder learning-rate group when ``hp.encoder_optimizer`` is set),
``Trainer._train_step_impl`` as ``train_step``, and the classifier
accuracy.  The epoch loop, evaluation and checkpoints are not ported.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multilingual_text_to_speech_tpu_torch.device import (
    DeviceLike,
    exact_float32,
    resolve_device,
)
from multilingual_text_to_speech_tpu_torch.models.tacotron import (
    TacotronLossState,
    lengths_to_mask,
    tacotron_loss,
)
from multilingual_text_to_speech_tpu_torch.ops.fused_decoder import (
    draw_seeds,
)
from multilingual_text_to_speech_tpu_torch.training.schedule import (
    step_decay_schedule,
    teacher_forcing_ratio,
)


class Batch(NamedTuple):
    """One padded training batch (channels-last spectrograms); a copy of
    the JAX package's ``data/batching.py::Batch``."""

    utterances: np.ndarray            # [B, T] int32
    utterance_lengths: np.ndarray     # [B] int32
    mel_spectrograms: np.ndarray      # [B, F, num_mels] float32
    linear_spectrograms: Optional[np.ndarray]  # [B, F, bins] or None
    spectrogram_lengths: np.ndarray   # [B] int32
    stop_tokens: np.ndarray           # [B, F] float32
    speakers: Optional[np.ndarray]    # [B] int32 or None
    languages: Optional[np.ndarray]   # [B] int32 or None


class StepResult(NamedTuple):
    losses: Dict[str, torch.Tensor]
    grad_norm: torch.Tensor           # before clipping
    accuracy: torch.Tensor            # 0 without the classifier
    loss_state: TacotronLossState     # advanced by one step


def make_optimizer(model: torch.nn.Module, hp):
    """``(optimizer, scheduler)``: Adam (eps 1e-8, L2 weight decay added to
    the gradient) whose learning rate follows ``step_decay_schedule``; the
    encoder's parameters form their own group at
    ``hp.learning_rate_encoder`` when ``hp.encoder_optimizer`` is set.
    Clip the gradients with ``clip_grad_global_norm_`` before
    ``optimizer.step()``, and call ``scheduler.step()`` after it."""
    if hp.encoder_optimizer:
        enc = [p for n, p in model.named_parameters()
               if n.startswith("encoder.")]
        rest = [p for n, p in model.named_parameters()
                if not n.startswith("encoder.")]
        groups = [{"params": enc, "lr": hp.learning_rate_encoder},
                  {"params": rest, "lr": hp.learning_rate}]
    else:
        groups = [{"params": list(model.parameters()),
                   "lr": hp.learning_rate}]
    opt = torch.optim.Adam(groups, lr=hp.learning_rate, eps=1e-8,
                           weight_decay=hp.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_decay_schedule(hp, lr0=1.0))
    return opt, sched


@torch.no_grad()
def clip_grad_global_norm_(params: Sequence[torch.Tensor],
                           max_norm: float) -> torch.Tensor:
    """Scale the gradients to a global norm of at most ``max_norm`` as
    ``optax.clip_by_global_norm`` does (``g / norm * max_norm`` once the
    norm reaches ``max_norm``); returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def classifier_accuracy(speaker_prediction: torch.Tensor,
                        speakers: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Masked per-character speaker accuracy."""
    pred = torch.argmax(speaker_prediction, dim=-1)
    mask = lengths_to_mask(lengths, pred.shape[1])
    matches = (pred == speakers.long()[:, None]) & mask
    return matches.sum() / torch.clamp(mask.sum(), min=1)


def _on(device, x, dtype=None):
    if x is None:
        return None
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def _check_model_device(model: torch.nn.Module, dev: torch.device) -> None:
    """Raise unless every parameter and buffer of ``model`` lies on
    ``dev``: the step never trains where the caller did not ask."""
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(
                f"train_step runs on {dev}, but the model's {name} lies on "
                f"{t.device}; move the model there with model.to({str(dev)!r})"
                f" before make_optimizer, or pass device={str(t.device)!r}")


def train_step(model, optimizer, scheduler, batch: Batch,
               loss_state: TacotronLossState, generator: torch.Generator, *,
               teacher: Optional[Sequence[int]] = None,
               seeds: Optional[Tuple[int, int]] = None,
               device: DeviceLike = None) -> StepResult:
    """One step: the train-mode forward (which moves the batch-norm running
    statistics), ``tacotron_loss`` and its backward, global-norm clipping
    at ``hp.gradient_clipping``, Adam and the learning-rate schedule.

    The F teacher-forcing flags (Bernoulli at ``teacher_forcing_ratio`` of
    the scheduler's step) and the decoder's two uint32 seeds are drawn from
    ``generator`` unless ``teacher`` and ``seeds`` are given.  The step runs
    on ``device``, ``cuda`` unless the caller passes ``'cpu'`` (raising
    without a card); the model must already lie there, and the batch's
    arrays move there.  A grouped encoder (``convolutional``,
    ``generated``) needs a language-interleaved batch (sample ``k*g + j``
    has language j); the others take any order.  A float32 model
    (``hp.compute_dtype``) runs its forward, loss and backward in
    ``device.exact_float32``."""
    hp = model.hp
    dev = resolve_device(device)
    _check_model_device(model, dev)
    frames = batch.mel_spectrograms.shape[1]
    if teacher is None:
        ratio = teacher_forcing_ratio(hp, scheduler.last_epoch)
        teacher = (torch.rand(frames, generator=generator) < ratio).tolist()
    if seeds is None:
        seeds = draw_seeds(generator)
    text = _on(dev, batch.utterances, torch.long)
    text_lengths = _on(dev, batch.utterance_lengths, torch.long)
    mels = _on(dev, batch.mel_spectrograms, torch.float32)
    mel_lengths = _on(dev, batch.spectrogram_lengths, torch.long)
    speakers = _on(dev, batch.speakers, torch.long)
    languages = _on(dev, batch.languages, torch.long)
    post_target = (mels if batch.linear_spectrograms is None
                   else _on(dev, batch.linear_spectrograms, torch.float32))

    model.train()
    # a float32 model's convolutions and LSTMs run in full float32 through
    # cuDNN, forward and backward, not in PyTorch's default TF32
    with (exact_float32() if model.dtype == torch.float32
          else contextlib.nullcontext()):
        out = model(text, text_lengths, mels, mel_lengths, speakers,
                    languages, [int(t) for t in teacher], seeds)
        total, losses = tacotron_loss(
            out, hp=hp, input_lengths=text_lengths,
            target_lengths=mel_lengths, pre_target=mels,
            post_target=post_target,
            stop_target=_on(dev, batch.stop_tokens, torch.float32),
            speakers=speakers,
            guided_att_variance=loss_state.guided_att_variance,
            guided_att_active=loss_state.guided_att_steps > 0)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
    params: List[torch.Tensor] = [p for g in optimizer.param_groups
                                  for p in g["params"]]
    grad_norm = clip_grad_global_norm_(params, hp.gradient_clipping)
    optimizer.step()
    scheduler.step()
    acc = (classifier_accuracy(out["speaker_prediction"], speakers,
                               text_lengths)
           if hp.reversal_classifier else torch.zeros((), device=dev))
    return StepResult({k: v.detach() for k, v in losses.items()}, grad_norm,
                      acc, loss_state.update())
