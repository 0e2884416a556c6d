"""The training runtime: one step, the epoch loop, evaluation and
checkpoints.

Port of the JAX package's ``training/trainer.py``: ``make_optimizer``
(global-norm clipping, then Adam with the L2 weight decay folded into the
gradient, then the step-decay learning rate, with an encoder learning-rate
group when ``hp.encoder_optimizer`` is set), ``Trainer._train_step_impl``
as ``train_step``, the classifier accuracy, and ``Trainer``: the samplers,
``train_epoch`` over ``train_step`` with the metrics logger and a
``torch.profiler`` trace, ``evaluate`` (the teacher-forced and the
free-running pass in ``model.eval()``, DTW-MCD, the classifier accuracy and
a Griffin-Lim render of one sample), ``save`` and ``fit``, and the resume
from a checkpoint of either package (``interop.optax_state`` maps the Adam
state).

Data parallel (``Trainer(mesh=)``, ``parallel.make_mesh``): every rank
collates the global batch and runs the model on its rows; the batch
statistics and the loss denominators are the global batch's, each rank's
loss is its contribution to the global loss, and the gradients are summed
over the ranks before clipping, so that a step equals the single-device
step on the global batch, as the JAX package's SPMD step does.  Only rank 0
logs and writes checkpoints.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multilingual_text_to_speech_tpu_torch.data.batching import (  # noqa: F401
    Batch,
    Collate,
    batch_iterator,
)
from multilingual_text_to_speech_tpu_torch.data.prefetch import prefetch
from multilingual_text_to_speech_tpu_torch.data.sampling import (
    BalancedBatchSampler,
    PerfectBatchSampler,
    SimpleBatchSampler,
)
from multilingual_text_to_speech_tpu_torch.device import (
    DeviceLike,
    exact_float32,
    resolve_device,
)
from multilingual_text_to_speech_tpu_torch.interop.optax_state import (
    optimizer_from_optax,
    optimizer_to_optax,
)
from multilingual_text_to_speech_tpu_torch.models.tacotron import (
    Tacotron,
    TacotronLossState,
    classifier_kernel,
    init_random_weights,
    lengths_to_mask,
    tacotron_loss,
)
from multilingual_text_to_speech_tpu_torch.ops import audio as audio_ops
from multilingual_text_to_speech_tpu_torch.ops.fused_decoder import (
    draw_seeds,
)
from multilingual_text_to_speech_tpu_torch.parallel import (
    all_gather_rows,
    all_reduce_gradients,
    make_mesh,
    replicate,
    shard_batch,
    shard_seeds,
    total,
)
from multilingual_text_to_speech_tpu_torch.parallel.collectives import (
    barrier,
    single,
)
from multilingual_text_to_speech_tpu_torch.training.checkpoint import (
    load_checkpoint,
    restore,
    save_checkpoint,
)
from multilingual_text_to_speech_tpu_torch.training.logging import (
    MetricsLogger,
)
from multilingual_text_to_speech_tpu_torch.training.schedule import (
    step_decay_schedule,
    teacher_forcing_ratio,
)


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
                        lengths: torch.Tensor, mesh=None) -> torch.Tensor:
    """Masked per-character speaker accuracy; with a ``mesh`` of several
    ranks this rank's contribution (its matches over the valid characters
    of all ranks)."""
    pred = torch.argmax(speaker_prediction, dim=-1)
    mask = lengths_to_mask(lengths, pred.shape[1])
    matches = (pred == speakers.long()[:, None]) & mask
    return matches.sum() / torch.clamp(total(mask.sum(), mesh), min=1)


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
    ``device.exact_float32``.

    A model with a mesh of several ranks (``Tacotron(mesh=)``) takes this
    rank's rows of the global batch, and ``seeds`` its shard's: the loss
    terms are the rank's contributions, the gradients are summed over the
    ranks (``parallel.all_reduce_gradients``) before the clipping, and the
    returned losses and accuracy are the sums over the ranks, the global
    batch's."""
    hp = model.hp
    mesh = model.mesh
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
        loss, losses = tacotron_loss(
            out, hp=hp, input_lengths=text_lengths,
            target_lengths=mel_lengths, pre_target=mels,
            post_target=post_target,
            stop_target=_on(dev, batch.stop_tokens, torch.float32),
            speakers=speakers,
            guided_att_variance=loss_state.guided_att_variance,
            guided_att_active=loss_state.guided_att_steps > 0,
            classifier_kernel=classifier_kernel(model), mesh=mesh)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    params: List[torch.Tensor] = [p for g in optimizer.param_groups
                                  for p in g["params"]]
    all_reduce_gradients(params, mesh)
    grad_norm = clip_grad_global_norm_(params, hp.gradient_clipping)
    optimizer.step()
    scheduler.step()
    acc = (classifier_accuracy(out["speaker_prediction"], speakers,
                               text_lengths, mesh)
           if hp.reversal_classifier else torch.zeros((), device=dev))
    losses = {k: v.detach() for k, v in losses.items()}
    if not single(mesh):
        summed = total(torch.stack([*losses.values(), acc.float()]), mesh)
        losses, acc = dict(zip(losses, summed[:-1])), summed[-1]
    return StepResult(losses, grad_norm, acc, loss_state.update())


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------

class Draws:
    """The trainer's random choices, from a CPU ``torch.Generator`` of its
    seed: each training step's F teacher-forcing flags (Bernoulli at the
    step's ratio) and decoder seeds, the evaluation passes' seeds, and the
    sample that ``evaluate`` logs, drawn in the same order on every rank;
    with several ranks, each data shard's decoder seeds
    (``shard_seeds``).  An object with the same four methods can stand in
    (the tests replay the JAX package's draws)."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def train(self, frames: int, ratio: float
              ) -> Tuple[List[int], Tuple[int, int]]:
        teacher = (torch.rand(frames, generator=self.generator)
                   < ratio).int().tolist()
        return teacher, draw_seeds(self.generator)

    def eval(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """The seeds of the teacher-forced pass and of the free-running
        pass (their flags are all 1 and all 0)."""
        return draw_seeds(self.generator), draw_seeds(self.generator)

    def pick(self, n: int) -> int:
        return int(torch.randint(n, (1,), generator=self.generator))

    def shard_seeds(self, seeds: Tuple[int, int], index: int
                    ) -> Tuple[int, int]:
        """The decoder seeds of shard ``index`` of a step or pass whose
        seeds are ``seeds`` (where JAX folds the shard index into the
        decode key)."""
        return shard_seeds(seeds, index)


def _criterion(payload) -> TacotronLossState:
    c = payload["criterion"]
    return TacotronLossState(
        guided_att_variance=float(c["guided_att_variance"]),
        guided_att_steps=int(c["guided_att_steps"]),
        guided_att_gamma=float(c["guided_att_gamma"]))


class Trainer:
    """The training loop: ``fit`` runs ``train_epoch``,
    ``evaluate`` and, every ``hp.checkpoint_each_epochs``, ``save``.

    The model and its optimizer live on ``device``, the card unless the
    caller passes ``"cpu"`` (raising without a card).  As in the JAX
    package, ``hp`` is completed from the training set (speaker count,
    language count, speaker list and normalization constants) unless the
    run resumes ``from_checkpoint``, which restores the weights (partially,
    by path and shape), the epoch (the saved one + 1), the step, the
    guided-attention state and the Adam state; an optimizer section that
    does not match the model is reported and training goes on with fresh
    moments.  The weights start from ``initial_state`` (a state dict) when
    given, else from ``init_random_weights(seed)``; ``draws`` replaces the
    trainer's ``Draws(seed)``.

    With a ``mesh`` of several ranks (one ``Trainer`` a rank, on the
    mesh's device; ``hp.batch_size`` is the global batch), the ranks start
    from rank 0's weights (``parallel.replicate``) and resume from the
    same checkpoint, the samplers keep each data shard's rows
    language-balanced, the dropout outside the decoder draws from a
    generator seeded by the shard, and only rank 0 keeps the logger and
    writes checkpoints."""

    def __init__(self, hp, dataset_collection, *,
                 checkpoint_dir: Optional[str] = None,
                 log_dir: Optional[str] = None, seed: int = 42,
                 device: DeviceLike = None,
                 from_checkpoint: Optional[str] = None,
                 flush_seconds: int = 60,
                 initial_state: Optional[Dict[str, torch.Tensor]] = None,
                 draws=None, mesh=None):
        self.hp = hp
        self.data = dataset_collection
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            hp, device=self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {self.mesh.device}, "
                             f"the trainer on {self.device}")
        # the global batch must split over the ranks (raises otherwise)
        self.mesh.shard_rows(hp.batch_size)

        # dataset-dependent hp mutation (reference: train.py:238-250)
        hp.speaker_number = (
            dataset_collection.train.get_num_speakers() if hp.multi_speaker
            else 0)
        hp.language_number = len(hp.languages) if hp.multi_language else 0
        if hp.multi_speaker and not from_checkpoint:
            hp.unique_speakers = list(dataset_collection.train.unique_speakers)
        if not from_checkpoint and hp.normalize_spectrogram:
            if hp.mel_normalization() is None:
                train_ds = dataset_collection.train
                mean, var = train_ds.get_normalization_constants(True)
                hp.mel_normalize_mean, hp.mel_normalize_variance = mean, var
                if hp.predict_linear:
                    mean, var = train_ds.get_normalization_constants(False)
                    hp.lin_normalize_mean, hp.lin_normalize_variance = (
                        mean, var)

        dtype = (torch.bfloat16 if hp.compute_dtype == "bfloat16"
                 else torch.float32)
        model = Tacotron(hp, dtype, mesh=self.mesh)
        if initial_state is not None:
            model.load_state_dict(initial_state, strict=True)
        else:
            init_random_weights(model, seed)
        self.loss_state = TacotronLossState.init(hp)
        self.epoch = 0
        self.step = 0
        payload = None
        if from_checkpoint:
            payload = load_checkpoint(from_checkpoint)
            restore(payload, model, hp, partial=True)
            self.epoch = int(payload["epoch"]) + 1
            self.step = int(payload["step"])
            self.loss_state = _criterion(payload)
        self.model = replicate(model.to(self.device), self.mesh)
        if not single(self.mesh):
            # the encoder's and postnet's dropout masks differ by shard
            index = self.mesh.seed_index(hp.batch_size)
            torch.manual_seed(shard_seeds((seed, 0), index)[0])
        self.optimizer, self.scheduler = make_optimizer(self.model, hp)
        if payload is not None:
            try:
                optimizer_from_optax(payload["optimizer"], self.model,
                                     self.optimizer, self.scheduler, hp)
            except (ValueError, KeyError, TypeError) as e:
                # expected when fine-tuning a changed architecture
                print("WARNING: optimizer state in checkpoint does not match "
                      f"the current model ({e}); starting with fresh Adam "
                      "moments.", flush=True)

        self.draws = draws if draws is not None else Draws(seed)
        self.collate = Collate(hp)
        self._make_samplers(seed)
        self._lr_schedule = step_decay_schedule(hp)
        # seconds of the last evaluate() by part (forced and free-running
        # passes, DTW-MCD, Griffin-Lim render)
        self.eval_seconds: Dict[str, float] = {}

        # every rank draws the logged sample; rank 0 logs it
        self._logging = log_dir is not None
        self.logger = None
        if log_dir is not None and self.mesh.rank == 0:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
            self.logger = MetricsLogger(
                os.path.join(log_dir, f"{hp.version}-{stamp}"),
                flush_seconds=flush_seconds)
        self.checkpoint_dir = checkpoint_dir
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    # -- data ------------------------------------------------------------------

    def _make_samplers(self, seed: int):
        hp = self.hp
        train_langs = [it["language"] for it in self.data.train.items]
        dev_langs = [it["language"] for it in self.data.dev.items]
        dp = self.mesh.data
        if hp.multi_language and hp.balanced_sampling and hp.perfect_sampling:
            self.train_sampler = PerfectBatchSampler(
                train_langs, len(hp.languages), hp.batch_size,
                data_parallel_shards=dp, shuffle=True, drop_last=True,
                seed=seed)
            self.eval_sampler = PerfectBatchSampler(
                dev_langs, len(hp.languages), hp.batch_size,
                data_parallel_shards=dp, shuffle=False, drop_last=False,
                seed=seed)
        elif hp.multi_language and hp.balanced_sampling:
            self.train_sampler = BalancedBatchSampler(
                train_langs, hp.batch_size, drop_last=True, seed=seed)
            self.eval_sampler = SimpleBatchSampler(
                len(self.data.dev), hp.batch_size, shuffle=False,
                drop_last=False, seed=seed)
        else:
            self.train_sampler = SimpleBatchSampler(
                len(self.data.train), hp.batch_size, shuffle=True,
                drop_last=True, seed=seed)
            self.eval_sampler = SimpleBatchSampler(
                len(self.data.dev), hp.batch_size, shuffle=False,
                drop_last=False, seed=seed)

    def _train_batches(self):
        """The epoch's collated batches, prefetched by one thread."""
        return prefetch(batch_iterator(self.data.train, self.train_sampler,
                                       self.collate), depth=2)

    def _eval_batches(self):
        return batch_iterator(self.data.dev, self.eval_sampler, self.collate)

    def _shard_seeds(self, seeds, batch: Batch):
        """This rank's decoder seeds for the global ``batch``: the step's
        own on a mesh of one."""
        index = self.mesh.seed_index(len(batch.utterances))
        return seeds if index is None else self.draws.shard_seeds(seeds,
                                                                  index)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- epochs ------------------------------------------------------------------

    def train_epoch(self, logging_start_epoch: int = 0,
                    profile_steps: int = 0,
                    profile_dir: Optional[str] = None,
                    max_steps: Optional[int] = None) -> int:
        """One training epoch (reference: train.py:29-95), or its first
        ``max_steps`` steps; returns the steps run.  With ``profile_steps >
        0`` a ``torch.profiler`` trace of that many steps is written to
        ``profile_dir/trace.json``."""
        hp = self.hp
        steps = 0
        t0 = time.time()
        prof = None
        for batch in self._train_batches():
            if profile_steps and steps == 0:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
            step = self.step
            teacher, seeds = self.draws.train(
                batch.mel_spectrograms.shape[1],
                teacher_forcing_ratio(hp, step))
            res = train_step(self.model, self.optimizer, self.scheduler,
                             shard_batch(batch, self.mesh), self.loss_state,
                             None, teacher=teacher,
                             seeds=self._shard_seeds(seeds, batch),
                             device=self.device)
            self.step += 1
            if self.logger is not None and self.epoch >= logging_start_epoch:
                self.logger.training(
                    step, {k: float(v) for k, v in res.losses.items()},
                    float(res.grad_norm), float(self._lr_schedule(step)),
                    time.time() - t0, float(res.accuracy))
            self.loss_state = res.loss_state
            t0 = time.time()
            steps += 1
            if prof is not None and steps >= profile_steps:
                self._stop_profile(prof, profile_dir)
                prof = None
            if steps == max_steps:
                break
        if prof is not None:
            self._stop_profile(prof, profile_dir)
        return steps

    def _stop_profile(self, prof, profile_dir: Optional[str]) -> None:
        self._sync()
        prof.__exit__(None, None, None)
        out = profile_dir or os.path.join(
            self.logger.log_dir if self.logger else ".", "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    def _inputs(self, batch: Batch):
        dev = self.device
        return (_on(dev, batch.utterances, torch.long),
                _on(dev, batch.utterance_lengths, torch.long),
                _on(dev, batch.mel_spectrograms, torch.float32),
                _on(dev, batch.spectrogram_lengths, torch.long),
                _on(dev, batch.speakers, torch.long),
                _on(dev, batch.languages, torch.long))

    @torch.no_grad()
    def evaluate(self) -> float:
        """Eval epoch (reference: train.py:98-170): per batch, the
        teacher-forced pass (its loss and classifier accuracy) and the
        free-running pass, both in ``model.eval()``; each free-running
        prediction cut ``hp.stop_frames`` after its first stop and scored
        by DTW-MCD against its target; with a logger, one random sample's
        spectrograms and alignment logged and both passes' predictions
        rendered by Griffin-Lim on the device.  Returns the summed mean
        eval loss; ``eval_seconds`` holds the parts' seconds.  With
        several ranks each runs both passes on its rows; the losses and
        accuracy are summed over the ranks and the free-running outputs
        gathered, so every rank scores the whole batch and returns the same
        eval loss."""
        hp = self.hp
        eval_losses: Dict[str, float] = {}
        mcd, mcd_count = 0.0, 0
        cla, cla_count = 0.0, 0
        n_batches = 0
        last = None
        seconds = dict(forced=0.0, free=0.0, mcd=0.0, render=0.0)
        ga_active = self.loss_state.guided_att_steps > 0
        is_mel = not hp.predict_linear

        self.model.eval()
        mesh = self.mesh
        for batch in self._eval_batches():
            frames = batch.mel_spectrograms.shape[1]
            n = len(batch.utterances)
            seeds_forced, seeds_free = (self._shard_seeds(s, batch)
                                        for s in self.draws.eval())
            rows = shard_batch(batch, mesh)
            text, text_len, mels, mel_len, speakers, languages = (
                self._inputs(rows))
            t0 = time.perf_counter()
            out_forced = self.model(text, text_len, mels, mel_len, speakers,
                                    languages, [1] * frames, seeds_forced)
            post_target = (mels if rows.linear_spectrograms is None else
                           _on(self.device, rows.linear_spectrograms,
                               torch.float32))
            _, losses = tacotron_loss(
                out_forced, hp=hp, input_lengths=text_len,
                target_lengths=mel_len, pre_target=mels,
                post_target=post_target,
                stop_target=_on(self.device, rows.stop_tokens,
                                torch.float32),
                speakers=speakers,
                guided_att_variance=self.loss_state.guided_att_variance,
                guided_att_active=ga_active,
                classifier_kernel=classifier_kernel(self.model), mesh=mesh)
            acc = (classifier_accuracy(out_forced["speaker_prediction"],
                                       speakers, text_len, mesh)
                   if hp.reversal_classifier
                   else torch.zeros((), device=self.device))
            values = total(torch.stack([*(v.float() for v in
                                          losses.values()), acc.float()]),
                           mesh).tolist()
            losses, acc = dict(zip(losses, values[:-1])), values[-1]
            t1 = time.perf_counter()
            out_free = self.model(text, text_len, mels, mel_len, speakers,
                                  languages, [0] * frames, seeds_free)
            post_free = all_gather_rows(
                out_free["post_prediction"].float(), mesh, n).cpu().numpy()
            stop_probs = torch.sigmoid(all_gather_rows(
                out_free["stop_token"].float(), mesh, n)).cpu().numpy()
            t2 = time.perf_counter()

            for j in range(post_free.shape[0]):
                gen = post_free[j].T       # [bins, F]
                ref = np.asarray(batch.mel_spectrograms[j]).T
                stop_idx = np.where(stop_probs[j] > 0.5)[0]
                cut = (min(int(stop_idx.min()) + hp.stop_frames, gen.shape[1])
                       if len(stop_idx) else gen.shape[1])
                gen = gen[:, :cut]
                ref = ref[:, :int(batch.spectrogram_lengths[j])]
                if hp.normalize_spectrogram:
                    gen = audio_ops.denormalize_spectrogram(gen, hp, is_mel)
                    ref = audio_ops.denormalize_spectrogram(ref, hp, True)
                if hp.predict_linear:
                    gen = audio_ops.linear_to_mel(gen, hp, self.device)
                mcd = (mcd_count * mcd + audio_ops.mel_cepstral_distortion(
                    gen, ref, hp, "dtw", device=self.device)) / (mcd_count + 1)
                mcd_count += 1
            t3 = time.perf_counter()
            seconds["forced"] += t1 - t0
            seconds["free"] += t2 - t1
            seconds["mcd"] += t3 - t2

            if hp.reversal_classifier:
                cla = (cla_count * cla + acc) / (cla_count + 1)
                cla_count += 1
            for k, v in losses.items():
                eval_losses[k] = eval_losses.get(k, 0.0) + v
            n_batches += 1
            last = (batch, out_forced["post_prediction"], post_free,
                    out_free["alignment"], stop_probs)

        for k in eval_losses:
            eval_losses[k] /= max(n_batches, 1)

        if self._logging and last is not None:
            batch, forced, post_free, alignment, stop_probs = last
            n = len(batch.utterances)
            # collectives and the draw on every rank; rank 0 logs
            forced = all_gather_rows(forced.float(), mesh, n)
            alignment = all_gather_rows(alignment.float(), mesh, n)
            idx = self.draws.pick(n)
            if self.logger is not None:
                t0 = time.perf_counter()
                self._log_sample(eval_losses, mcd, cla, idx, batch, forced,
                                 post_free, alignment, stop_probs)
                seconds["render"] = time.perf_counter() - t0
        self.eval_seconds = seconds
        return float(sum(eval_losses.values()))

    def _log_sample(self, eval_losses, mcd, cla, idx, batch, forced,
                    free_np, alignment, stop_probs):
        """Eval sample ``idx`` to the logger: the target, generated and
        teacher-forced spectrograms (denormalized, cropped to the target's
        length), its alignment, stop probabilities and both predictions
        rendered by Griffin-Lim on the device (reference:
        utils/logging.py:101-119)."""
        from multilingual_text_to_speech_tpu_torch.text import SymbolTable

        hp = self.hp
        f_len = int(batch.spectrogram_lengths[idx])
        s_len = int(batch.utterance_lengths[idx])
        source_text = SymbolTable(hp).decode(
            np.asarray(batch.utterances[idx]))
        is_mel = not hp.predict_linear
        gen = free_np[idx][:f_len].T
        forced = forced[idx, :f_len].float().cpu().numpy().T
        target = np.asarray(batch.mel_spectrograms[idx][:f_len]).T
        if hp.normalize_spectrogram:
            gen = audio_ops.denormalize_spectrogram(gen, hp, is_mel)
            forced = audio_ops.denormalize_spectrogram(forced, hp, is_mel)
            target = audio_ops.denormalize_spectrogram(target, hp, True)
        audio_generated = audio_ops.inverse_spectrogram(
            gen, hp, mel=is_mel, device=self.device)
        audio_forced = audio_ops.inverse_spectrogram(
            forced, hp, mel=is_mel, device=self.device)
        self.logger.evaluation(
            self.epoch + 1, eval_losses, mcd, cla,
            alignment=alignment[idx, :f_len, :s_len].float().cpu().numpy(),
            target_spec=target.T, predicted_spec=gen.T, forced_spec=forced.T,
            stop_probs=stop_probs[idx],
            stop_target=np.asarray(batch.stop_tokens[idx]),
            audio_generated=audio_generated, audio_forced=audio_forced,
            source_text=source_text, sample_rate=hp.sample_rate)

    def save(self, eval_loss: float) -> str:
        """Write the checkpoint (weights, Adam state as optax's, step,
        epoch, hp, guided-attention state); returns its path.  With
        several ranks, rank 0 writes it and every rank returns once it is
        written."""
        path = os.path.join(
            self.checkpoint_dir,
            f"{self.hp.version}_loss-{self.epoch}-{eval_loss:2.3f}")
        if self.mesh.rank == 0:
            save_checkpoint(
                path, epoch=self.epoch, step=self.step,
                state_dict=self.model.state_dict(), hp=self.hp,
                criterion_state=self.loss_state.state_dict(),
                optimizer=optimizer_to_optax(self.model, self.optimizer,
                                             self.scheduler, self.hp))
        barrier(self.mesh)
        return path

    def fit(self, epochs: Optional[int] = None,
            logging_start_epoch: int = 0) -> float:
        """The training loop (reference: train.py:292-310); returns the best
        eval loss."""
        hp = self.hp
        epochs = epochs if epochs is not None else hp.epochs
        best_eval = float("inf")
        while self.epoch < epochs:
            self.train_epoch(logging_start_epoch)
            eval_loss = self.evaluate()
            best_eval = min(best_eval, eval_loss)
            if (self.checkpoint_dir
                    and (self.epoch + 1) % hp.checkpoint_each_epochs == 0):
                self.save(eval_loss)
            self.epoch += 1
        return best_eval
