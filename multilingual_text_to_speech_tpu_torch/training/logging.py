"""Training metrics: JSONL always, TensorBoard when available, matplotlib
figures for alignments/spectrograms/stop tokens.

A copy of the JAX package's ``training/logging.py``: the same
``metrics.jsonl`` records and keys, per-step train scalars (losses, grad
norm, lr, duration, classifier accuracy) and per-epoch eval artifacts
(losses, MCD, alignment/spectrogram figures, Griffin-Lim audio).
TensorBoard and matplotlib stay optional."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    """Writes train/eval metrics; degrades gracefully without TB/matplotlib."""

    def __init__(self, log_dir: str, flush_seconds: int = 60):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                           encoding="utf-8")
        self._flush_seconds = flush_seconds
        self._last_flush = time.time()
        self._tb = None
        try:  # TensorBoard writer is optional
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir, flush_secs=flush_seconds)
        except Exception:
            pass

    # -- scalars ------------------------------------------------------------

    def _scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def training(self, step: int, losses: Dict[str, float], gradient: float,
                 lr: float, duration: float, classifier_acc: float = 0.0):
        """Per-step train logging (reference: utils/logging.py:42-72)."""
        total = float(sum(losses.values()))
        rec = {
            "kind": "train", "step": step, "total_loss": total,
            "gradient_norm": float(gradient), "lr": float(lr),
            "duration": float(duration),
        }
        for k, v in losses.items():
            rec[f"loss_{k}"] = float(v)
        if classifier_acc:
            rec["classifier_acc"] = float(classifier_acc)
        self._jsonl.write(json.dumps(rec) + "\n")
        # periodic flush so a mid-epoch crash (the auto-resume case) keeps
        # the epoch's train metrics on disk
        now = time.time()
        if now - self._last_flush >= self._flush_seconds:
            self._jsonl.flush()
            self._last_flush = now

        self._scalar("Train/loss_total", total, step)
        for k, v in losses.items():
            self._scalar(f"Train/loss_{k}", float(v), step)
        self._scalar("Train/gradient_norm", float(gradient), step)
        self._scalar("Train/learning_rate", float(lr), step)
        self._scalar("Train/duration", float(duration), step)
        if classifier_acc:
            self._scalar("Train/classifier", float(classifier_acc), step)

    def evaluation(self, epoch: int, losses: Dict[str, float], mcd: float,
                   classifier_acc: float = 0.0,
                   alignment: Optional[np.ndarray] = None,
                   target_spec: Optional[np.ndarray] = None,
                   predicted_spec: Optional[np.ndarray] = None,
                   forced_spec: Optional[np.ndarray] = None,
                   stop_probs: Optional[np.ndarray] = None,
                   stop_target: Optional[np.ndarray] = None,
                   audio_generated: Optional[np.ndarray] = None,
                   audio_forced: Optional[np.ndarray] = None,
                   source_text: Optional[str] = None,
                   sample_rate: int = 22050):
        """Per-epoch eval logging (reference: utils/logging.py:74-137)."""
        rec = {
            "kind": "eval", "epoch": epoch, "mcd": float(mcd),
            "total_loss": float(sum(losses.values())),
        }
        if source_text is not None:
            rec["source_text"] = source_text
        for k, v in losses.items():
            rec[f"loss_{k}"] = float(v)
        if classifier_acc:
            rec["classifier_acc"] = float(classifier_acc)
        if audio_generated is not None:
            rec["audio_generated_samples"] = int(np.size(audio_generated))
        if audio_forced is not None:
            rec["audio_forced_samples"] = int(np.size(audio_forced))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self._last_flush = time.time()

        self._scalar("Eval/loss_total", rec["total_loss"], epoch)
        for k, v in losses.items():
            self._scalar(f"Eval/loss_{k}", float(v), epoch)
        self._scalar("Eval/mcd", float(mcd), epoch)
        if classifier_acc:
            self._scalar("Eval/classifier", float(classifier_acc), epoch)

        if self._tb is not None:
            try:
                if alignment is not None:
                    self._tb.add_figure(
                        "Eval/alignment", _plot_matrix(alignment.T, "alignment"),
                        epoch,
                    )
                if target_spec is not None:
                    self._tb.add_figure(
                        "Eval/target", _plot_matrix(target_spec.T, "target"),
                        epoch,
                    )
                if predicted_spec is not None:
                    self._tb.add_figure(
                        "Predicted/generated",
                        _plot_matrix(predicted_spec.T, "generated"), epoch,
                    )
                if forced_spec is not None:
                    self._tb.add_figure(
                        "Predicted/forced",
                        _plot_matrix(forced_spec.T, "forced"), epoch,
                    )
                if stop_probs is not None:
                    self._tb.add_figure(
                        "Eval/stop_tokens",
                        _plot_curve(stop_probs, stop_target), epoch,
                    )
                if source_text is not None:
                    self._tb.add_text("Eval/source_text", source_text, epoch)
                for tag, wav in (("Audio/generated", audio_generated),
                                 ("Audio/forced", audio_forced)):
                    if wav is not None:
                        import torch

                        self._tb.add_audio(
                            tag, torch.from_numpy(np.asarray(wav)),
                            epoch, sample_rate=sample_rate,
                        )
            except Exception:
                pass

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    # -- console progress (reference: utils/logging.py:24-40) ---------------

    @staticmethod
    def progress(fraction: float, prefix: str = "", size: int = 40):
        done = int(size * min(max(fraction, 0.0), 1.0))
        bar = "█" * done + "." * (size - done)
        end = "\n" if fraction >= 1.0 else ""
        print(f"\r{prefix} |{bar}| {fraction*100:.1f}%  ", end=end,
              file=sys.stderr, flush=True)


def _plot_matrix(matrix: np.ndarray, title: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(matrix, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return fig


def _plot_curve(values: np.ndarray, target: Optional[np.ndarray] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 2.5))
    ax.plot(np.asarray(values), label="predicted")
    if target is not None:
        ax.plot(np.asarray(target), label="target", linestyle="--")
        ax.legend(loc="upper left")
    ax.set_ylim(-0.05, 1.05)
    ax.set_title("stop token probability")
    return fig
