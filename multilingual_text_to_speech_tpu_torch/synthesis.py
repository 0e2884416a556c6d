"""Batched synthesis: text -> mel spectrograms, on the card.

Port of the JAX package's ``synthesis.py`` (the ``Synthesizer`` that users
drive).  The input line format and the language-spec mini-language are the
same:

    multi:                "id|text|speaker|de"
    per-character langs:  "id|text|speaker|de-10,fr-9,de"
    accent blending:      "id|text|speaker|de-10,fr*0.75:de*0.25-9,de"

One-hot language batches are sorted by language and encoded in row groups
(a grouped encoder then runs each sample through its own language's
weights only; the other encoders take the per-character weights as they
always do); true blends take the mixing path.  The decoder runs ``hp.decode_chunk_frames`` steps at a time
through ``ops.fused_decoder`` (the CUDA kernels on the card, their plain
version on the CPU), and the host checks the stop tokens between chunks.
``hp.compute_dtype`` picks the kernels' bfloat16 or float32 instances,
``hp.pallas_decoder_int8`` the W8A8 gates and
``hp.pallas_decoder_int8_streams`` (None: off) the int8 attention streams,
as in the JAX package; both hold only with ``hp.use_pallas_decoder``, whose
False (the JAX package's XLA scan) decodes with exact gates on full
streams.  In float32
the encoder's and postnet's cuDNN calls run in full float32
(``device.exact_float32``), not in PyTorch's default TF32.
``Synthesizer.from_checkpoint`` reads the JAX package's single-file
checkpoint (``training.checkpoint``), and ``vocode``/``vocode_batch`` turn
spectrograms into waveforms by Griffin-Lim on the same device
(``ops.audio``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import numpy as np
import torch

from multilingual_text_to_speech_tpu_torch.device import (
    DeviceLike,
    exact_float32,
    resolve_device,
)
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu_torch.ops import audio as audio_ops
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder
from multilingual_text_to_speech_tpu_torch.text import SymbolTable, clean_text
from multilingual_text_to_speech_tpu_torch.training.checkpoint import (
    load_checkpoint,
)


def parse_language_spec(spec: str, hp, t_length: int) -> np.ndarray:
    """The code-switching/accent spec -> per-character weights [1, T, L].

    Segments are ``lang[-length]`` separated by commas; a segment language
    may be a weighted blend ``l1*w1:l2*w2``; the last segment takes all
    remaining characters."""
    num_langs = hp.language_number if hp.language_number else len(hp.languages)
    weights: List[List[float]] = []
    remaining = t_length
    for token in spec.split(","):
        parts = token.split("-")
        lang_weights = [0.0] * num_langs
        for component in parts[0].split(":"):
            sub = component.split("*")
            if sub[0] not in hp.languages:
                raise ValueError(
                    f"unknown language '{sub[0]}' in spec '{spec}'; "
                    f"this model knows {hp.languages}")
            lang_weights[hp.languages.index(sub[0])] = (
                1.0 if len(sub) == 1 else float(sub[1]))
        seg_len = int(parts[1]) if len(parts) == 2 else remaining
        weights += [lang_weights] * seg_len
        remaining -= seg_len
        if remaining < 0:
            raise ValueError(
                f"language spec '{spec}' covers {t_length - remaining} "
                f"characters but the text has only {t_length}")
    if remaining > 0:
        raise ValueError(
            f"language spec '{spec}' covers {t_length - remaining} of "
            f"{t_length} characters; the last segment should omit its "
            "length to take the remainder")
    return np.asarray([weights], dtype=np.float32)


def _pure_language(weights: np.ndarray) -> Optional[int]:
    """The language index if the weights [1, T, L] are one one-hot language
    for every character, else None."""
    w = weights[0]
    lang = int(np.argmax(w[0]))
    target = np.zeros(w.shape[1], w.dtype)
    target[lang] = 1.0
    return lang if bool(np.all(w == target)) else None


def _plan_row_groups(langs: List[int], max_overhead: float = 0.125):
    """A language-sorted, run-padded batch for row-group encoding ->
    ``(slots, group_langs, rows_per_group)``: ``slots`` lists original
    indices (None = padding slot) so that every ``rows_per_group``
    consecutive slots share one language ``group_langs[r]``.  Takes the
    largest row-group size whose padding stays under ``max_overhead``."""
    n = len(langs)
    counts: dict = {}
    for lang in langs:
        counts[lang] = counts.get(lang, 0) + 1
    bp = 1
    for cand in (64, 48, 32, 24, 16, 12, 8, 6, 4, 3, 2):
        padded = sum(-(-c // cand) * cand for c in counts.values())
        if padded <= n * (1.0 + max_overhead):
            bp = cand
            break
    slots: List[Optional[int]] = []
    group_langs: List[int] = []
    for lang in sorted(counts):
        idx = [i for i, l in enumerate(langs) if l == lang]
        pad = (-len(idx)) % bp
        slots += idx + [None] * pad
        group_langs += [lang] * ((len(idx) + pad) // bp)
    return slots, group_langs, bp


def _speaker_index(hp, name: str) -> int:
    speakers = list(getattr(hp, "unique_speakers", []))
    if name not in speakers:
        raise ValueError(f"unknown speaker '{name}'; this model knows "
                         f"{speakers}")
    return speakers.index(name)


def _bucket(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _compute_precision(method):
    """Runs a ``Synthesizer`` method with cuDNN in full float32 when the
    compute type is float32."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with (exact_float32() if self.dtype == torch.float32
              else contextlib.nullcontext()):
            return method(self, *args, **kwargs)
    return run


class Synthesizer:
    """An eval-mode model on one device plus the chunked decode loop.

    ``state_dict`` is the port's (see ``interop.params_from_jax`` for JAX
    weights).  ``device`` defaults to ``cuda``; pass ``"cpu"`` for the plain
    PyTorch path.  ``max_chunks`` caps the decode chunks of an utterance
    (default: enough for ``hp.max_output_length`` frames)."""

    def __init__(self, hp, state_dict, device: DeviceLike = None,
                 max_chunks: Optional[int] = None):
        self.hp = hp
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if hp.compute_dtype == "bfloat16"
                      else torch.float32)
        model = Tacotron(hp, self.dtype)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.chunk = int(hp.decode_chunk_frames)
        self.max_chunks = max_chunks or (
            (hp.max_output_length + self.chunk - 1) // self.chunk)
        # the JAX package decodes on its XLA scan, exact gates on full
        # streams, unless hp.use_pallas_decoder: W8A8 and int8 streams are
        # settings of its fused decoder alone
        fused = bool(hp.use_pallas_decoder)
        self.bundle = fused_decoder.extract_decoder_bundle(
            self.model.decoder.cell, self.dtype,
            quantize_gates=fused and bool(hp.pallas_decoder_int8),
            q_streams=fused and bool(hp.pallas_decoder_int8_streams))
        self.decode_kwargs = self.model.decoder.decode_kwargs

    @classmethod
    def from_checkpoint(cls, path: str, device: DeviceLike = None,
                        **kwargs) -> "Synthesizer":
        """A synthesizer of the checkpoint's hyper-parameters and weights
        (a file of the JAX package's ``save_checkpoint`` or the port's),
        loaded strictly, on ``device`` (the card unless ``"cpu"``)."""
        payload = load_checkpoint(path)
        return cls(payload["hp"], params_from_jax(payload["model"]),
                   device=device, **kwargs)

    def _tensor(self, a, dtype=torch.long):
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def _decode(self, carry, memory, mt, mask, generator):
        return fused_decoder.decode_chunk(
            self.bundle, carry, memory, mt, mask,
            fused_decoder.draw_seeds(generator), self.chunk,
            **self.decode_kwargs)

    def _postnet_denormalized(self, pre: torch.Tensor, cuts: np.ndarray):
        """[B, F, M] decoder frames and per-sample lengths -> the list of
        denormalized [bins, F_i] postnet outputs (numpy), run as one batch
        at one padded length; the lengths go to the postnet too (the CBHG's
        GRU runs over each sample's own frames)."""
        hp = self.hp
        b, frames, bins = pre.shape
        f_pad = _bucket(int(cuts.max()), hp.bucket_frame_multiple)
        padded = torch.zeros(b, f_pad, bins, device=self.device)
        n = min(f_pad, frames)
        padded[:, :n] = pre[:, :n]
        lengths = self._tensor(cuts)
        keep = (torch.arange(f_pad, device=self.device)[None, :]
                < lengths[:, None])
        post = self.model.apply_postnet(padded * keep[..., None], lengths)
        post = post.cpu().numpy()
        out = []
        for i in range(b):
            spec = post[i, :cuts[i]].T
            if hp.normalize_spectrogram:
                spec = audio_ops.denormalize_spectrogram(
                    spec, hp, not hp.predict_linear)
            out.append(spec)
        return out

    @torch.no_grad()
    @_compute_precision
    def spectrogram_from_ids(self, sequence: np.ndarray,
                             speaker: Optional[int] = None,
                             language_weights: Optional[np.ndarray] = None,
                             seed: int = 0) -> np.ndarray:
        """One utterance: encode, chunked decode, postnet -> the
        denormalized spectrogram [bins, frames]."""
        hp = self.hp
        t = len(sequence)
        t_pad = _bucket(t, hp.bucket_text_multiple)
        text = np.zeros((1, t_pad), np.int64)
        text[0, :t] = sequence
        spk = self._tensor([speaker]) if speaker is not None else None
        pure = (_pure_language(language_weights)
                if language_weights is not None else 0)
        if pure is not None:
            memory, mt, mask, carry = self.model.encode_for_inference(
                self._tensor(text), self._tensor([t]), spk,
                self._tensor([pure]), group_langs=self._tensor([pure]))
        else:
            lang = np.zeros((1, t_pad, language_weights.shape[2]), np.float32)
            lang[:, :t] = language_weights
            lang[:, t:] = language_weights[:, -1:]  # nonzero padding rows
            memory, mt, mask, carry = self.model.encode_for_inference(
                self._tensor(text), self._tensor([t]), spk,
                self._tensor(lang, torch.float32))

        generator = torch.Generator().manual_seed(seed)
        frames, total = [], 0
        for _ in range(self.max_chunks):
            carry, (spec, stop) = self._decode(carry, memory, mt, mask,
                                               generator)
            hit = np.where(torch.sigmoid(stop[0]).cpu().numpy() >= 0.5)[0]
            if len(hit):
                # hp.stop_frames more frames after the first stop
                cut = min(int(hit[0]) + 1 + hp.stop_frames, spec.shape[1])
                frames.append(spec[:, :cut])
                total += cut
                break
            frames.append(spec)
            total += spec.shape[1]
            if total >= hp.max_output_length:
                break
        return self._postnet_denormalized(torch.cat(frames, 1),
                                          np.asarray([total]))[0]

    @torch.no_grad()
    @_compute_precision
    def spectrograms_from_batch(self, sequences, speakers=None,
                                language_weights=None, seed: int = 0):
        """All utterances decode together; each is cropped at its own stop
        token plus ``hp.stop_frames``.  Returns the denormalized
        [bins, F_i] spectrograms (numpy) in input order."""
        hp = self.hp
        n_in = len(sequences)
        t_pad = _bucket(max(len(s) for s in sequences), hp.bucket_text_multiple)

        if language_weights is None:
            pure: Optional[List[int]] = [0] * n_in
        else:
            cand = [_pure_language(w) for w in language_weights]
            pure = cand if all(c is not None for c in cand) else None
        if pure is not None:
            slots, group_langs, rows = _plan_row_groups(pure)
        else:
            slots, group_langs = list(range(n_in)), None
        b = len(slots)

        text = np.zeros((b, t_pad), np.int64)
        lengths = np.ones(b, np.int64)      # padding slots: length-1 dummies
        for s_i, i in enumerate(slots):
            if i is not None:
                text[s_i, :len(sequences[i])] = sequences[i]
                lengths[s_i] = len(sequences[i])
        spk = None
        if speakers is not None:
            spk = self._tensor([speakers[i] if i is not None else 0
                                for i in slots])

        if pure is not None:
            # padding slots take their row group's language
            lang_ids = [pure[i] if i is not None else group_langs[s_i // rows]
                        for s_i, i in enumerate(slots)]
            memory, mt, mask, carry = self.model.encode_for_inference(
                self._tensor(text), self._tensor(lengths), spk,
                self._tensor(lang_ids), group_langs=self._tensor(group_langs))
        else:
            num_l = language_weights[0].shape[2]
            lang = np.zeros((b, t_pad, num_l), np.float32)
            for i, w in enumerate(language_weights):
                lang[i, :w.shape[1]] = w[0]
                lang[i, w.shape[1]:] = w[0, -1]   # nonzero padding rows
            memory, mt, mask, carry = self.model.encode_for_inference(
                self._tensor(text), self._tensor(lengths), spk,
                self._tensor(lang, torch.float32))

        generator = torch.Generator().manual_seed(seed)
        chunks = []
        stop_at = np.full(b, -1, np.int64)   # absolute frame of first stop
        for s_i, i in enumerate(slots):
            if i is None:
                stop_at[s_i] = 0             # padding decodes but never waits
        total = 0
        for _ in range(self.max_chunks):
            carry, (spec, stop) = self._decode(carry, memory, mt, mask,
                                               generator)
            chunks.append(spec)
            stop_np = (torch.sigmoid(stop) >= 0.5).cpu().numpy()
            for i in range(b):
                if stop_at[i] < 0:
                    hit = np.where(stop_np[i])[0]
                    if len(hit):
                        stop_at[i] = total + int(hit[0])
            total += self.chunk
            pending = stop_at < 0
            done = (~pending) & (stop_at + 1 + hp.stop_frames <= total)
            if done.all() or total >= hp.max_output_length:
                break

        pre = torch.cat(chunks, 1)                       # [B, F_total, M]
        cuts = np.where(stop_at >= 0,
                        np.minimum(stop_at + 1 + hp.stop_frames, pre.shape[1]),
                        pre.shape[1]).astype(np.int64)
        post = self._postnet_denormalized(pre, cuts)
        out: List[Optional[np.ndarray]] = [None] * n_in
        for s_i, i in enumerate(slots):
            if i is not None:
                out[i] = post[s_i]
        return out

    def synthesize_batch_lines(self, lines, seed: int = 0):
        """Parse ``id|text|speaker|langs`` lines and synthesize them as one
        batch."""
        hp = self.hp
        table = SymbolTable(hp)
        sequences, speakers, weights = [], [], []
        for line in lines:
            item = line.split("|")
            text = clean_text(item[1], hp)
            sequences.append(np.asarray(table.encode(text), np.int64))
            if hp.multi_language:
                weights.append(parse_language_spec(item[3], hp, len(text) + 1))
            if hp.multi_speaker:
                speakers.append(_speaker_index(hp, item[2]))
        return self.spectrograms_from_batch(
            sequences, speakers if hp.multi_speaker else None,
            weights if hp.multi_language else None, seed)

    def synthesize_line(self, input_line: str, seed: int = 0) -> np.ndarray:
        """One ``id|text|speaker|langs`` line -> its denormalized
        spectrogram [bins, frames]."""
        hp = self.hp
        item = input_line.split("|")
        text = clean_text(item[1], hp)
        sequence = np.asarray(SymbolTable(hp).encode(text), np.int64)
        weights = (parse_language_spec(item[3], hp, len(text) + 1)
                   if hp.multi_language else None)
        speaker = _speaker_index(hp, item[2]) if hp.multi_speaker else None
        return self.spectrogram_from_ids(sequence, speaker, weights, seed)

    def vocode(self, spectrogram_db: np.ndarray, seed: int = 0) -> np.ndarray:
        """Griffin-Lim on this synthesizer's device: a [bins, F] dB
        spectrogram -> its waveform (numpy), phases drawn from a generator
        seeded with ``seed``."""
        return audio_ops.inverse_spectrogram(
            spectrogram_db, self.hp, mel=not self.hp.predict_linear,
            seed=seed, device=self.device)

    def vocode_batch(self, spectrograms, seed: int = 0) -> List[np.ndarray]:
        """Griffin-Lim of a list of [bins, F_i] spectrograms as one batch:
        padded to the longest with -100 dB, each waveform cropped to
        ``hop * max(F_i - 1, 1)`` samples."""
        hp = self.hp
        hop = audio_ops.ms_to_frames(hp.stft_shift_ms, hp)
        frames = [s.shape[1] for s in spectrograms]
        batch = np.full((len(spectrograms), spectrograms[0].shape[0],
                         max(frames)), -100.0, np.float32)
        for i, s in enumerate(spectrograms):
            batch[i, :, :s.shape[1]] = s
        wavs = audio_ops.inverse_spectrogram_batch(
            batch, hp, mel=not hp.predict_linear, seed=seed,
            device=self.device)
        return [w[:hop * max(f - 1, 1)] for w, f in zip(wavs, frames)]
