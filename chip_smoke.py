#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run on a failed check:

1. build the CUDA kernels from ``multilingual_text_to_speech_tpu_torch/csrc``
   with nvcc for sm_90a and print ptxas's register/shared-memory report;
2. hold every kernel against its plain PyTorch version at the flagship
   widths (B=240, T=128), for W8A8 and for bfloat16 gates: dropout masks and
   int8 activations bit-exact, the rest within a stated tolerance; the head
   row that the generator's ``gate_lstm`` and ``lsa_attention`` write
   bit-exact, and two runs of the prenet, of ``lsa_attention`` and of the
   head over that row bit-identical; then one 16-step chunk through the
   kernels against the plain chunk;
3. the main path: ``Synthesizer.synthesize_batch_lines`` on 240 lines (48
   per language, random 127-letter texts, random speakers), decode chunk
   256 and 512 frames, with the launch counts reset just before and read
   just after; then a small accent-blend batch (the mixing encode path) and
   a small batch held against the plain path on the CPU;
4. device times (``torch.profiler``, as for every kernel row) of each
   kernel (every launch of its stage: ``gate_lstm``'s row passes and
   products; the split-K products of the heads, ``train_query`` and
   ``bwd_gemm`` and their reductions), its plain version and, for the gate
   product and the head,
   ``torch._int_mm`` and ``torch.addmm`` as the yardsticks, with each
   kernel's bound; CUDA-event times of a decode step and chunk; then the
   host's enqueue time against the device time of one chunk, and the
   device's busy share and time by kernel under ``torch.profiler``;
   then ``[serve:checkpoint]``: the port saves the flagship's weights to a
   checkpoint file, ``Synthesizer.from_checkpoint`` restores them on the
   card bit-identical, 16 lines through it (launch counts reset just
   before and read just after) match an in-memory synthesizer's bit for
   bit, the synthesis CLI writes ``.npy`` files and WAVs for 4 lines,
   ``vocode_batch`` of 16 x 512 frames is timed, and Griffin-Lim on the
   card is held against the CPU from shared initial phases (10 iterations
   sample by sample, 60 by spectral convergence);
   then ``[main:shared]`` and ``[main:separate]``: the same synthesis, 256
   frames, at the paper's shared strategy (``shared_switching_hparams``:
   the simple BiLSTM encoder, 548-wide memory; its K1 kernels also held
   against plain and timed there, W8A8) and separate strategy
   (``separate_switching_hparams``: the plain grouped convolutional
   encoder, 288-wide memory);
5. the training slice's kernels (K2 forward, K3 backward) against their
   plain versions at the flagship widths (B=50, T=128, bf16), on inputs
   that repeat from run to run: dropout and zoneout choices bit-exact,
   every kernel on identical inputs (``bwd_prenet``'s frame cotangent
   against the plain product of its own bf16 first-layer gradient), two
   runs each of ``bwd_gemm`` (its split-K reduction), ``bwd_head``, the
   cells (fused into ``bwd_head`` and the dq product, their zoneout choices
   bit-exact), ``train_prenet``, ``train_attention``, ``att_bwd`` and
   ``bwd_prenet`` (their clusters' exchanges and partial sums)
   bit-identical, then 16
   chained steps forward and backward (every output, residual and gradient
   stream, accumulator and the final cotangent carry); then the same 16
   steps through ``TrainDecode`` (K2 forward, K3 backward) against
   ``torch.autograd`` through the plain K2, from the same card inputs;
6. the training main path: ``train_step`` at B=50 (10 per language,
   interleaved), T=128, F=512 through ``make_optimizer``, one warm-up step,
   three timed steps at teacher forcing 1.0 and one at 0.5, with the launch
   counts reset just before and read just after; the step split into
   forward, backward and optimizer, audio-seconds trained per second; then
   a small step on the card against the same step on the CPU plain path;
   then the eval forward (``[train:eval]``): 16 steps of K2's eval variant
   (zoneout interpolated, no residual streams) through the kernels against
   its plain version at B=50, T=128, and ``model.eval()``'s teacher-forced
   forward at B=10 on the card against the CPU plain path, with the launch
   counts reset just before and read just after (every K2 kernel, no K3);
7. device times (``torch.profiler``) of the K2/K3 kernels against their
   plain versions, bounds and ``torch`` yardsticks (the cells' row: what
   they add to ``bwd_head`` and the dq product, beside their standalone
   launches), and the device's busy share of one training step under
   ``torch.profiler``;
8. ``[train:shared]`` and ``[train:separate]``: training steps of both
   strategies at B=50, T=128, F=512 (a warm-up, two timed steps and one at
   teacher forcing 0.5), every K2/K3 kernel launched, and a small step on
   the card against the CPU plain path; at the shared strategy's widths
   the K2/K3 kernels are also held against plain and timed as in 5 and 7.

9. ``[*:fwd]`` and ``[*:fwd_trans]``: the forward-attention family
   (``forward`` and ``forward_transition_agent``) at the flagship's widths:
   K1's ``fwd_attention`` against its plain version (W8A8 and bf16 gates:
   masks bit-exact, two runs bit-identical, weights a floored
   distribution, t_prob; a 16-step chunk with the carried weights and
   t_prob), synthesis of 240 lines x 256 frames through it (launching it
   and not ``lsa_attention``), its device time; K2's and K3's family
   variants against plain (alone, then 16 chained steps with ``dtp`` and
   ``dlin``, and ``TrainDecode`` against autograd with the agent's weight
   gradients), training steps through them, their device times; at the
   transition agent also a small synthesis, a small train step and
   ``model.eval()``'s forward on the card against the CPU plain path.

10. K1's float32 compute and int8 streams (``phase_k1_variants``, at the
   flagship and at each family kind): ``[kernels:f32]`` holds every float32
   instance (prenet, both gate products with W8A8 and, location-sensitive,
   exact float32 gates, the attention kernel, also at T=120 for the
   family, the head) against its float32 plain version within 1e-5 of
   each output's largest value, masks and int8 activations bit-exact, and
   a 16-step chunk; ``[kernels:q8]`` and ``[kernels:f32-q8]`` the
   attention kernels on int8 streams in bf16 and float32, their codes and
   scales bit-exact with the CPU's quantization, at the 292-wide memory and
   the shared strategy's 548 (for the family on random 548-wide streams),
   and timed at 548 (``[time:E=548]`` and the shared strategy's
   ``[time]`` rows of ``lsa_attention_q8``, printed, not kept in the
   kernel rows); every attention check also at T=7, where a row's streams
   start and end off a 16-byte boundary;
   ``[main:f32]`` synthesis in float32 with W8A8 gates (240 lines x 256
   frames, the card against the CPU with cuDNN at PyTorch's TF32 default),
   ``[main:q8]`` in bf16 on int8 streams (the same), and 240 lines x 32
   frames of every other new instance, each with its launches asserted;
   their device times.  Every phase prints its own peak device memory
   (``[memory]``).

11. float32 compute in training (``phase_train_f32_and_long``, lines
   tagged ``f32``): every K2/K3 float32 instance against its float32 plain
   version within 1e-5 of each output's largest value, masks and the fused
   cells' choices bit-exact, two runs bit-identical, 16 chained steps and
   ``TrainDecode`` against autograd; four flagship float32 ``train_step``s
   at B=50, T=128, F=512 after a warm-up, with their launch counts (only
   ``_f32`` instances) and a step split by CUDA events; a float32 step at
   B=10 on the card against the CPU within 1e-4 on the losses and every
   parameter's gradient, and the same with ``device.exact_float32`` taken
   out and cuDNN at its TF32 default (printed, not gated); the float32 eval
   forward; the instances' device times; then the forward family in
   float32 at 128 frames (``f32:fwd``, ``f32:fwd_trans``);
12. ``[train:long]``: texts of 600, 1000, 1500, 2304, 4096 and 8192
   symbols at B=8, each attention kind and compute type: K2's
   ``train_attention``, K3's ``att_bwd`` (past its single tile in
   sub-tiles) and K1's attention kernel against their plain versions,
   their device times beside ``att_bwd``'s bound, a bf16 train step at
   T=600 on the card against the CPU, and the flagship's bf16 and float32
   steps at B=5, T=4096, F=32 on the card against the CPU.
13. ``[train:loop]`` (after 7): the flagship trained from a corpus on disk
   (``phase_train_loop``): 250 items in 5 languages and 16 speakers, texts
   from ``tests/data/css_comvoi/val.txt``, audio generated at 48 + 4 frames
   a character up to 512, written and their caches filled on the card by
   ``cli/prepare.py --fill_metafile`` before the build (``loop_setup``,
   which starts the CPU's two training steps in a child process that runs
   while nvcc builds; the run waits for it before its first host-clock
   timing); host batches/s through ``batch_iterator`` and ``prefetch``
   alone; a ``Trainer`` epoch at B=50 (4 steps; every K2/K3 kernel
   launched, no other), ``evaluate`` (K2 only) and ``save``; a new
   ``Trainer`` from the checkpoint bit-identical, and its epoch; the first
   two steps on the card against the CPU's; ``cli/gta.py`` over the
   training set and its first batch against ``--cpu``; each number beside
   the card's name and power limit.
14. ``[cbhg]`` (after 13): the flagship with the CBHG linear postnet and
   the cosine-similarity classifier (``phase_cbhg``): a bf16 training step
   at B=50, T=128, F=512 (``[train:cbhg]``: every K2/K3 kernel launched, no
   other) against 6's conv-postnet step, each postnet's forward and
   backward alone and the CBHG's GRU alone; a B=10 step card against CPU;
   16 lines x 512 frames of linear spectrograms through K1 (every K1
   kernel launched, no other), 2 lines card against CPU; ``vocode_batch``
   on them (no NNLS) timed and Griffin-Lim card against CPU; a
   reference-layout checkpoint (``tests/torch_reference_layout.py``)
   through the port's import CLI to ``Synthesizer.from_checkpoint`` on the
   card, bit-identical; in float32 the synthesis CLI on card and CPU into
   the evaluation layout, ``evaluation.mcd`` card against CPU and
   ``evaluation.asr``/``cer`` with a recognizer that echoes the metafile.
15. ``[train:dp]`` (after 13): data-parallel training on the one card
   (``phase_train_dp``): a mesh of one over NCCL (a store in the process)
   takes the flagship's bf16 step at B=50 bit-identical to the plain
   ``train_step``, both timed in turns; two ranks over gloo in child
   processes (``chip_smoke.py --dp-child RANK PORT``, ``dp_child``), 25
   rows each: their first step in bf16 and float32 against this process's
   on the global batch (``DP_STEP_TOL``), the gradient all-reduce timed
   with its bytes, each rank's step timed against the single process's, a
   ``Trainer`` epoch on 13's corpus (every K2/K3 kernel launched on every
   rank), ``evaluate`` (K2 only) and rank 0's save, after which the ranks'
   weights, batch-norm statistics and Adam moments are bit-identical;
   each rank's peak memory.

It prints the card's name and power limit, one JSON line of kernel results,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.  Weights are the port's own seeded initialization; the stop head's
bias is set to -10 so that every stream decodes all its frames.  Lines of
a phase at the shared or separate strategy carry its name in their tag.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
B, T_SYMBOLS, CHUNK, MAX_FRAMES = 240, 128, 256, 512
# the paper's shared and separate strategies (config.py): one chunk each
SWITCHING, SWITCHING_FRAMES = ("shared", "separate"), 256
# the forward-attention family at the flagship's widths: one chunk each;
# the phases' tags carry the kind's label
FAMILY = {"forward": "fwd", "forward_transition_agent": "fwd_trans"}
FAMILY_FRAMES = 256
FAMILY_TRAIN_KERNELS = ("train_attention_fwd", "att_bwd_fwd")
TRAIN_B, TRAIN_T, TRAIN_F, CHECK_STEPS = 50, 128, 512, 16
# the forward family's float32 training steps: a smaller depth
F32_FAMILY_FRAMES = 128
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s
HBM_BYTES_S = 3.35e12
# f32: FFMA on the CUDA cores, the route of the float32 kernels off the
# tensor cores; tf32: the tensor cores' TF32 peak
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12, "tf32": 495e12}
# the float32 products that run on the tensor cores in three TF32 passes
# (csrc/tile.cuh mma_tf32x3): bound by three times their products'
# operations at the TF32 peak and the rest on FFMA (row_ops), the FFMA
# bound printed beside it.  At the training path's shapes bwd_head,
# att_bwd, train_attention and both prenets stay bound by their bytes
# either way, and so do K1's float32 attention rows (the query product,
# and the location-sensitive band, in three passes)
TF32X3_ROWS = ("gate_lstm", "head", "train_gate_lstm", "train_query",
               "train_head", "bwd_gemm", "bwd_head", "att_bwd",
               "train_attention", "bwd_prenet", "prenet", "train_prenet",
               "lsa_attention", "fwd_attention")
# Tolerances of kernel vs plain on the same inputs, set a few times above
# the errors measured on an H100 (PERF.md): float32 sums in another order,
# and bfloat16 roundings that a one-ulp difference can flip.
ATOL = 2e-3                   # prenet, h, c, frame, stop: absolute
CTX_TOL = 2e-3                # context: absolute and relative
W_TOL = 1e-2                  # attention weights: |dw| / max w, per row
CHUNK_REL_TOL = 1e-2          # 16 autoregressive steps, kernel vs plain
SUM_TOL = 1e-5                # the forward family's weights: |sum - 1|
E2E_REL_TOL = 1e-2            # card kernels vs the CPU plain path, bf16
# K1's float32 instances against their float32 plain versions: every output
# within this share of its largest value (float32 sums in another order; a
# bf16 operand or a single TF32 pass would be off by about 1e-3)
F32_TOL = 1e-5
# 16 float32 steps, kernels vs plain: relative error (norms).  Exact gates
# stay at float32 noise (measured 2.3e-7 on an H100); in W8A8 a row value
# that float32 sums in another order move across a rounding boundary
# changes one int8 code, and the chained steps grow it (measured up to
# 6.1e-4)
F32_CHUNK_TOL = {False: 1e-5, True: 2e-3}
# float32 synthesis (W8A8), card kernels vs the CPU plain path: relative
# error (measured 1.0e-7; one int8 code flipped moves a gate by one of K
# terms' 1/127)
F32_E2E_TOL = 1e-3
# the training kernels, on identical inputs: max |kernel - plain| of each
# output over its largest |plain|, per kernel and output type.  A float32
# output differs by the order of float32 sums: its bound is a few times the
# worst reading on an H100 that PERF.md lists.  A bf16 output can flip one
# ulp, up to 2^-7 of the largest value, and which values sit on a rounding
# boundary changes from run to run (readings 0 to 5.8e-3): its bound is
# that one ulp (q holds bf16 values in float32: 1e-2)
ULP = 8e-3
TRAIN_KERNEL_TOL = {
    "train_prenet": {"bf16": ULP},
    "train_gate_lstm": {"f32": 1e-5, "bf16": ULP},      # f32 1.47e-6
    "train_query": {"f32": 1e-2},                       # 2.53e-3 (bf16 q)
    "train_attention": {"f32": 1e-6, "bf16": ULP},      # 1.90e-7
    "train_head": {"f32": 4e-6},                        # 8.70e-7
    "bwd_head": {"f32": 5e-7, "bf16": ULP},             # 1.14e-7
    # the two cells as they run fused into bwd_head and the dq product,
    # against the plain product or head followed by the plain cell
    "bwd_cell": {"f32": 5e-7, "bf16": ULP},             # 7.94e-8 (alone)
    "bwd_gemm": {"f32": 2e-5},                          # 4.66e-6
    # its float32 accumulators follow bf16 roundings of the energy
    "att_bwd": {"f32": 5e-3, "bf16": ULP},              # 9.36e-4
    "bwd_prenet": {"f32": 1e-6, "bf16": ULP},           # 1.61e-7
    # the forward family's variants (PERF.md), at the bounds of their
    # location-sensitive siblings
    "train_attention_fwd": {"f32": 1e-6, "bf16": ULP},
    "att_bwd_fwd": {"f32": 5e-3, "bf16": ULP},
}
# the training kernels' float32 instances, on identical inputs: every output
# within F32_TOL of its largest value (train_kernel_bound)
# 16 chained steps, kernels vs plain drivers: relative error (norms) of each
# stream, gradient, accumulator and carry (measured up to 4.0e-3)
TRAIN_CHAIN_TOL = 2e-2
# the same in float32, by attention kind: every product float32 on both
# sides, sums in another order (location-sensitive: measured 8.3e-7 on an
# H100); the forward family's floor compares each masked weight with 1e-6,
# and where one sits at 1e-6 within float32 noise the two sides take the
# floor's other branch for its gradient (measured 7.3e-4, dq over 16 steps)
TRAIN_F32_CHAIN_TOL = {"ls": 1e-4, "family": 3e-3}
# 16 steps of TrainDecode (K2 forward, K3 backward) against torch.autograd
# through the plain K2 in differentiable ops, same card inputs: relative
# error (norms) of the outputs and of each input's gradient.  Autograd
# rounds each gradient to bf16 where the forward cast to it, K3 where it
# stores its streams (measured up to 2.4e-2, the prenet bias)
TRAIN_AUTOGRAD_TOL = 6e-2
# the same in float32: float32 sums in another order, nothing rounded
# (location-sensitive: measured 1.1e-6); the family's floor as above
TRAIN_F32_AUTOGRAD_TOL = {"ls": 1e-4, "family": 3e-3}
# the B=10 step on the card against the CPU plain path, both bf16, teacher
# forcing 1.0: the encoder's convolutions and the products outside the
# kernels run in other libraries on each device, and the bf16 roundings of
# their results differ.  Relative error (norms) of the whole gradient and of
# each loss term, of each parameter's gradient (decoder, postnet,
# classifier) and of the generated encoder's parameters, whose gradients sum
# bf16-rounded convolution-weight gradients with much cancellation
# (measured 6.4e-2, 6.6e-2 and 0.21).  The same step in bf16 against
# float32, both on the CPU, differs by as much (PERF.md): these bounds
# hold the model's bf16 spread, and the two checks above hold K2/K3 alone
TRAIN_E2E_TOL = 0.2
TRAIN_E2E_PARAM_TOL = 0.2
TRAIN_E2E_ENCODER_TOL = 0.5
# the same step in float32 (train_step, which runs cuDNN without TF32):
# the losses and every parameter's gradient, relative
TRAIN_F32_E2E_TOL = 1e-4
# the serving entry point from a checkpoint ([serve:checkpoint]): lines
# restored and synthesized, lines through the CLI, and Griffin-Lim's batch
# (spectrograms of MAX_FRAMES frames) timed and held card against CPU
CKPT_LINES, CLI_LINES, VOCODE_B, VOCODE_CHECK_B = 16, 4, 16, 2
# Griffin-Lim on identical initial phases, two FFT libraries: at up to 10
# iterations every sample within GL_TOL of the waveform's peak, a few times
# the largest reading (2.4e-4: the card against the CPU on the flagship's
# mel path, whose 50 NNLS updates run in each device's float32 products;
# 7.3e-5: the port against the JAX package on the CPU); the momentum grows
# float32 differences to a few 1e-3 by 60 iterations, where each output's
# spectral convergence is held within SC_TOL of the other's (read: 2.1e-6)
GL_TOL = 1e-3
SC_TOL = 1e-4


def kind_group(cfg) -> str:
    """"ls" or "family": the float32 chain bounds' key."""
    return "family" if cfg.family else "ls"


def train_kernel_bound(name: str, dtype):
    """The kernel-vs-plain bound of a K2/K3 kernel's outputs by their type
    (``TRAIN_KERNEL_TOL``); every output of a float32 instance F32_TOL."""
    import torch

    return TRAIN_KERNEL_TOL[name] if dtype == torch.bfloat16 else {
        "f32": F32_TOL}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# the configuration a phase runs, when not the flagship: added to the tag
# that starts each line it prints ("[time]" -> "[time:shared]")
_LABEL = ""


def say(msg: str) -> None:
    if _LABEL:
        def tag(m):
            parts = m.group(1).split(":")
            if len(parts) > 1 and parts[-1] == "main":   # [train:main]
                parts[-1] = _LABEL
            else:
                parts.append(_LABEL)
            return "[" + ":".join(parts) + "]"
        msg = re.sub(r"^\[([^\]]*)\]", tag, msg)
    print(msg, flush=True)


@contextlib.contextmanager
def labelled(label: str):
    global _LABEL
    old, _LABEL = _LABEL, label
    try:
        yield
    finally:
        _LABEL = old


@contextlib.contextmanager
def phase(name: str):
    """A phase of the run with its own peak of device memory: what earlier
    phases left is collected and the peak statistics reset before it, and
    its peak (``torch.cuda.max_memory_allocated``) printed after it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    if held > 2 ** 28:
        # what an earlier phase left alive: the largest tensors by shape
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape),
                        str(o.dtype)) for o in gc.get_objects()
                       if torch.is_tensor(o) and o.is_cuda), reverse=True)
        say(f"[memory] {name}: held on entry by {len(live)} live tensors, "
            f"the largest " + ", ".join(f"{s} {d} {n / 2**20:.0f} MiB"
                                        for n, s, d in live[:6]))
    t0 = time.time()
    yield
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    say(f"[memory] {name}: peak {peak / 2**30:.2f} GiB ({held / 2**30:.2f}"
        f" GiB held on entry), {time.time() - t0:.1f} s")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (found, expected) device events of the last device_ms call
LAST_EVENTS = (0, 0)


def _launch_total() -> int:
    """The port's kernel launches so far, both decoders' wrappers'."""
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    # "bwd_cell" counts launches that bwd_head's and bwd_gemm's keys count
    return sum(fd.LAUNCHES.values()) + sum(
        v for k, v in ftd.LAUNCHES.items() if not k.startswith("bwd_cell"))


def device_ms(fn, iters: int = 10, warmup: int = 2,
              ours_only: bool = False) -> float:
    """Device time of one ``fn()`` call from the device kernels (and
    copies) that ``torch.profiler`` records over sessions of ``iters``
    calls; with ``ours_only``, only the port's own kernels (anonymous
    namespace), not PyTorch's copies of the inputs.  Unlike CUDA events
    around the calls, it leaves out the gaps while the host prepares the
    next launch.  The profiler now and then delivers only some of a
    session's device events, or none, so the time counts only the calls
    whose events it recorded: for each kernel name its mean event time
    times its events a call (the most that one session recorded, over
    ``iters``, rounded up), summed over the names.  Two sessions run, a
    third when they found no event or (``ours_only``) fewer kernels a call
    than the port's wrappers launch (``LAUNCHES``); ``LAST_EVENTS`` holds
    how many of the expected events were found.  After three sessions
    without an event the call is timed with CUDA events instead (the whole
    call, gaps included), which the line printed says."""
    global LAST_EVENTS
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    before = _launch_total() if ours_only else 0
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    launches = (_launch_total() - before) / warmup if ours_only else 0
    spans, most = {}, {}       # every event's us by name; most in a session
    for session in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        count = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and (
                    not ours_only or "(anonymous namespace)::" in e.name):
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
                count[e.name] = count.get(e.name, 0) + 1
        for name, n in count.items():
            most[name] = max(most.get(name, 0), n)
        per_call = {k: math.ceil(n / iters) for k, n in most.items()}
        if session >= 1 and per_call and sum(per_call.values()) >= launches:
            found = sum(len(v) for v in spans.values())
            LAST_EVENTS = (found,
                           (session + 1) * iters * sum(per_call.values()))
            return sum(sum(spans[k]) / len(spans[k]) * per_call[k]
                       for k in per_call) / 1e3
    LAST_EVENTS = (sum(len(v) for v in spans.values()), 0)
    say("[time] the profiler recorded no device events (or too few kernels)"
        " in three sessions: the next time is CUDA events around the whole"
        " call")
    return cuda_ms(fn, iters=iters, warmup=0)


# the rows of the attention kernels (K1's, K2's train_attention) are timed
# in turns with their plain versions: kernel, plain, kernel, plain
TURN_ROWS = ("lsa_attention", "fwd_attention", "train_attention",
             "train_attention_fwd")


def turns_ms(kernel, plain, iters: int = 10):
    """(the kernel's mean, the plain version's mean, the kernel's readings,
    its events note) of device_ms readings in turns: kernel, plain,
    kernel, plain."""
    k, pl, notes = [], [], []
    for _ in range(2):
        k.append(device_ms(kernel, iters=iters, ours_only=True))
        notes.append(events_note())
        pl.append(device_ms(plain, iters=5))
    return sum(k) / 2, sum(pl) / 2, k, "; ".join(notes)


def events_note() -> str:
    """How many of the expected device events the last device_ms found."""
    found, expected = LAST_EVENTS
    return (f"events {found}/{expected}" if expected else
            f"events {found}/?, CUDA events")


def bound_ms(n_bytes: float, parts):
    """The larger of the bytes' time and the operations' time, in ms:
    ``parts`` (count, peak kind) pairs of operations run one after the
    other."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS[k] for n, k in parts) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_ops(name: str, ops: float, kind: str, mm_ops: float = None):
    """[(operations, peak kind)] of a kernel row's work: a float32 row of
    TF32X3_ROWS runs its products (``mm_ops`` of its ``ops``, all when
    None) as three TF32 passes and the rest on FFMA, the others their
    kind's."""
    if kind == "f32" and name in TF32X3_ROWS:
        mm = ops if mm_ops is None else mm_ops
        return [(3 * mm, "tf32")] + ([(ops - mm, "f32")] if ops > mm else [])
    return [(ops, kind)]


def row_bound(name: str, n_bytes: float, ops: float, kind: str,
              mm_ops: float = None):
    """bound_ms of a kernel row (``row_ops``), and a note for its printed
    line: for the rows of TF32X3_ROWS the FFMA bound beside it."""
    parts = row_ops(name, ops, kind, mm_ops)
    b_ms, b_by = bound_ms(n_bytes, parts)
    if parts[0][1] != "tf32":
        return b_ms, b_by, ""
    f_ms, f_by = bound_ms(n_bytes, [(ops, "f32")])
    return b_ms, b_by, f", on FFMA {f_ms:.5f} ms ({f_by})"


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def close(name: str, got, ref, atol: float = ATOL, rtol: float = 0.0
          ) -> float:
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    if not torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol):
        fail(f"{name}: max |kernel - plain| = {max_err(got, ref)}")
    return max_err(got, ref)


def close_weights(name: str, cum_k, cum_p, cum) -> float:
    """The step's attention weights ``cum' - cum``, each row's error
    relative to that row's largest weight."""
    import torch

    w_k, w_p = cum_k - cum, cum_p - cum
    worst = float(((w_k - w_p).abs().amax(1) / w_p.amax(1)).max())
    if not (torch.isfinite(w_k).all() and worst < W_TOL):
        fail(f"{name}: attention weights off by {worst} of the row maximum")
    say(f"[kernels] {name}: attention weights within {worst:.3g} of the "
          f"row maximum (bound {W_TOL})")
    return max_err(cum_k, cum_p)


def rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def flagship(max_frames: int, chunk: int,
             attention_type: str = "location_sensitive", **over):
    """The flagship, served; at another ``attention_type`` for the forward
    family's phases (every width stays the flagship's), and with the
    settings ``over`` (``compute_dtype``, ``pallas_decoder_int8``,
    ``pallas_decoder_int8_streams``)."""
    from multilingual_text_to_speech_tpu_torch import flagship_hparams

    hp = serving_hp(flagship_hparams(), max_frames, chunk)
    hp.attention_type = attention_type
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


# K1's configurations beside the flagship's (bf16, W8A8): float32 compute
# with W8A8 or exact gates, int8 streams in bf16 and in float32
F32 = {"compute_dtype": "float32"}
F32_EXACT = {"compute_dtype": "float32", "pallas_decoder_int8": False}
Q8 = {"pallas_decoder_int8_streams": True}
F32_Q8 = {"compute_dtype": "float32", "pallas_decoder_int8_streams": True}
# the small main runs that launch an instance no full phase drives: 240
# lines of LAUNCH_FRAMES frames, one chunk
LAUNCH_FRAMES = 32


def switching(name: str, max_frames: int, chunk: int):
    """The published ``shared_switching`` or ``separate_switching``
    configuration (``config.py``), set up for serving as the flagship."""
    from multilingual_text_to_speech_tpu_torch import config

    return serving_hp(getattr(config, f"{name}_switching_hparams")(),
                      max_frames, chunk)


def serving_hp(hp, max_frames: int, chunk: int):
    hp.compute_dtype = "bfloat16"
    hp.max_output_length = max_frames
    hp.decode_chunk_frames = chunk
    hp.unique_speakers = [f"spk{i}" for i in range(hp.speaker_number)]
    hp.mel_normalize_mean = [float(-4.0 + 0.01 * i) for i in range(hp.num_mels)]
    hp.mel_normalize_variance = [float(1.0 + 0.002 * i)
                                 for i in range(hp.num_mels)]
    return hp


def seeded_state_dict(hp):
    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        Tacotron,
        init_random_weights,
    )

    sd = init_random_weights(Tacotron(hp), SEED).state_dict()
    sd["decoder.cell.stop_prediction.bias"].fill_(-10.0)
    return sd


def lines_for(hp, n_per_lang: int, seed: int, blend: bool = False):
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    out = []
    for li, lang in enumerate(hp.languages):
        for j in range(n_per_lang):
            text = "".join(rng.choice(list(letters), T_SYMBOLS - 1))
            spk = hp.unique_speakers[rng.randint(hp.speaker_number)]
            spec = lang
            if blend:
                other = hp.languages[(li + 1) % len(hp.languages)]
                spec = f"{lang}*0.6:{other}*0.4"
            out.append(f"{lang}{j}|{text}|{spk}|{spec}")
    return out


# ---------------------------------------------------------------------------

def phase_build():
    from multilingual_text_to_speech_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build(force=True)
    say(f"[build] {len(logs)} source(s) in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        say(f"[build] {name}: nvcc -Xptxas -v")
        for line in text.splitlines():
            if "spill" in line or ("ptxas" in line and (
                    "registers" in line or "Compiling" in line)):
                print(f"  {line.strip()}")


def encoded_batch(syn, hp, bundle=None):
    """Realistic decoder inputs at the main path's shapes: 240 random texts
    through the row-group encoder, plus a carry three plain steps (of
    ``bundle``, ``syn``'s by default) in whose cumulative attention is that
    of an alignment part way through each text (1 up to a random position,
    0 after), so that the location term is of the size it has in a real
    utterance."""
    import numpy as np
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    rng = np.random.RandomState(SEED + 1)
    text = torch.as_tensor(rng.randint(3, hp.total_symbols(), (B, T_SYMBOLS)),
                           device="cuda")
    lengths = torch.as_tensor(rng.randint(T_SYMBOLS // 2, T_SYMBOLS + 1, B),
                              device="cuda")
    text[torch.arange(T_SYMBOLS, device="cuda")[None] >= lengths[:, None]] = 0
    speakers = torch.as_tensor(rng.randint(0, hp.speaker_number, B),
                               device="cuda")
    langs = torch.arange(B, device="cuda") // (B // hp.language_number)
    group = torch.arange(hp.language_number, device="cuda")
    memory, mt, mask, carry = syn.model.encode_for_inference(
        text, lengths, speakers, langs, group_langs=group)
    bundle = syn.bundle if bundle is None else bundle
    carry, _ = fd.decode_chunk_plain(bundle, carry, memory, mt, mask,
                                     (7, 11), 3, **syn.decode_kwargs)
    if bundle.att_kind != "ls":
        # the forward family's state is the last step's weights, a
        # distribution: three steps in, as it comes
        return memory, mt, mask, carry
    pos = torch.as_tensor(rng.uniform(0.2, 0.8, B), device="cuda") * lengths
    t = torch.arange(T_SYMBOLS, device="cuda")[None].float()
    ramp = torch.clamp(pos[:, None].float() - t, 0.0, 1.0) * mask
    carry["att_state"] = {"weights": carry["att_state"]["weights"] + ramp}
    return memory, mt, mask, carry


def close_f32(name: str, got, ref, tol: float = F32_TOL) -> float:
    """A float32 instance's output within ``tol`` of the plain version's
    largest value."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err, top = max_err(got, ref), float(ref.detach().float().abs().max())
    if err > tol * top:
        fail(f"{name}: max |kernel - plain| = {err}, {err / top:.3g} of the "
             f"largest value (bound {tol})")
    return err


def stream_head(x, n: int):
    """The first ``n`` positions of an attention stream (a compute-type
    tensor, or an ``Int8Stream`` with its scales)."""
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    if isinstance(x, fd.Int8Stream):
        return fd.Int8Stream(x.q[:, :n].contiguous(), x.scale)
    return x[:, :n].contiguous()


def check_attention_step(fd, bundle, tag, h_att, x, carry, memory, mtb,
                         mask_add, ctx_row):
    """One step of the bundle's attention kernel (``lsa_attention``, or the
    forward family's ``fwd_attention``) against its plain version on the
    same inputs, the context into ``ctx_row``: two runs bit-identical; in
    bf16 the weights within W_TOL of each row's largest, the context within
    CTX_TOL, t_prob within ATOL; in float32 each within F32_TOL of its
    largest value; the family's weights a distribution (sum within SUM_TOL
    of 1).  -> (kernel name, context, plain context, max abs error)."""
    import torch

    f32 = bundle.dtype == torch.float32
    state = carry["att_state"]
    if bundle.att_kind == "ls":
        name = "lsa_attention"
        cum = state["weights"]
        args = (h_att, cum, memory, mtb, mask_add, bundle)
        got = fd.lsa_attention(*args, ctx_row=ctx_row)
        again = fd.lsa_attention(*args)
        ref = fd.lsa_attention_plain(*args)
    else:
        name = "fwd_attention"
        cum = torch.zeros_like(state["weights"])
        args = (h_att, state["weights"], state.get("t_prob"), memory, mtb,
                mask_add, x, bundle)
        got = fd.fwd_attention(*args, ctx_row=ctx_row)
        again = fd.fwd_attention(*args)
        ref = fd.fwd_attention_plain(*args)
    torch.cuda.synchronize()
    if not all(g is a or torch.equal(g, a) for g, a in zip(got, again)):
        fail(f"{name}[{tag}]: two runs on the same inputs differ")

    def weights(label, w_k, w_p, base):
        if f32:
            return close_f32(f"{name} weights[{label}]", w_k - base,
                             w_p - base)
        return close_weights(f"{name}[{label}]", w_k, w_p, base)

    def context(label, c_k, c_p, atol=CTX_TOL):
        if f32:
            return close_f32(f"{name} ctx[{label}]", c_k, c_p)
        return close(f"{name} ctx[{label}]", c_k, c_p, atol, CTX_TOL)

    def agent(label, t_k, t_p):
        if f32:
            return close_f32(f"{name} t_prob[{label}]", t_k, t_p)
        return close(f"{name} t_prob[{label}]", t_k, t_p)

    err = max(weights(tag, got[1], ref[1], cum),
              context(tag, got[0], ref[0]))
    # a text of 7 positions: a row's streams then start and end off a
    # 16-byte boundary (7 rows of 292 int8 or 584 bf16 bytes), so the
    # staged instances copy the ragged heads and tails with their threads.
    # Its weights are near 1/7, so one bf16 rounding of a context product
    # that flips where the kernel's softmax sums in another order than the
    # plain one moves the context by 2^-8 of that product (an int8 code of
    # up to 127 times its weight and scale: 0.0039 measured on random
    # streams): the context within one bf16 ulp, ULP
    t_odd = 7
    if name == "lsa_attention":
        odd = (h_att, cum[:, :t_odd].contiguous(), stream_head(memory, t_odd),
               stream_head(mtb, t_odd), mask_add[:, :t_odd].contiguous(),
               bundle)
        got_o, ref_o = fd.lsa_attention(*odd), fd.lsa_attention_plain(*odd)
        base = odd[1]
    else:
        prev = state["weights"][:, :t_odd]
        odd = (h_att, (prev / prev.sum(-1, keepdim=True)).contiguous(),
               state.get("t_prob"), stream_head(memory, t_odd),
               stream_head(mtb, t_odd), mask_add[:, :t_odd].contiguous(), x,
               bundle)
        got_o, ref_o = fd.fwd_attention(*odd), fd.fwd_attention_plain(*odd)
        base = torch.zeros_like(ref_o[1])
    weights(f"{tag}, T={t_odd}", got_o[1], ref_o[1], base)
    context(f"{tag}, T={t_odd}", got_o[0], ref_o[0], ULP)
    if name == "fwd_attention":
        # also at a text bucket that is not a multiple of 16, whose padding
        # in the kernel must take part in neither the softmax nor the floor
        t_short = memory.shape[1] - 8
        prev = state["weights"][:, :t_short]
        short = (h_att, prev / prev.sum(-1, keepdim=True), state.get("t_prob"),
                 stream_head(memory, t_short), stream_head(mtb, t_short),
                 mask_add[:, :t_short], x, bundle)
        got_s, ref_s = fd.fwd_attention(*short), fd.fwd_attention_plain(*short)
        for w, label in ((got[1], ""), (got_s[1], f", T={t_short}")):
            off = float((w.sum(-1) - 1.0).abs().max())
            if off > SUM_TOL or float(w.min()) <= 0.0:
                fail(f"{name}[{tag}{label}]: weights not a floored "
                     f"distribution (sum off by {off}, least "
                     f"{float(w.min())})")
        weights(f"{tag}, T={t_short}", got_s[1], ref_s[1],
                torch.zeros_like(ref_s[1]))
        context(f"{tag}, T={t_short}", got_s[0], ref_s[0])
        if got[2] is not None:
            err = max(err, agent(tag, got[2], ref[2]),
                      agent(f"{tag}, T={t_short}", got_s[2], ref_s[2]))
        say(f"[kernels:{tag}] {name}: every row's weights sum to 1 within "
            f"{off:.3g} at T={t_short} (bound {SUM_TOL}), the least "
            f"{float(got[1].min()):.3g}" + ("" if got[2] is None else
               f"; t_prob within {max_err(got[2], ref[2]):.3g}"))
    return name, got[0], ref[0], err


def check_step(syn, hp, bundle, tag):
    """Each kernel of ``bundle``'s instances against its plain version on
    identical inputs at the main path's shapes (``encoded_batch``): masks
    and int8 activations bit-exact, the head row bit-exact, two runs
    bit-identical; bf16 outputs within ATOL (attention as
    ``check_attention_step``), float32 ones within F32_TOL of their largest
    value; then a 16-step chunk through the kernels against the plain
    chunk (relative error CHUNK_REL_TOL; float32 F32_CHUNK_TOL, by the
    gates).  Returns
    {kernel: max_abs_err}."""
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    f32 = bundle.dtype == torch.float32
    int8 = bundle.quantized
    kw = syn.decode_kwargs
    raw, mt, mask, carry = encoded_batch(syn, hp, bundle)
    seeds, step = (123456789, 987654321), 5
    memory, mtb, mask_add = fd.chunk_operands(bundle, raw, mt, mask)
    zh, zc = kw["zoneout_h"], kw["zoneout_c"]
    n_pre, p_dim = bundle.pre_dims[2], bundle.pre_dims[1]

    def value(name, got, ref):
        return close_f32(name, got, ref) if f32 else close(name, got, ref)

    keep_k = torch.zeros(n_pre, B, p_dim, dtype=torch.uint8, device="cuda")
    keep_p, keep_again = torch.zeros_like(keep_k), torch.zeros_like(keep_k)
    x_k = fd.prenet(carry["frame"], bundle, kw["dropout_rate"], seeds,
                    step, keep_out=keep_k)
    x_again = fd.prenet(carry["frame"], bundle, kw["dropout_rate"], seeds,
                        step, keep_out=keep_again)
    x = fd.prenet_plain(carry["frame"], bundle, kw["dropout_rate"], seeds,
                        step, keep_out=keep_p)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        fail(f"prenet[{tag}]: dropout masks differ")
    if not (torch.equal(x_k, x_again) and torch.equal(keep_k, keep_again)):
        fail(f"prenet[{tag}]: two runs on the same inputs differ")
    e_pre = value(f"prenet[{tag}]", x_k, x)

    segs_att = (x, carry["context"], carry["h_att"])
    k_att = sum(s.shape[1] for s in segs_att)
    q_k = torch.zeros(B, k_att, dtype=torch.int8, device="cuda")
    q_p = torch.zeros_like(q_k)
    hk, ck = fd.gate_lstm(segs_att, carry["h_att"], carry["c_att"], bundle,
                          "att", zh, zc, q_out=q_k if int8 else None)
    h_att, c_att = fd.gate_lstm_plain(segs_att, carry["h_att"],
                                      carry["c_att"], bundle, "att", zh,
                                      zc, q_out=q_p if int8 else None)
    torch.cuda.synchronize()
    if int8 and not torch.equal(q_k, q_p):
        fail(f"gate_lstm[{tag}]: int8 activations differ in "
             f"{int((q_k != q_p).sum())} places")
    e_gate = max(value(f"gate_lstm att h[{tag}]", hk, h_att),
                 value(f"gate_lstm att c[{tag}]", ck, c_att))

    # the head row, as a chunk fills it: the context from the attention
    # kernel, h_gen from the generator's gate_lstm, in the compute type
    hidden = h_att.shape[1]
    row = torch.zeros(B, bundle.head_w.shape[1], dtype=bundle.dtype,
                      device="cuda")
    att_name, ctx_k, ctx, e_att = check_attention_step(
        fd, bundle, tag, h_att, x, carry, memory, mtb, mask_add,
        row[:, hidden:hidden + memory.shape[2]])

    segs_gen = (h_att, ctx, carry["h_gen"])
    q_k = torch.zeros(B, sum(s.shape[1] for s in segs_gen),
                      dtype=torch.int8, device="cuda")
    q_p = torch.zeros_like(q_k)
    hk, ck = fd.gate_lstm(segs_gen, carry["h_gen"], carry["c_gen"], bundle,
                          "gen", zh, zc, q_out=q_k if int8 else None,
                          h_row=row[:, :hidden])
    h_gen, c_gen = fd.gate_lstm_plain(segs_gen, carry["h_gen"],
                                      carry["c_gen"], bundle, "gen", zh,
                                      zc, q_out=q_p if int8 else None)
    torch.cuda.synchronize()
    if int8 and not torch.equal(q_k, q_p):
        fail(f"gate_lstm gen[{tag}]: int8 activations differ in "
             f"{int((q_k != q_p).sum())} places")
    e_gate = max(e_gate, value(f"gate_lstm gen h[{tag}]", hk, h_gen),
                 value(f"gate_lstm gen c[{tag}]", ck, c_gen))

    want = fd.head_row(hk, ctx_k, bundle)
    if not torch.equal(row, want):
        fail(f"head row[{tag}]: differs from h_gen | context in the compute "
             f"type in {int((row != want).sum())} places")
    f_k, s_k = fd.head(hk, ctx_k, bundle, row=row)
    f_again, s_again = fd.head(hk, ctx_k, bundle, row=row)
    f_p, s_p = fd.head_plain(hk, ctx_k, bundle)
    torch.cuda.synchronize()
    if not (torch.equal(f_k, f_again) and torch.equal(s_k, s_again)):
        fail(f"head[{tag}]: two runs on the same row differ")
    e_head = max(value(f"head frame[{tag}]", f_k, f_p),
                 value(f"head stop[{tag}]", s_k, s_p))
    bounds = (f"{F32_TOL} of each output's largest value" if f32 else
              f"atol {ATOL}; context {CTX_TOL}; weights {W_TOL} of the row "
              "max")
    say(f"[kernels:{tag}] one step at B={B} T={T_SYMBOLS}: masks"
        f"{' and int8 activations' if int8 else ''} and the head row "
        f"bit-exact, two runs of the prenet, of {att_name} and of "
        f"the head bit-identical; max abs "
        f"err prenet {e_pre:.3g}, gate_lstm {e_gate:.3g}, "
        f"{att_name} {e_att:.3g}, head {e_head:.3g} ({bounds})")

    carry_k, (spec_k, stop_k) = fd.decode_chunk(
        bundle, carry, raw, mt, mask, seeds, 16, **kw)
    carry_p, (spec_p, stop_p) = fd.decode_chunk_plain(
        bundle, carry, raw, mt, mask, seeds, 16, **kw)
    chunk = {"spec": rel(spec_k, spec_p), "stop": rel(stop_k, stop_p)}
    if bundle.att_kind != "ls":
        # the carried state of the forward family: the last weights
        # (a distribution) and the transition agent's t_prob
        st_k, st_p = carry_k["att_state"], carry_p["att_state"]
        if set(st_k) != set(st_p):
            fail(f"16-step chunk[{tag}]: carried state {sorted(st_k)}")
        chunk.update({f"carried {k}": rel(st_k[k], st_p[k])
                      for k in st_p})
        off = float((st_k["weights"].sum(-1) - 1.0).abs().max())
        if off > SUM_TOL:
            fail(f"16-step chunk[{tag}]: carried weights sum to 1 "
                 f"within {off}")
    worst = max(chunk.values())
    bound = F32_CHUNK_TOL[int8] if f32 else CHUNK_REL_TOL
    if not (torch.isfinite(spec_k).all() and worst < bound):
        fail(f"16-step chunk[{tag}]: relative errors {chunk}")
    say(f"[kernels:{tag}] 16-step chunk: relative error " + ", ".join(
        f"{k} {v:.3g}" for k, v in chunk.items()) + f" (bound {bound})")
    return {"prenet": e_pre, "gate_lstm": e_gate, att_name: e_att,
            "head": e_head}


def phase_kernels(hp, sd, modes=(True, False)):
    """Each kernel against its plain version on identical inputs, with W8A8
    and bf16 gates (``modes``: int8 or not); returns {kernel: max_abs_err}
    for the W8A8 bundle (the main path's)."""
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    errs = {}
    for int8 in modes:
        hp.pallas_decoder_int8 = int8
        syn = Synthesizer(hp, sd, device="cuda")
        e = check_step(syn, hp, syn.bundle, "int8" if int8 else "bf16")
        if int8:
            errs = e
    hp.pallas_decoder_int8 = True
    return errs


def variant_bundle(syn, int8: bool, q8: bool):
    """``syn``'s weights as a bundle of its compute type with W8A8 or exact
    gates and int8 streams or not."""
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    return fd.extract_decoder_bundle(syn.model.decoder.cell, syn.dtype,
                                     quantize_gates=int8, q_streams=q8)


def phase_variant_kernels(syn, hp, variants):
    """``[kernels:f32]`` and ``[kernels:q8]``: ``check_step`` for each
    (int8 gates, int8 streams) of ``variants`` at ``syn``'s compute type;
    with int8 streams, first the codes and scales that ``chunk_operands``
    makes on the card against those it makes on the CPU, bit for bit.
    Returns {(int8, q8): {kernel: max_abs_err}}."""
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    out = {}
    for int8, q8 in variants:
        bundle = variant_bundle(syn, int8, q8)
        tag = ("int8" if int8 else "exact") + ("-q8" if q8 else "")
        if q8:
            memory, mt, mask, _ = encoded_batch(syn, hp, bundle)
            card = fd.chunk_operands(bundle, memory, mt, mask)
            cpu_bundle = variant_bundle(syn, int8, q8)
            cpu_bundle.att_bias = bundle.att_bias.cpu()
            host = fd.chunk_operands(cpu_bundle, memory.cpu(), mt.cpu(),
                                     mask.cpu())
            for which, c, h in zip(("memory", "mt + bias"), card[:2],
                                   host[:2]):
                n_q = int((c.q.cpu() != h.q).sum())
                n_s = int((c.scale.cpu() != h.scale).sum())
                if n_q or n_s:
                    fail(f"int8 streams[{tag}]: the card's {which} differs "
                         f"from the CPU's in {n_q} codes and {n_s} scales")
            say(f"[kernels:{tag}] int8 streams: codes and scales of the "
                f"memory [{B}, {T_SYMBOLS}, {memory.shape[2]}] and of mt + "
                "bias bit-exact with the CPU's quantization")
        out[(int8, q8)] = check_step(syn, hp, bundle, tag)
    return out


def mode_of(bundle) -> str:
    """The bundle's configuration in words, for the lines printed."""
    import torch

    return ", ".join([
        "float32" if bundle.dtype == torch.float32 else "bf16",
        "W8A8" if bundle.quantized else "exact gates"]
        + (["int8 streams"] if bundle.q_streams else []))


@contextlib.contextmanager
def cudnn_default():
    """cuDNN at PyTorch's default (TF32 allowed) inside the block, which
    this script otherwise turns off for its plain versions: a float32
    ``Synthesizer`` must keep its encode in float32 by itself."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def phase_main(hp, sd, small=None, full=True):
    """Synthesis of B lines through ``Synthesizer.synthesize_batch_lines``
    (``hp.max_output_length`` frames each), with the launch counts reset
    just before and read just after (every kernel instance of the bundle's
    path launched, no other); with ``full``, after a warm-up run and
    followed by an accent-blend batch; and, unless ``small`` is None, a
    small batch at the configuration ``small`` on the card against the CPU
    plain path (float32: with cuDNN at PyTorch's default)."""
    import numpy as np
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    syn = Synthesizer(hp, sd, device="cuda")
    lines = lines_for(hp, B // len(hp.languages), SEED + 2)
    if full:
        syn.synthesize_batch_lines(lines, seed=1)         # warm-up
    torch.cuda.synchronize()

    fd.reset_launch_counts()
    t0 = time.perf_counter()
    out = syn.synthesize_batch_lines(lines, seed=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fd.LAUNCHES)

    b = syn.bundle
    path = fd.path_kernels(b.att_kind, b.dtype, b.q_streams)
    if any(launches[k] == 0 for k in path) or any(
            launches[k] for k in launches if k not in path):
        fail(f"the main path's kernels {path}: launches {launches}")
    n_frames = hp.max_output_length
    if len(out) != B or any(o.shape != (hp.num_mels, n_frames)
                            or not np.isfinite(o).all() for o in out):
        fail("main path: wrong shapes or non-finite spectrograms")
    frames = B * n_frames
    say(f"[main] {B} streams x {n_frames} frames (chunk "
        f"{hp.decode_chunk_frames}, {mode_of(syn.bundle)}, memory width "
        f"{syn.model.decoder.memory_dim}): {frames} frames in {seconds:.4f} "
        f"s = {frames / seconds:.1f} mel frames/s = "
        f"{frames / 80.0 / seconds:.1f} audio-seconds/s (host clock"
        f"{', after a warm-up run' if full else ', no warm-up'})")
    say(f"[main] launches: { {k: v for k, v in launches.items() if v} }")
    if not full:
        return syn, launches, frames / seconds

    blend = lines_for(hp, 2, SEED + 3, blend=True)
    out_b = syn.synthesize_batch_lines(blend, seed=3)
    if any(not np.isfinite(o).all() or o.shape[0] != hp.num_mels
           for o in out_b):
        fail("accent-blend batch: bad output")
    say(f"[main] accent-blend batch of {len(blend)} lines: mixing path ok")
    if small is None:
        return syn, launches, frames / seconds

    # a small batch against the plain path on the CPU (the same compute
    # type there too)
    small_lines = lines_for(small, 1, SEED + 4)
    f32 = syn.dtype == torch.float32
    with cudnn_default() if f32 else contextlib.nullcontext():
        got = Synthesizer(small, sd, device="cuda").synthesize_batch_lines(
            small_lines, seed=4)
    ref = Synthesizer(small, sd, device="cpu").synthesize_batch_lines(
        small_lines, seed=4)
    errs = [float(np.linalg.norm(g - r) / np.linalg.norm(r))
            for g, r in zip(got, ref)]
    bound = F32_E2E_TOL if f32 else E2E_REL_TOL
    if f32:
        # what the port's own float32 guard (device.exact_float32) keeps
        # out: the same card run with cuDNN in TF32
        from multilingual_text_to_speech_tpu_torch import synthesis

        guard = synthesis.exact_float32
        synthesis.exact_float32 = contextlib.nullcontext
        try:
            with cudnn_default():
                tf32 = Synthesizer(small, sd, device="cuda"
                                   ).synthesize_batch_lines(small_lines,
                                                            seed=4)
        finally:
            synthesis.exact_float32 = guard
        tf32_err = max(float(np.linalg.norm(g - r) / np.linalg.norm(r))
                       for g, r in zip(tf32, ref))
        say(f"[main] the same {len(small_lines)} lines without the port's "
            "float32 guard (cuDNN in TF32) against the CPU: max relative "
            f"error {tf32_err:.3g}")
    if max(errs) > bound or any(g.shape != r.shape
                                for g, r in zip(got, ref)):
        fail(f"card vs CPU plain path: relative errors {errs}")
    say(f"[main] {len(small_lines)} lines x 32 frames, card kernels vs CPU "
        f"plain path ({mode_of(syn.bundle)}"
        f"{'; cuDNN at its TF32 default' if f32 else ''}): max relative "
        f"error {max(errs):.3g} (bound {bound})")
    return syn, launches, frames / seconds


def phase_checkpoint(hp, sd) -> None:
    """``[serve:checkpoint]``: the user's serving entry point from a file.
    The port writes a checkpoint of the flagship's seeded weights
    (``training.checkpoint.save_checkpoint``); ``Synthesizer.
    from_checkpoint`` restores it on the card, its state dict bit-identical
    to the one saved; CKPT_LINES lines through the restored synthesizer,
    with the launch counts reset just before and read just after (every
    kernel of the path launched, no other), give spectrograms bit-identical
    to an in-memory synthesizer's at the same seed; the synthesis CLI runs
    on CLI_LINES lines (``--batch_size 4 --save_spec``), its ``.npy`` files
    bit-identical to the restored synthesizer's and its WAVs ``hop * (F -
    1)`` samples at full scale; ``vocode_batch`` of VOCODE_B spectrograms
    of MAX_FRAMES frames is timed; and Griffin-Lim on the card is held
    against the CPU on VOCODE_CHECK_B of them from shared initial phases,
    at 10 iterations sample by sample and at 60 by spectral convergence."""
    import io
    import os
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from multilingual_text_to_speech_tpu_torch.cli import synthesize as cli
    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.ops import audio
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
    from multilingual_text_to_speech_tpu_torch.ops import mel, stft
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
    from multilingual_text_to_speech_tpu_torch.training import checkpoint

    lines = lines_for(hp, -(-CKPT_LINES // len(hp.languages)),
                      SEED + 5)[:CKPT_LINES]
    hop = audio.ms_to_frames(hp.stft_shift_ms, hp)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.ckpt")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, epoch=0, step=0, state_dict=sd,
                                   hp=hp,
                                   criterion_state={"guided_att_weight": 1.0})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = Synthesizer.from_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got_sd = restored.model.state_dict()
        if restored.device.type != "cuda" or set(got_sd) != set(sd):
            fail("from_checkpoint: not on the card, or other tensors")
        differ = [k for k, t in sd.items()
                  if not torch.equal(got_sd[k].cpu(), t)]
        if differ:
            fail(f"from_checkpoint: {len(differ)} tensors differ from the "
                 f"saved state dict, e.g. {differ[:3]}")
        say(f"[serve:checkpoint] saved {os.path.getsize(path) / 2**20:.1f} "
            f"MiB in {save_s:.3f} s; Synthesizer.from_checkpoint on the card"
            f" in {load_s:.3f} s (host clock, synchronized): {len(sd)} "
            "tensors bit-identical to the saved state dict")

        ref = Synthesizer(hp, sd, device="cuda").synthesize_batch_lines(
            lines, seed=7)
        torch.cuda.synchronize()
        fd.reset_launch_counts()
        specs = restored.synthesize_batch_lines(lines, seed=7)
        torch.cuda.synchronize()
        launches = dict(fd.LAUNCHES)
        b = restored.bundle
        kernels = fd.path_kernels(b.att_kind, b.dtype, b.q_streams)
        if any(launches[k] == 0 for k in kernels) or any(
                launches[k] for k in launches if k not in kernels):
            fail(f"restored synthesizer's kernels {kernels}: launches "
                 f"{launches}")
        if any(not np.array_equal(g, r) for g, r in zip(specs, ref)) or any(
                g.shape != (hp.num_mels, hp.max_output_length) for g in specs):
            fail("restored synthesizer: spectrograms differ from the "
                 "in-memory synthesizer's")
        say(f"[serve:checkpoint] {len(lines)} lines x "
            f"{hp.max_output_length} frames through the restored "
            "synthesizer: bit-identical to the in-memory one's; launches "
            f"{ {k: v for k, v in launches.items() if v} }")

        out_dir = os.path.join(tmp, "cli")
        stdin = sys.stdin
        sys.stdin = io.StringIO("\n".join(lines[:CLI_LINES]) + "\n")
        t0 = time.perf_counter()
        try:
            cli.main(["--checkpoint", path, "--output", out_dir,
                      "--batch_size", str(CLI_LINES), "--save_spec",
                      "--seed", "7"])
        finally:
            sys.stdin = stdin
        cli_s = time.perf_counter() - t0
        ref4 = restored.synthesize_batch_lines(lines[:CLI_LINES], seed=7)
        for line, r in zip(lines[:CLI_LINES], ref4):
            item = line.split("|")[0]
            spec = np.load(os.path.join(out_dir, f"{item}.npy"))
            rate, wav = wavfile.read(os.path.join(out_dir, f"{item}.wav"))
            if not np.array_equal(spec, r):
                fail(f"CLI: {item}.npy differs from the synthesizer's")
            if (rate != hp.sample_rate or wav.shape != (
                    hop * (spec.shape[1] - 1),)
                    or np.abs(wav.astype(np.int32)).max() != 32767):
                fail(f"CLI: {item}.wav has {wav.shape} samples at {rate} "
                     f"Hz, peak {np.abs(wav.astype(np.int32)).max()}")
        say(f"[serve:checkpoint] CLI --batch_size {CLI_LINES} --save_spec on "
            f"the card: {CLI_LINES} .npy (bit-identical) and WAVs of "
            f"{hop * (hp.max_output_length - 1)} samples at full scale in "
            f"{cli_s:.2f} s (host clock, model load included)")

    restored.vocode_batch(specs[:2], seed=1)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = restored.vocode_batch(specs[:VOCODE_B], seed=2)
    torch.cuda.synchronize()
    vocode_s = time.perf_counter() - t0
    if any(w.shape != (hop * (hp.max_output_length - 1),)
           or not np.isfinite(w).all() or w.max() != 1.0 for w in wavs):
        fail("vocode_batch: wrong lengths, non-finite or not peak-normalized")
    n_fft, win = hp.num_fft, audio.ms_to_frames(hp.stft_window_ms, hp)
    batch = torch.as_tensor(np.stack(specs[:VOCODE_B]), device="cuda")
    mag = mel.mel_to_linear_nnls(mel.db_to_amplitude(batch), hp.sample_rate,
                                 n_fft, hp.num_mels) ** hp.griffin_lim_power
    gl_ms = cuda_ms(lambda: stft.griffin_lim(
        mag, n_fft, hop, win, n_iter=hp.griffin_lim_iters,
        generator=torch.Generator("cuda").manual_seed(0)), iters=3,
        warmup=1)
    audio_s = VOCODE_B * hop * (hp.max_output_length - 1) / hp.sample_rate
    say(f"[serve:checkpoint] vocode_batch of {VOCODE_B} x "
        f"{hp.max_output_length} frames (n_fft {n_fft}, hop {hop}, "
        f"{hp.griffin_lim_iters} iterations) on the card: {vocode_s:.4f} s "
        f"(host clock, synchronized, NNLS, de-emphasis and copies included)"
        f" = {audio_s / vocode_s:.1f} audio-seconds/s; Griffin-Lim alone "
        f"{gl_ms:.3f} ms (CUDA events)")

    # the card against the CPU from the same initial phases
    pair = np.stack(specs[:VOCODE_CHECK_B])
    angles = stft.random_angles((VOCODE_CHECK_B, n_fft // 2 + 1,
                                 pair.shape[2]),
                                torch.Generator().manual_seed(SEED), "cpu")
    target = mel.mel_to_linear_nnls(
        mel.db_to_amplitude(torch.from_numpy(pair)), hp.sample_rate, n_fft,
        hp.num_mels) ** hp.griffin_lim_power
    for n_iter in (10, 60):
        hp_n = HParams.from_state_dict(hp.state_dict())
        hp_n.griffin_lim_iters = n_iter
        card, cpu = (audio.inverse_spectrogram_batch(
            pair, hp_n, mel=True, angles=angles, device=dev)
            for dev in ("cuda", "cpu"))
        if n_iter <= 10:
            errs = [float(np.abs(c - r).max() / np.abs(r).max())
                    for c, r in zip(card, cpu)]
            if max(errs) > GL_TOL:
                fail(f"Griffin-Lim card vs CPU at {n_iter} iterations: "
                     f"{errs} of the peak (bound {GL_TOL})")
            say(f"[serve:checkpoint] Griffin-Lim card vs CPU, {n_iter} "
                f"iterations, shared phases: max |diff| "
                f"{max(errs):.3g} of the peak (bound {GL_TOL})")
        else:
            if hp.use_preemphasis:      # undo the de-emphasis
                card, cpu = (audio.preemphasis(y, hp.preemphasis)
                             for y in (card, cpu))
            sc = [stft.spectral_convergence(torch.from_numpy(y), target,
                                            n_fft, hop, win).numpy()
                  for y in (card, cpu)]
            diff = float(np.abs(sc[0] - sc[1]).max())
            if diff > SC_TOL:
                fail(f"Griffin-Lim card vs CPU at {n_iter} iterations: "
                     f"spectral convergence {sc} (bound {SC_TOL})")
            say(f"[serve:checkpoint] Griffin-Lim card vs CPU, {n_iter} "
                f"iterations: spectral convergence {sc[0].tolist()} vs "
                f"{sc[1].tolist()}, max |diff| {diff:.3g} (bound {SC_TOL})")


def phase_timings(hp, syn, errs, launches, only=None, chunk=True):
    """Device times of each kernel of ``syn``'s bundle (of ``only``, when
    given), its plain version and its library yardstick (``device_ms``),
    then, with ``chunk``, CUDA-event times of a decode step and chunk, at
    the main path's shapes.  A row is named by the kernel's instance
    (``fused_decoder.instance``), and a row of a labelled phase carries its
    label in its name."""
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    bundle, kw = syn.bundle, syn.decode_kwargs
    memory, mt, mask, carry = encoded_batch(syn, hp, bundle)
    raw = memory
    memory, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    seeds, zh, zc = (1, 2), kw["zoneout_h"], kw["zoneout_c"]
    hidden = carry["h_att"].shape[1]
    m_dim = memory.shape[2]
    a_dim = bundle.wq.shape[1]
    k_taps = 0 if bundle.lc is None else bundle.lc.shape[0]
    in_dim, p_dim, n_pre = bundle.pre_dims
    att_name = fd.path_kernels(bundle.att_kind)[2]
    agent = bundle.att_kind == "fwd_trans"
    f32 = bundle.dtype == torch.float32
    x = fd.prenet_plain(carry["frame"], bundle, kw["dropout_rate"], seeds, 0)
    segs_att = (x, carry["context"], carry["h_att"])
    segs_gen = (carry["h_att"], carry["context"], carry["h_gen"])
    k_att, k_gen = p_dim + m_dim + hidden, 2 * hidden + m_dim
    n_head = bundle.head_w.shape[0]
    # the kernels as a chunk runs them: the generator's gate_lstm and
    # the attention kernel write the head row, and the head reads it
    row = fd.head_row(carry["h_gen"], carry["context"], bundle)
    gen_row, ctx_row = row[:, :hidden], row[:, hidden:hidden + m_dim]

    def gates(f, **gen_kw):
        return (f(segs_att, carry["h_att"], carry["c_att"], bundle, "att", zh,
                  zc),
                f(segs_gen, carry["h_gen"], carry["c_gen"], bundle, "gen", zh,
                  zc, **gen_kw))

    def attend(f, **kw_row):
        state = carry["att_state"]
        if att_name == "fwd_attention":
            return f(carry["h_att"], state["weights"], state.get("t_prob"),
                     memory, mtb, mask_add, x, bundle, **kw_row)
        return f(carry["h_att"], state["weights"], memory, mtb, mask_add,
                 bundle, **kw_row)

    calls = {   # (kernel call, plain call)
        "prenet": (lambda: fd.prenet(carry["frame"], bundle,
                                     kw["dropout_rate"], seeds, 0),
                   lambda: fd.prenet_plain(carry["frame"], bundle,
                                           kw["dropout_rate"], seeds, 0)),
        "gate_lstm": (lambda: gates(fd.gate_lstm, h_row=gen_row),
                      lambda: gates(fd.gate_lstm_plain)),
        att_name: (lambda: attend(getattr(fd, att_name), ctx_row=ctx_row),
                   lambda: attend(getattr(fd, att_name + "_plain"))),
        "head": (lambda: fd.head(carry["h_gen"], carry["context"], bundle,
                                 row=row),
                 lambda: fd.head_plain(carry["h_gen"], carry["context"],
                                       bundle)),
    }
    # bytes of an element: float32 4; the compute type; the streams (int8
    # with their scale rows); the type whose peak rate bounds a product
    f4 = 4
    es = bundle.head_w.element_size()
    ss = 1 if bundle.q_streams else es
    scales = (m_dim * f4 + a_dim * es) if bundle.q_streams else 0
    kind = "f32" if f32 else "bf16"
    # (bytes each input once + outputs once, operations, type[, the
    # products' operations: the query's, and the location conv's band])
    work = {
        "prenet": (B * in_dim * f4 + (in_dim + (n_pre - 1) * p_dim) * p_dim
                   * es + n_pre * p_dim * f4 + B * p_dim * f4,
                   2 * B * (in_dim + (n_pre - 1) * p_dim) * p_dim, kind),
        # both LSTMs: concat rows (h read there), gate weights (unpadded),
        # scales and biases, c read, h and c written
        "gate_lstm": (B * (k_att + k_gen) * f4
                      + (k_att + k_gen) * 4 * hidden
                      * bundle.att_w.element_size()
                      + 2 * 2 * 4 * hidden * f4 + 2 * 3 * B * hidden * f4,
                      2 * B * (k_att + k_gen) * 4 * hidden,
                      "int8" if bundle.quantized else kind),
        "lsa_attention": (B * hidden * f4 + 2 * B * T_SYMBOLS * f4
                          + B * T_SYMBOLS * (m_dim + a_dim) * ss + scales
                          + B * T_SYMBOLS * f4 + hidden * a_dim * es
                          + k_taps * a_dim * es + a_dim * f4
                          + B * m_dim * f4,
                          2 * B * (hidden * a_dim + T_SYMBOLS * a_dim
                                   * (k_taps + 1) + T_SYMBOLS * m_dim),
                          kind, 2 * B * (hidden * a_dim
                                         + T_SYMBOLS * a_dim * k_taps)),
        # h_att, the last weights, memory, mtb and mask read, Wq and v; the
        # weights and the context written; with the transition agent, its
        # t_prob in and out, the prenet output and its weights
        "fwd_attention": (B * hidden * f4 + 2 * B * T_SYMBOLS * f4
                          + B * T_SYMBOLS * (m_dim + a_dim) * ss + scales
                          + B * T_SYMBOLS * f4 + hidden * a_dim * es
                          + a_dim * f4 + B * m_dim * f4
                          + (2 * B * f4 + B * p_dim * f4
                             + (m_dim + hidden + p_dim) * es + f4
                             if agent else 0),
                          2 * B * (hidden * a_dim + T_SYMBOLS * a_dim
                                   + T_SYMBOLS * m_dim
                                   + (m_dim + hidden + p_dim if agent
                                      else 0)),
                          kind, 2 * B * hidden * a_dim),
        # the head row, the weight, the bias, frame and stop out
        "head": (B * (hidden + m_dim) * es + (hidden + m_dim) * n_head * es
                 + n_head * f4 + B * n_head * f4,
                 2 * B * (hidden + m_dim) * n_head, kind),
    }
    # the library yardsticks: torch._int_mm (K a multiple of 8: the
    # kernels' zero-padded K) for W8A8 gates, torch.addmm in the compute
    # type for exact gates (float32 in full float32: TF32 is off) and the
    # head
    wa, wg = bundle.att_w.t(), bundle.gen_w.t()          # [K_pad, 4H]
    if bundle.quantized:
        qa = torch.randint(-127, 128, (B, wa.shape[0]), dtype=torch.int8,
                           device="cuda")
        qg = torch.randint(-127, 128, (B, wg.shape[0]), dtype=torch.int8,
                           device="cuda")
        gate_lib = lambda: (torch._int_mm(qa, wa), torch._int_mm(qg, wg))
    else:
        ra = torch.randn(B, wa.shape[0], device="cuda").to(bundle.dtype)
        rg = torch.randn(B, wg.shape[0], device="cuda").to(bundle.dtype)
        ba, bg = (bundle.att_b.to(bundle.dtype), bundle.gen_b.to(bundle.dtype))
        gate_lib = lambda: (torch.addmm(ba, ra, wa), torch.addmm(bg, rg, wg))
    head_bias = bundle.head_b.to(bundle.dtype)
    library = {"gate_lstm": gate_lib,
               "head": lambda: torch.addmm(head_bias, row, bundle.head_w.t())}

    rows = []
    for name, (kernel, plain) in calls.items():
        if only is not None and name not in only:
            continue
        if name in TURN_ROWS:
            ms, plain_ms, turns, events = turns_ms(kernel, plain)
            events += ", in turns with plain: " + ", ".join(
                f"{x:.4f}" for x in turns)
        else:
            ms = device_ms(kernel, ours_only=True)
            events = events_note()
            plain_ms = device_ms(plain, iters=5)
        lib_ms = device_ms(library[name]) if name in library else None
        n_bytes, ops, op_kind, *mm_ops = work[name]
        b_ms, b_by, ffma = row_bound(name, n_bytes, ops, op_kind, *mm_ops)
        inst = fd.instance(name, bundle.dtype, bundle.q_streams)
        if name == att_name:
            # the launch's clusters of 8 rows that the card holds at once
            resident = fd.attention_clusters(
                bundle.att_kind, bundle.dtype, bundle.q_streams, B,
                T_SYMBOLS, hidden, a_dim, m_dim)
            events += f", clusters resident {resident} of {-(-B // 8)}"
        rows.append({
            "name": f"{inst}[{_LABEL}]" if _LABEL else inst, "route": "cuda",
            "source": "multilingual_text_to_speech_tpu_torch/csrc/"
                      "fused_decoder.cu",
            "replaces": "multilingual_text_to_speech_tpu/ops/"
                        "pallas_decoder.py:380",
            "launches": launches[inst], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
        })
        say(f"[time] {inst} (device time, torch.profiler): kernel "
            f"{ms:.4f} ms ({events}), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}, "
            f"{row_ops(name, ops, op_kind, *mm_ops)[0][1]}){ffma}, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    if not chunk:
        return rows

    step_ms = cuda_ms(lambda: fd.decode_chunk(
        bundle, carry, raw, mt, mask, seeds, 1, **kw), iters=50)
    chunk_ms = cuda_ms(lambda: fd.decode_chunk(
        bundle, carry, raw, mt, mask, seeds, CHUNK, **kw), iters=3,
        warmup=1)
    plain_chunk_ms = cuda_ms(lambda: fd.decode_chunk_plain(
        bundle, carry, raw, mt, mask, seeds, CHUNK, **kw), iters=2,
        warmup=1)
    say(f"[time] decode step (B={B}, T={T_SYMBOLS}, {mode_of(bundle)}): "
        f"{step_ms:.4f} ms; {CHUNK}-step chunk: kernels {chunk_ms:.3f} ms, "
        f"plain {plain_chunk_ms:.3f} ms")
    # a chunk reads its weights and attention operands once and writes its
    # frames once; its products run at their types' peaks, one after the
    # other
    step_ops_s = sum(n / PEAK_OPS[k]
                     for name, (_, ops, kind, *mm) in work.items()
                     if name in calls for n, k in row_ops(name, ops, kind,
                                                          *mm))
    chunk_bytes = ((k_att + k_gen) * 4 * hidden * bundle.att_w.element_size()
                   + B * T_SYMBOLS * (m_dim + a_dim) * ss
                   + B * CHUNK * n_head * f4)
    say(f"[bound] decode step: {step_ops_s * 1e3:.5f} ms (operations); "
        f"{CHUNK}-step chunk: operations {CHUNK * step_ops_s * 1e3:.4f} "
        f"ms, bytes {chunk_bytes / HBM_BYTES_S * 1e3:.4f} ms "
        f"({chunk_bytes / 1e6:.1f} MB)")
    phase_profile(lambda steps: fd.decode_chunk(
        bundle, carry, raw, mt, mask, seeds, steps, **kw))
    return rows


def phase_shared_streams(sd) -> None:
    """``[kernels:q8]`` at the shared strategy's 548-wide memory (int8 rows
    of 548 bytes): ``phase_variant_kernels`` on int8 streams in bf16 and
    float32, W8A8, for the weights ``sd`` of that strategy; then each
    instance's ``lsa_attention`` timed there (``phase_timings``, its row
    printed and not kept: no main run of this configuration counts its
    launches)."""
    import collections

    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    for cfg in (Q8, F32_Q8):
        hp = switching("shared", 32, 16)
        for k, v in cfg.items():
            setattr(hp, k, v)
        syn = Synthesizer(hp, sd, device="cuda")
        errs = phase_variant_kernels(syn, hp, [(True, True)])
        phase_timings(hp, syn, errs[(True, True)],
                      collections.defaultdict(int), only=("lsa_attention",),
                      chunk=False)
        del syn


def check_wide_streams(syn, hp, bundle, mem_dim: int = 548) -> None:
    """The forward family's attention kernel on the streams of ``bundle``
    (int8, or float32 for a float32 bundle without ``q_streams``) of the
    shared strategy's ``mem_dim``-wide memory (int8 rows of 548 bytes: not
    a multiple of 16), which no model of the family has: ``bundle`` with a
    random agent context weight of that width, random memory and memory
    transform (quantized) by ``chunk_operands``, the step's state from
    ``encoded_batch``; held as ``check_attention_step`` holds it, and timed
    in turns with the plain version (``[time:E=548]``)."""
    import dataclasses

    import torch

    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    _, mt, mask, carry = encoded_batch(syn, hp, bundle)
    memory = torch.randn(B, T_SYMBOLS, mem_dim, device="cuda", generator=gen)
    wide = dataclasses.replace(bundle, ta_wc=None if bundle.ta_wc is None
                               else (torch.randn(mem_dim, device="cuda",
                                                 generator=gen)
                                     * mem_dim ** -0.5).to(bundle.dtype))
    memory, mtb, mask_add = fd.chunk_operands(wide, memory.to(bundle.dtype),
                                              mt, mask)
    h_att = carry["h_att"]
    x = torch.relu(torch.randn(B, bundle.pre_dims[1], device="cuda",
                               generator=gen))
    row = torch.zeros(B, mem_dim, dtype=bundle.dtype, device="cuda")
    name, _, _, err = check_attention_step(fd, wide, f"E={mem_dim}", h_att,
                                           x, carry, memory, mtb, mask_add,
                                           row)
    q8 = bool(bundle.q_streams)
    streams = "int8 streams" if q8 else "float32 streams"
    say(f"[kernels:E={mem_dim}] {name} on {streams} of a {mem_dim}-wide "
        f"memory: max abs err {err:.3g}")
    # its device time there, in turns with the plain version
    state = carry["att_state"]
    args = (h_att, state["weights"], state.get("t_prob"), memory, mtb,
            mask_add, x, wide)
    ms, plain_ms, turns, events = turns_ms(
        lambda: fd.fwd_attention(*args), lambda: fd.fwd_attention_plain(*args))
    say(f"[time:E={mem_dim}] {fd.instance(name, bundle.dtype, q8)} on "
        f"{streams} of a {mem_dim}-wide memory (B={B}, T={T_SYMBOLS}): "
        f"kernel {ms:.4f} ms ({events}, in turns: "
        + ", ".join(f"{t:.4f}" for t in turns) + f"), plain {plain_ms:.4f} "
        "ms")


def phase_k1_variants(sd, kind: str = "location_sensitive"):
    """K1's float32 instances (V4's K1 half) and int8 streams (V5) at the
    flagship's widths for attention ``kind``.  ``[kernels:f32]``,
    ``[kernels:q8]``, ``[kernels:f32-q8]``: every stage of each instance
    against its plain version (``check_step``; location-sensitive float32
    with W8A8 and exact gates; the family's also on 548-wide int8 streams,
    ``check_wide_streams``).  Then the main path of each configuration
    with the launch counts reset just before and read just after: at
    location-sensitive attention ``[main:f32]`` (float32, W8A8: 240 lines x
    256 frames, the card against the CPU) and ``[main:q8]`` (bf16, int8
    streams, the same), and 240 lines x LAUNCH_FRAMES for the exact gates
    and float32 streams; for the family 240 x LAUNCH_FRAMES of each.  Each
    new instance is timed (``phase_timings``).  Returns the kernel rows."""
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    ls = kind == "location_sensitive"
    fam = "" if ls else ":" + FAMILY[kind]
    att = "lsa_attention" if ls else "fwd_attention"
    errs = {}
    for cfg, label in ((F32, "f32"), (Q8, "q8"), (F32_Q8, "f32-q8")):
        q8 = cfg is not F32
        variants = [(True, q8)] + ([(False, False)] if cfg is F32 and ls
                                   else [])
        with labelled(label + fam), phase("kernels"):
            hp = flagship(LAUNCH_FRAMES, LAUNCH_FRAMES, kind, **cfg)
            syn = Synthesizer(hp, sd, device="cuda")
            for v, e in phase_variant_kernels(syn, hp, variants).items():
                errs[(label, v[0])] = e
            if not ls:
                # int8 streams, and the float32 instance's float32 ones
                check_wide_streams(syn, hp, variant_bundle(syn, True, q8))
            del syn

    rows = []
    # (label, settings, frames, small card-vs-CPU batch, timed kernels,
    # the rows' label, errs key)
    runs = [("f32", F32, LAUNCH_FRAMES, False, (att,), FAMILY.get(kind, ""),
             ("f32", True)),
            ("q8", Q8, LAUNCH_FRAMES, False, (att,), FAMILY.get(kind, ""),
             ("q8", True)),
            ("f32-q8", F32_Q8, LAUNCH_FRAMES, False, (att,),
             FAMILY.get(kind, ""), ("f32-q8", True))]
    if ls:
        runs = [("f32", F32, FAMILY_FRAMES, True, None, "", ("f32", True)),
                ("f32-exact", F32_EXACT, LAUNCH_FRAMES, False,
                 ("gate_lstm",), "exact", ("f32", False)),
                ("q8", Q8, FAMILY_FRAMES, True, (att,), "", ("q8", True)),
                ("f32-q8", F32_Q8, LAUNCH_FRAMES, False, (att,), "",
                 ("f32-q8", True))]
    for label, cfg, frames, full, only, row_label, key in runs:
        with labelled(label + fam), phase("main"):
            hp = flagship(frames, min(frames, CHUNK), kind, **cfg)
            syn, launches, _ = phase_main(
                hp, sd, flagship(32, 16, kind, **cfg) if full else None,
                full=full)
        with labelled(row_label), phase("time"):
            rows += phase_timings(hp, syn, errs[key], launches, only=only,
                                  chunk=only is None)
        del syn
    return rows


def phase_profile(decode) -> None:
    """Where a decode step's time goes: the host's enqueue time against the
    device time of one chunk (CUDA events), and the device's busy share and
    kernel time by name over 32 steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    decode(CHUNK)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    say(f"[profile] {CHUNK}-step chunk: host enqueue {host_ms:.3f} ms, "
          f"device {start.elapsed_time(end):.3f} ms (CUDA events)")

    steps = 32
    decode(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode(steps)
        torch.cuda.synchronize()
    busy = device_busy(prof)
    if busy is None:
        say("[profile] device busy share: not measured (the profiler "
              "recorded no device events)")
        return
    share, window, by_name = busy
    say(f"[profile] {steps}-step chunk under torch.profiler: device busy "
          f"{share:.4f} of {window / 1e3:.3f} ms from first to last "
          f"kernel; device us per step by kernel: " + ", ".join(
              f"{k} {v / steps:.2f}" for k, v in
              sorted(by_name.items(), key=lambda kv: -kv[1])))
    prenet_us = sum(v for k, v in by_name.items()
                    if k.startswith("prenet_tile_kernel")) / steps
    say(f"[profile] prenet inside the chunk: {prenet_us:.2f} us a step "
          f"(device time, torch.profiler)")


def device_busy(prof):
    """(busy share of the window from the first to the last kernel, the
    window in us, device us by kernel name) of a ``torch.profiler`` run, or
    None when it recorded no device events."""
    import torch

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for e in kernels:
        name = (e.name.replace("(anonymous namespace)::", "")
                .split("(")[0].removeprefix("void ")[:48])
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
    return busy / window, window, by_name


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

TRAIN_SOURCE = ("multilingual_text_to_speech_tpu_torch/csrc/"
                "fused_train_decoder.cu")
REPLACES = {
    "K2": "multilingual_text_to_speech_tpu/ops/pallas_train_decoder.py:298",
    "K3": "multilingual_text_to_speech_tpu/ops/pallas_train_decoder.py:579"}


def train_batch(hp, b: int, t: int, f: int, seed: int):
    """A language-interleaved batch (sample k*g + j has language j) of
    random texts and mel targets, lengths drawn as bench.py's
    ``_make_batch`` draws them; with ``hp.predict_linear`` also linear
    targets (from a generator of their own, so that the rest of the batch
    is the one without them)."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.training.trainer import Batch

    rng = np.random.RandomState(seed)
    text = rng.randint(3, hp.total_symbols(), (b, t))
    lengths = np.clip(rng.randint(t // 2, t + 1, b), 2, t)
    text[np.arange(t)[None] >= lengths[:, None]] = 0
    mels = rng.randn(b, f, hp.num_mels).astype(np.float32)
    flen = np.clip(rng.randint(f // 2, f + 1, b), 8, f)
    mels[np.arange(f)[None] >= flen[:, None]] = 0.0
    stop = np.ones((b, f), np.float32)
    for i, n in enumerate(flen):
        stop[i, :max(int(n) - hp.stop_frames, 0)] = 0.0
    linear = None
    if hp.predict_linear:
        linear = np.random.RandomState(seed + 1).randn(
            b, f, hp.num_fft // 2 + 1).astype(np.float32)
        linear[np.arange(f)[None] >= flen[:, None]] = 0.0
    return Batch(text, lengths, mels, linear, flen, stop,
                 rng.randint(0, hp.speaker_number, b),
                 np.arange(b) % hp.language_number)


def compute_type(hp):
    """The torch dtype of ``hp.compute_dtype``."""
    import torch

    return torch.float32 if hp.compute_dtype == "float32" else torch.bfloat16


def dtype_label(d) -> str:
    import torch

    return "float32" if d == torch.float32 else "bf16"


def train_model(hp, sd, device="cuda", dropout=True):
    from multilingual_text_to_speech_tpu_torch.models.tacotron import Tacotron

    model = Tacotron(hp, compute_type(hp))
    model.load_state_dict(sd)
    if not dropout:
        for m in model.modules():
            if hasattr(m, "dropout"):
                m.dropout = 0.0
    return model.to(device).train()


def decoder_inputs(hp, model, batch, f: int):
    """The training decode's operands and inputs at the batch's shapes, as
    ``TrainDecode`` builds them: compute-type operands, memory, memory
    transform plus bias, additive mask, shifted targets [F, B, M]."""
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    dev, d = "cuda", model.dtype
    text = torch.as_tensor(batch.utterances, device=dev)
    lengths = torch.as_tensor(batch.utterance_lengths, device=dev)
    t = text.shape[1]
    with torch.no_grad():
        emb = model.embedding(text) * (text != 0)[..., None]
        enc = model.encoder(emb.to(d), lengths).float()
        langs = torch.as_tensor(batch.languages, device=dev)[:, None].expand(
            -1, t)
        memory, mt = model.decoder.prepare_memory(
            enc, torch.as_tensor(batch.speakers, device=dev), langs)
        cfg = ftd.TrainConfig.from_hp(hp, model.decoder.memory_dim, d)
        ops = ftd.compute_operands(
            ftd.train_operands(model.decoder.cell, cfg), cfg)
        mtb = (mt.float() + model.decoder.cell.attention.energy_bias).to(d)
    valid = torch.arange(t, device=dev)[None] < lengths[:, None]
    mask_add = torch.where(valid, 0.0, -1e9).float()
    mels = torch.as_tensor(batch.mel_spectrograms[:, :f], device=dev)
    shifted = torch.cat([torch.zeros_like(mels[:, :1]), mels[:, :-1]], 1)
    return (cfg, ops, memory.contiguous(), mtb.contiguous(), mask_add,
            shifted.transpose(0, 1).to(d).contiguous())


def mask_patterns(k, cfg, ops, st, shifted, seeds, step):
    """The dropout and zoneout choices of ``step`` made visible, through the
    functions ``k`` (``ftd.KERNELS`` or ``ftd.PLAIN``): prenet zeros with
    the biases raised by 100 (so no ReLU zeroes a unit), and the LSTMs'
    keep-old (zoneout) or dropped (dropout) units with both carries at 7
    (|h_new| < 1)."""
    import torch

    b = shifted.shape[1]
    dev, d = shifted.device, cfg.dtype

    def e(*shape):
        return torch.zeros(*shape, dtype=d, device=dev)

    pre = e(cfg.n_prenet, b, cfg.prenet_dim)
    k.train_prenet(shifted[step], st["spec"][step - 1], 1,
                   dict(ops, pre_b=ops["pre_b"] + 100.0), cfg, seeds, step,
                   e(b, cfg.mmel), pre, e(b, cfg.prenet_dim))
    out = [pre == 0]
    for which in ("att", "gen"):
        h = torch.full((b, cfg.hidden), 7.0, device=dev)
        c = torch.full_like(h, 7.0)
        k.train_gate_lstm(st[f"{which}_in"][step], ops[f"{which}_w"],
                          ops[f"{which}_b"], cfg.reg(which, seeds, step), h,
                          c, e(b, 4 * cfg.hidden), e(b, cfg.hidden),
                          e(b, cfg.hidden), None)
        out += [(h == 7.0) | (h == 0.0), c == 7.0]
    return out


def train_kernel_calls(ftd, cfg, ops, memory, mtb, mask_add, shifted, st,
                       teacher, seeds, cts, s: int):
    """For each K2/K3 kernel, ``run(k) -> [outputs]`` through the functions
    ``k`` (``ftd.KERNELS`` or ``ftd.PLAIN``) on fixed inputs taken from a
    plain run's streams at step ``s`` (random cotangents where the backward
    needs them), at the main path's shapes."""
    import torch

    b, t_len = memory.shape[:2]
    h, p, m, mem, a = (cfg.hidden, cfg.prenet_dim, cfg.mmel, cfg.mem_dim,
                       cfg.att_dim)
    dev, ct, f32 = memory.device, cfg.dtype, torch.float32
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def e(*shape, dtype=ct):
        return torch.empty(*shape, dtype=dtype, device=dev)

    frame = st["spec"][s - 1].contiguous()
    h_prev = {"att": st["gen_in"][s - 1][:, :h].float(),
              "gen": st["head_in"][s - 1][:, :h].float()}
    c_prev = {w: st[f"c_{w}"][s - 1].float() for w in ("att", "gen")}
    q = ftd.train_query_plain(st["gen_in"][s][:, :h], ops["wq"]).contiguous()
    cum = st["cum"][s].float()
    dframe, dh_gen, dctx = rnd(b, m), rnd(b, h, scale=0.1), rnd(b, mem)
    dh, dc = rnd(b, h, scale=0.1), rnd(b, h, scale=0.1)
    dg = {w: (rnd(b, 4 * h, scale=0.01)).to(ct) for w in ("att", "gen")}
    dq = rnd(b, a, scale=0.1).to(ct)
    dcum, dx = rnd(b, t_len, scale=0.1), rnd(b, p, scale=0.1)
    dtp = rnd(b, scale=0.5)
    dspec, dstop, dw = (x[s] for x in cts)

    def prenet(k):
        out = [e(b, m), e(cfg.n_prenet, b, p), e(b, p)]
        k.train_prenet(shifted[s], frame, teacher[s], ops, cfg, seeds, s,
                       *out)
        return out

    def gates(k):
        outs = []
        for w in ("att", "gen"):
            hh, cc = h_prev[w].clone(), c_prev[w].clone()
            o = [e(b, 4 * h), e(b, h), e(b, h)]
            k.train_gate_lstm(st[f"{w}_in"][s], ops[f"{w}_w"], ops[f"{w}_b"],
                              cfg.reg(w, seeds, s), hh, cc, *o, None)
            outs += [hh, cc, *o]
        return outs

    def query(k):
        out = e(b, a, dtype=f32)
        k.train_query(st["gen_in"][s][:, :h], ops["wq"], out)
        return [out]

    def attention(k):
        cc, ctx = cum.clone(), e(b, mem, dtype=f32)
        o = [e(b, t_len, dtype=f32), e(b, t_len)]
        dsts = (e(b, mem), e(b, mem), None)
        agent, extra = None, []
        if cfg.agent:
            # the step's own h_att and prenet output (their streams)
            extra = [st["tp"][s - 1].clone(), e(b, dtype=f32)]
            agent = ftd.AgentArgs(
                extra[0], extra[1],
                st["gen_in"][s][:, :h].float().contiguous(),
                st["pre"][cfg.n_prenet - 1][s].float().contiguous(),
                ops["ta_w"], ops["ta_b"])
        k.train_attention(q, cc, memory, mtb, mask_add, ops.get("lc"),
                          ops["v"], *o, ctx, dsts, agent=agent)
        return [cc, ctx, *o, dsts[0], *extra]

    def head(k):
        o = [e(b, m, dtype=f32), e(b, dtype=f32), e(b, m, dtype=f32)]
        k.train_head(st["head_in"][s], ops["head_w"], ops["head_b"], *o)
        return o

    def cell_args(w):
        return ftd.CellArgs(st[f"act_{w}"][s], st[f"c_{w}"][s - 1],
                            dc.clone(), e(b, 4 * h), e(b, h, dtype=f32),
                            cfg.reg(w, seeds, s))

    def head_with_cell(k, cell):
        o = [e(b, m), e(b, mem, dtype=f32)]
        k.bwd_head(dspec, dstop, dframe, ops["head_w"], o[0], dh_gen, dctx,
                   None if cell else e(b, h, dtype=f32), o[1], cfg,
                   cell=cell_args("gen") if cell else None)
        return o

    def dq_with_cell(k, cell):
        if not cell:
            out = dh.clone()
            k.bwd_gemm(dq, ops["wq"], False, [(0, h, out, out)])
            return [out]
        c = cell_args("att")
        k.bwd_gemm(dq, ops["wq"], False, [(0, h, None, dh)], cell=c)
        return [c.dc, c.dg, c.dh_reg]

    # as on the training path: the generator cell in bwd_head's epilogue
    # (its head outputs; the cell's are bwd_cell's), the attention cell in
    # the dq product's
    def bwd_head(k):
        return head_with_cell(k, True)

    def bwd_cell(k):
        outs = []
        for w in ("gen", "att"):
            c = cell_args(w)
            if w == "gen":
                k.bwd_head(dspec, dstop, dframe, ops["head_w"], e(b, m),
                           dh_gen, dctx, None, e(b, mem, dtype=f32), cfg,
                           cell=c)
            else:
                k.bwd_gemm(dq, ops["wq"], False, [(0, h, None, dh)], cell=c)
            outs += [c.dc, c.dg, c.dh_reg]
        return outs

    def bwd_gemm(k):
        o = [e(b, h, dtype=f32), dctx.clone(), e(b, h, dtype=f32),
             e(b, p, dtype=f32), e(b, mem, dtype=f32), e(b, h, dtype=f32)]
        k.bwd_gemm(dg["gen"], ops["gen_w"], True,
                   [(0, h, o[0], dh), (h, h + mem, o[1], o[1]),
                    (h + mem, 2 * h + mem, o[2], dh)])
        dq_with_cell(k, True)
        k.bwd_gemm(dg["att"], ops["att_w"], True,
                   [(0, p, o[3], None), (p, p + mem, o[4], None),
                    (p + mem, p + mem + h, o[5], dh)])
        return o

    # without the cells, to time what the cells add to their hosts; and
    # the cells alone (bwd_cell's standalone launch), as before the fusion
    def cells_alone(k):
        outs = []
        for w in ("gen", "att"):
            c = cell_args(w)
            k.bwd_cell(c.act, c.c_prev, dh, c.dc, c.dg, c.dh_reg, c.reg)
            outs += [c.dc, c.dg, c.dh_reg]
        return outs

    unfused = {"bwd_head": lambda k: head_with_cell(k, False),
               "dq_product": lambda k: dq_with_cell(k, False),
               "dq_product_with_cell": lambda k: dq_with_cell(k, True),
               "cells_alone": cells_alone}

    def att_bwd(k):
        acc = [torch.zeros(b, t_len, a, device=dev),
               None if cfg.family else torch.zeros(b, cfg.taps, a, device=dev),
               torch.zeros(b, a, device=dev)]
        dcc = dcum.clone()
        o = [e(b, a), e(b, mem)]
        fam, extra = None, []
        if cfg.agent:
            extra = [dtp.clone(), e(b, dtype=f32), dh.clone(),
                     e(b, p, dtype=f32)]
            fam = ftd.FamilyBwd(mask_add, st["tp"][s - 1], st["tp"][s],
                                extra[0], extra[1], ops["ta_w"], extra[2],
                                extra[3])
        elif cfg.family:
            fam = ftd.FamilyBwd(mask_add)
        k.att_bwd(q, st["cum"][s], st["w"][s], memory, mtb, ops.get("lc"),
                  ops["v"], dctx, dw, dcc, *acc, *o, fam=fam)
        return [dcc, *[x for x in acc if x is not None], *o, *extra]

    def bwd_prenet(k):
        o = [e(cfg.n_prenet, b, p), e(b, m), e(b, m, dtype=f32)]
        k.bwd_prenet(dx, st["pre"][:, s], ops, cfg, teacher[s], *o)
        return o

    # the forward family's attention kernels are their "_fwd" variants
    fwd = "_fwd" if cfg.family else ""
    return {"train_prenet": prenet, "train_gate_lstm": gates,
            "train_query": query, "train_attention" + fwd: attention,
            "train_head": head, "bwd_head": bwd_head, "bwd_cell": bwd_cell,
            "bwd_gemm": bwd_gemm, "att_bwd" + fwd: att_bwd,
            "bwd_prenet": bwd_prenet}, unfused


def bwd_prenet_reference(ftd, ops, cfg, teacher: int, got, ref):
    """``bwd_prenet``'s plain outputs with the frame cotangent (``dshift``
    or ``dframe``) taken from the kernel's own first-layer gradient
    ``got[0][0]``.  That gradient is stored in bf16 and held to one ulp by
    its own check; where the float32 sums of the layer above run in another
    order, a value on a rounding boundary flips by that ulp (one of the
    ~6,400 values in about one input in four), and the frame cotangent, a
    float32 product over it, then moves by far more than the order of its
    own sums, which its bound is for."""
    import torch

    w0 = ftd.prenet_layers(ops, cfg)[0][0]
    d_in = ftd._mm(got[0][0], w0.t())
    zero = torch.zeros_like(d_in)
    return [ref[0], (d_in if teacher else zero).to(ref[1].dtype),
            zero if teacher else d_in]


def phase_train_kernels(hp, sd, only=None):
    """K2 and K3 kernels (of ``only``, when given, alone; the chained
    steps and the autograd check run every kernel) against their plain
    versions at B=50, T=128, in ``hp.compute_dtype``.  Returns ({kernel: max_abs_err}, the
    inputs the timings reuse).  Only the autograd check records a graph:
    the plain versions' in-place writes into their streams, recorded,
    would tie every step's float32 weight copies into a graph that
    outlives the phase (1.4 GiB at the flagship)."""
    import torch

    with torch.no_grad():
        return _train_kernel_checks(hp, sd, only)


def _train_kernel_checks(hp, sd, only):
    import torch

    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    model = train_model(hp, sd)
    batch = train_batch(hp, TRAIN_B, TRAIN_T, TRAIN_F, SEED + 5)
    # the encoder's dropout draws from the global generator, whose state a
    # new process does not repeat: seeded, the checks' inputs (and so their
    # readings) repeat from run to run
    torch.manual_seed(SEED + 12)
    cfg, ops, memory, mtb, mask_add, shifted = decoder_inputs(
        hp, model, batch, CHECK_STEPS)
    gen = torch.Generator().manual_seed(SEED + 6)
    teacher = [int(x) for x in (torch.rand(CHECK_STEPS, generator=gen) < 0.5)]
    seeds = (2654435761, 40503)
    args = (ops, cfg, memory, mtb, mask_add, shifted, teacher, seeds)
    st_k, carry_k = ftd.train_decode_forward(*args)
    st_p, carry_p = ftd.train_decode_forward(*args, plain=True)
    torch.cuda.synchronize()

    tag = "" if cfg.dtype == torch.bfloat16 else " float32:"
    for step in (3, CHECK_STEPS - 1):
        got = mask_patterns(ftd.KERNELS, cfg, ops, st_p, shifted, seeds, step)
        ref = mask_patterns(ftd.PLAIN, cfg, ops, st_p, shifted, seeds, step)
        for name, g, r in zip(("prenet dropout", "att h", "att c", "gen h",
                               "gen c"), got, ref):
            if not torch.equal(g, r):
                fail(f"{name} choices at step {step} differ in "
                     f"{int((g != r).sum())} places")
    n_masks = sum(int(x.sum()) for x in got)
    say(f"[train:kernels]{tag} dropout and zoneout choices bit-exact at steps "
        f"3 and {CHECK_STEPS - 1} ({n_masks} dropped or kept-old units in "
        f"the last)")

    gen_c = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cts = [torch.randn(x.shape, device="cuda", generator=gen_c)
           for x in (st_p["spec"], st_p["stop"], st_p["w"])]
    calls, unfused = train_kernel_calls(ftd, cfg, ops, memory, mtb,
                                        mask_add, shifted, st_p, teacher,
                                        seeds, cts, CHECK_STEPS // 2)
    if only is not None:
        calls = {k: v for k, v in calls.items() if k in only}
    errs = {}
    for name, run in calls.items():
        got, ref = run(ftd.KERNELS), run(ftd.PLAIN)
        if name == "bwd_prenet" and cfg.dtype == torch.bfloat16:
            ref = bwd_prenet_reference(ftd, ops, cfg,
                                       teacher[CHECK_STEPS // 2], got, ref)
        torch.cuda.synchronize()
        if name == "bwd_cell":
            check_cell_masks(cfg.hidden, got, ref)
        worst = {}
        for g, r in zip(got, ref):
            if not torch.isfinite(g.float()).all():
                fail(f"{name}: non-finite values")
            kind = "bf16" if r.dtype == torch.bfloat16 else "f32"
            worst[kind] = max(worst.get(kind, 0.0), max_err(g, r) / (
                float(r.detach().float().abs().max()) + 1e-30))
        bound = train_kernel_bound(name, cfg.dtype)
        inst = ftd.instance(name, cfg.dtype)
        if set(worst) != set(bound) or any(worst[k] > bound[k]
                                           for k in worst):
            fail(f"{inst}: kernel vs plain off by {worst} of the largest "
                 f"output (bounds {bound})")
        errs[name] = max(max_err(g, r) for g, r in zip(got, ref))
        say(f"[train:kernels] {inst}: max abs err {errs[name]:.3g}; of the "
              f"largest output: " + ", ".join(
                  f"{k} outputs {worst[k]:.3g} (bound {bound[k]})"
                  for k in sorted(worst)))
    # split-K sums its partials in a fixed order, bwd_head sums each output
    # in one thread, train_attention, att_bwd and bwd_prenet exchange their
    # clusters' partials in rank order, and train_prenet's CTAs exchange
    # whole bf16 rows: a second run repeats the first bit for bit
    for name in ("train_prenet", "bwd_gemm", "bwd_head", "bwd_cell",
                 "train_attention", "att_bwd", "train_attention_fwd",
                 "att_bwd_fwd", "bwd_prenet"):
        if name not in calls:
            continue
        first, again = (calls[name](ftd.KERNELS) for _ in range(2))
        torch.cuda.synchronize()
        inst = ftd.instance(name, cfg.dtype)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"{inst}: two runs on the same inputs differ")
        say(f"[train:kernels] {inst}: two runs on the same inputs "
              f"bit-identical")

    worst = {}
    for k in st_p:
        worst[f"forward {k}"] = rel(st_k[k], st_p[k])
    for k in carry_p:
        worst[f"forward carry {k}"] = rel(carry_k[k], carry_p[k])
    if cfg.family:
        # every step's alignment a distribution
        off = float((st_k["w"].sum(-1) - 1.0).abs().max())
        if off > SUM_TOL:
            fail(f"{CHECK_STEPS} chained steps: a step's weights sum to 1 "
                 f"within {off} only")
        say(f"[train:kernels] {CHECK_STEPS} chained steps: every step's "
            f"weights sum to 1 within {off:.3g} (bound {SUM_TOL})")
    bargs = (ops, cfg, memory, mtb, st_p, teacher, seeds, *cts)
    g_k, s_k, c_k = ftd.train_decode_backward(*bargs, mask_add=mask_add)
    g_p, s_p, c_p = ftd.train_decode_backward(*bargs, plain=True,
                                              mask_add=mask_add)
    torch.cuda.synchronize()
    for group, (gk, gp) in {"grad": (g_k, g_p), "stream": (s_k, s_p),
                            "cotangent carry": (c_k, c_p)}.items():
        for k in gp:
            if not torch.isfinite(gk[k].float()).all():
                fail(f"backward {group} {k}: non-finite values")
            worst[f"backward {group} {k}"] = rel(gk[k], gp[k])
    name, top = max(worst.items(), key=lambda kv: kv[1])
    chain_tol = (TRAIN_CHAIN_TOL if cfg.dtype == torch.bfloat16
                 else TRAIN_F32_CHAIN_TOL[kind_group(cfg)])
    if top > chain_tol:
        fail(f"{CHECK_STEPS} chained steps: {name} off by relative {top}")
    say(f"[train:kernels] {CHECK_STEPS} chained steps at B={TRAIN_B} "
        f"T={TRAIN_T} {dtype_label(cfg.dtype)}, forward and backward, "
        f"kernels vs plain: relative error of {len(worst)} streams, "
        f"gradients, accumulators and carries at most {top:.3g} ({name}; "
        f"bound {chain_tol})")
    with torch.enable_grad():
        check_train_autograd(ftd, model, cfg, memory, mtb, mask_add, shifted,
                             teacher, seeds, cts)
    return errs, (ftd, calls, unfused)


def check_cell_masks(hidden, got, ref) -> None:
    """The cells' regularization choices, from their (dc, dg, dh_reg)
    outputs: where zoneout keeps the old state, dh passes to dh_reg; where
    dropout (or zoneout) drops the new h, the o-gate gradient is zero.
    Both patterns bit-exact."""
    import torch

    for i in range(0, len(ref), 3):
        for what, g, r in (
                ("dh pass-through", got[i + 2] != 0, ref[i + 2] != 0),
                ("dropped h", got[i + 1][:, 3 * hidden:] == 0,
                 ref[i + 1][:, 3 * hidden:] == 0)):
            if not torch.equal(g, r):
                fail(f"bwd_cell: the {what} choices of cell {i // 3} differ "
                     f"in {int((g != r).sum())} places")
    say("[train:kernels] bwd_cell: the fused cells' zoneout choices "
          "bit-exact")


def check_train_autograd(ftd, model, cfg, memory, mtb, mask_add, shifted,
                         teacher, seeds, cts) -> None:
    """The decode as training differentiates it, with only K2/K3 apart:
    ``TrainDecode`` (K2 forward, K3 backward) against ``torch.autograd``
    through the plain K2 in differentiable ops, from the same float32
    leaves on the card, under the loss ``sum(outputs * cts)``.  Relative
    error (norms) of spec, stop, w and of the gradient of memory, the memory
    transform, the shifted targets and every decoder operand; the
    ``TrainDecode`` run launches exactly the path's K2/K3 instances of its
    compute type (``TrainConfig.kernels``)."""
    import torch

    leaves = {k: v.detach().float().clone().requires_grad_()
              for k, v in ftd.train_operands(model.decoder.cell, cfg).items()}
    mem, mt, sh = (x.detach().float().requires_grad_()
                   for x in (memory, mtb, shifted))
    keys = ftd.operand_keys(cfg)
    names = ["memory", "mtb", "shifted", *keys]
    inputs = [mem, mt, sh] + [leaves[k] for k in keys]

    def run(outs):
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cts))
        return ([o.detach() for o in outs],
                torch.autograd.grad(loss, inputs))

    ftd.reset_launch_counts()
    out_k, g_k = run(ftd.TrainDecode.apply(
        cfg, tuple(teacher), tuple(seeds), mem, mt, mask_add, sh,
        *[leaves[k] for k in keys]))
    k2, k3 = cfg.kernels
    launched = {k for k, v in ftd.LAUNCHES.items() if v}
    if launched != set(k2 + k3):
        fail(f"TrainDecode launched {sorted(launched)}, not the instances "
             f"{sorted(k2 + k3)}")
    d = cfg.dtype
    out_p, g_p = run(ftd.train_decode_forward_plain(
        ftd.compute_operands(leaves, cfg), cfg, mem.to(d), mt.to(d),
        mask_add, sh.to(d), teacher, seeds))
    torch.cuda.synchronize()
    worst = {f"output {k}": rel(a, b)
             for k, a, b in zip(("spec", "stop", "w"), out_k, out_p)}
    for k, a, b in zip(names, g_k, g_p):
        if not torch.isfinite(a).all():
            fail(f"TrainDecode gradient of {k}: non-finite values")
        worst[f"grad {k}"] = rel(a, b)
    name, top = max(worst.items(), key=lambda kv: kv[1])
    bound = (TRAIN_AUTOGRAD_TOL if cfg.dtype == torch.bfloat16
             else TRAIN_F32_AUTOGRAD_TOL[kind_group(cfg)])
    if top > bound:
        fail(f"TrainDecode vs autograd through the plain K2: {name} off by "
             f"relative {top}")
    say(f"[train:kernels] {shifted.shape[0]} steps through TrainDecode "
        f"(K2/K3, {dtype_label(cfg.dtype)}) vs torch.autograd through the "
        f"plain K2, same card inputs: relative error at most {top:.3g} "
        f"({name}; bound {bound}); " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()))


def phase_train_main(hp, sd, timed: int = 3, frames: int = TRAIN_F):
    """``train_step`` at B=50, T=128, F=``frames`` (512 unless a phase cuts
    the depth) in ``hp.compute_dtype``: a warm-up step, ``timed`` steps at
    teacher forcing 1.0 and one at 0.5, with the launch counts reset just
    before and read just after; then one step split by CUDA events."""
    import numpy as np
    import torch

    from multilingual_text_to_speech_tpu_torch.device import exact_float32
    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        TacotronLossState,
        classifier_kernel,
        tacotron_loss,
    )
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )
    from multilingual_text_to_speech_tpu_torch.training import trainer

    model = train_model(hp, sd)
    opt, sched = trainer.make_optimizer(model, hp)
    batch = train_batch(hp, TRAIN_B, TRAIN_T, frames, SEED + 8)
    gen = torch.Generator().manual_seed(SEED + 9)
    state = TacotronLossState.init(hp)
    full = [1] * frames
    res = trainer.train_step(model, opt, sched, batch, state, gen,
                             teacher=full)                      # warm-up
    torch.cuda.synchronize()
    state = res.loss_state
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()

    ftd.reset_launch_counts()
    times, results = [], []
    for i in range(timed + 1):
        teacher = full if i < timed else [
            int(x) for x in (torch.rand(frames, generator=gen) < 0.5)]
        t0 = time.perf_counter()
        res = trainer.train_step(model, opt, sched, batch, state, gen,
                                 teacher=teacher)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        results.append(res)
        state = res.loss_state
    launches = dict(ftd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    k2, k3 = ftd.TrainConfig.from_hp(hp, model.decoder.memory_dim,
                                     model.dtype).kernels
    missing = [k for k in k2 + k3 if launches[k] == 0]
    stray = [k for k in launches if k not in k2 + k3 and launches[k]]
    if missing or stray:
        fail(f"training kernels of the main path never launched: {missing};"
             f" kernels of another path launched: {stray}")
    for i, r in enumerate(results):
        vals = {k: float(v) for k, v in r.losses.items()}
        if not all(np.isfinite(v) for v in vals.values()) or not np.isfinite(
                float(r.grad_norm)):
            fail(f"train step {i}: non-finite losses {vals}")
    unchanged = [n for n, p in model.named_parameters()
                 if p.grad is not None and torch.equal(p.detach(), before[n])]
    if unchanged:
        fail(f"parameters with a gradient that did not change: {unchanged}")
    step_s = float(np.mean(times[:timed]))
    audio = TRAIN_B * frames / 80.0
    say(f"[train:main] train_step B={TRAIN_B} T={TRAIN_T} F={frames} "
        f"{dtype_label(model.dtype)} "
        f"(encoder {hp.encoder_type}, memory width "
        f"{model.decoder.memory_dim}): steps at teacher forcing 1.0 "
        + ", ".join(f"{t:.4f}" for t in times[:timed])
        + f" s (mean {step_s:.4f} s = {audio / step_s:.2f} audio-seconds "
        f"trained per second), at 0.5 {times[timed]:.4f} s (host clock, "
        f"after a warm-up step); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    say("[train:main] losses: " + "; ".join(
        ", ".join(f"{k} {float(v):.5f}" for k, v in r.losses.items())
        + f", grad norm {float(r.grad_norm):.4f}, accuracy "
        f"{float(r.accuracy):.4f}" for r in results))
    per_step = {k: v / (timed + 1) for k, v in launches.items()}
    say(f"[train:main] launches over {timed + 1} steps: {launches}")

    # one more step, split by CUDA events (the pieces of train_step)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    text, lengths, mels, flen, spk, langs = (
        torch.as_tensor(x, device="cuda") for x in (
            batch.utterances, batch.utterance_lengths, batch.mel_spectrograms,
            batch.spectrogram_lengths, batch.speakers, batch.languages))
    post_target = (mels if batch.linear_spectrograms is None else
                   torch.as_tensor(batch.linear_spectrograms, device="cuda"))
    # as train_step runs it: a float32 model's cuDNN calls in float32
    with (exact_float32() if model.dtype == torch.float32
          else contextlib.nullcontext()):
        ev[0].record()
        out = model(text, lengths, mels, flen, spk, langs, full, (3, 4))
        total, _ = tacotron_loss(
            out, hp=hp, input_lengths=lengths, target_lengths=flen,
            pre_target=mels, post_target=post_target,
            stop_target=torch.as_tensor(batch.stop_tokens, device="cuda"),
            speakers=spk, guided_att_variance=state.guided_att_variance,
            classifier_kernel=classifier_kernel(model))
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total.backward()
        ev[2].record()
    trainer.clip_grad_global_norm_(list(model.parameters()),
                                   hp.gradient_clipping)
    opt.step()
    sched.step()
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    say(f"[train:main] one step split by CUDA events: forward and loss "
          f"{split[0]:.3f} ms, backward {split[1]:.3f} ms, clip and Adam "
          f"{split[2]:.3f} ms")
    return launches, per_step, step_s, (model, opt, sched, batch, state)


def phase_train_vs_cpu(hp, sd, t_len: int = 32, b: int = 10) -> None:
    """A small step (B=``b``, T=``t_len``, F=32) on the card against the
    same step on the CPU plain path: the same weights, batch, flags and
    seeds, dropout off; every K2/K3 kernel of the path launched on the
    card."""
    import torch

    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        classifier_kernel,
        tacotron_loss,
    )
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    small = train_batch(hp, b, t_len, 32, SEED + 10)
    teacher = [1] * 32
    got = {}
    for dev in ("cuda", "cpu"):
        ftd.reset_launch_counts()
        m = train_model(hp, sd, dev, dropout=False)
        t = {k: torch.as_tensor(getattr(small, k), device=dev) for k in (
            "utterances", "utterance_lengths", "mel_spectrograms",
            "spectrogram_lengths", "stop_tokens", "speakers", "languages")}
        o = m(t["utterances"], t["utterance_lengths"], t["mel_spectrograms"],
              t["spectrogram_lengths"], t["speakers"], t["languages"],
              teacher, (77, 88))
        post_target = (t["mel_spectrograms"] if small.linear_spectrograms is
                       None else torch.as_tensor(small.linear_spectrograms,
                                                 device=dev))
        tot, losses = tacotron_loss(
            o, hp=hp, input_lengths=t["utterance_lengths"],
            target_lengths=t["spectrogram_lengths"],
            pre_target=t["mel_spectrograms"],
            post_target=post_target, stop_target=t["stop_tokens"],
            speakers=t["speakers"], guided_att_variance=0.25,
            classifier_kernel=classifier_kernel(m))
        tot.backward()
        got[dev] = ({k: float(v) for k, v in losses.items()},
                    {n: p.grad.detach().float().cpu()
                     for n, p in m.named_parameters() if p.grad is not None})
        if dev == "cuda":
            k2, k3 = ftd.TrainConfig.from_hp(hp, m.decoder.memory_dim,
                                             m.dtype).kernels
            missing = [k for k in k2 + k3 if ftd.LAUNCHES[k] == 0]
            if missing:
                fail(f"train step at T={t_len} on the card: kernels never "
                     f"launched {missing}")
    (lk, gk), (lp, gp) = got["cuda"], got["cpu"]
    if set(gk) != set(gp):
        fail("card and CPU steps differ in which parameters get gradients")
    names = sorted(gp)
    checks = {"the whole gradient": (rel(
        torch.cat([gk[n].reshape(-1) for n in names]),
        torch.cat([gp[n].reshape(-1) for n in names])), TRAIN_E2E_TOL)}
    checks.update({f"loss {k}": (abs(lk[k] - lp[k]) / (abs(lp[k]) + 1e-12),
                                 TRAIN_E2E_TOL) for k in lp})
    checks.update({f"grad {n}": (rel(gk[n], gp[n]), TRAIN_E2E_ENCODER_TOL
                                 if n.startswith("encoder.")
                                 else TRAIN_E2E_PARAM_TOL)
                   for n in names if float(gp[n].norm()) > 0})
    over = {k: v for k, v in checks.items() if v[0] > v[1]}
    if over:
        fail(f"train step card vs CPU: relative errors over their bounds: "
             f"{over}")
    for label, keys in (
            ("the whole gradient and the loss terms",
             [k for k in checks if not k.startswith("grad ")]),
            ("decoder, postnet and classifier gradients",
             [k for k in checks if k.startswith("grad ")
              and not k.startswith("grad encoder.")]),
            ("encoder gradients",
             [k for k in checks if k.startswith("grad encoder.")])):
        worst = max(keys, key=lambda k: checks[k][0])
        say(f"[train:main] B={b} T={t_len} F=32 step, card vs CPU plain path "
            f"(bf16, dropout off), {label} ({len(keys)}): relative error at "
            f"most {checks[worst][0]:.3g} ({worst}; bound "
            f"{checks[worst][1]})")


@contextlib.contextmanager
def unguarded():
    """The port's float32 guard of its cuDNN calls taken out (the model's
    forward and ``train_step`` run without ``device.exact_float32``)."""
    from multilingual_text_to_speech_tpu_torch.models import tacotron
    from multilingual_text_to_speech_tpu_torch.training import trainer

    saved = tacotron.exact_float32, trainer.exact_float32
    tacotron.exact_float32 = trainer.exact_float32 = contextlib.nullcontext
    try:
        yield
    finally:
        tacotron.exact_float32, trainer.exact_float32 = saved


def phase_train_f32_vs_cpu(hp, sd, b: int = 10, t_len: int = 32,
                           frames: int = 32, unguarded_too: bool = True
                           ) -> None:
    """A float32 ``train_step`` at B=``b``, T=``t_len``, F=``frames`` on
    the card against the same step on the CPU plain path (the same
    weights, batch, flags and seeds, dropout off): every loss term and
    every parameter's gradient (as the step leaves it, clipped by the same
    global norm on both sides) within TRAIN_F32_E2E_TOL, relative.  Then,
    with ``unguarded_too``, the same step on the card with the port's
    guard of its cuDNN calls taken out and cuDNN at PyTorch's TF32
    default: its reading is printed, not gated (what the guard keeps
    out)."""
    import torch

    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        TacotronLossState,
    )
    from multilingual_text_to_speech_tpu_torch.training import trainer

    small = train_batch(hp, b, t_len, frames, SEED + 10)

    def step(dev):
        m = train_model(hp, sd, dev, dropout=False)
        opt, sched = trainer.make_optimizer(m, hp)
        res = trainer.train_step(m, opt, sched, small,
                                 TacotronLossState.init(hp),
                                 torch.Generator(), teacher=[1] * frames,
                                 seeds=(77, 88), device=dev)
        return ({k: float(v) for k, v in res.losses.items()},
                {n: p.grad.detach().float().cpu()
                 for n, p in m.named_parameters() if p.grad is not None})

    lp, gp = step("cpu")

    def errors(got):
        lk, gk = got
        if set(gk) != set(gp):
            fail("card and CPU steps differ in which parameters get "
                 "gradients")
        errs = {f"loss {k}": abs(lk[k] - lp[k]) / (abs(lp[k]) + 1e-12)
                for k in lp}
        errs.update({f"grad {n}": rel(gk[n], gp[n]) for n in gp
                     if float(gp[n].norm()) > 0})
        return errs, max(errs, key=errs.get)

    errs, worst = errors(step("cuda"))
    if errs[worst] > TRAIN_F32_E2E_TOL:
        fail(f"float32 train step card vs CPU: {worst} off by relative "
             f"{errs[worst]} (bound {TRAIN_F32_E2E_TOL})")
    say(f"[train:main] B={b} T={t_len} F={frames} float32 train_step, card "
        f"vs CPU plain path (dropout off), {len(errs)} loss terms and "
        f"parameter gradients: relative error at most {errs[worst]:.3g} "
        f"({worst}; bound {TRAIN_F32_E2E_TOL})")
    if not unguarded_too:
        return
    with cudnn_default(), unguarded():
        errs, worst = errors(step("cuda"))
    say(f"[train:main] the same step with the guard taken out "
        f"(device.exact_float32 off, cuDNN at PyTorch's TF32 default): "
        f"relative error at most {errs[worst]:.3g} ({worst}); not gated")


def phase_train_eval(hp, sd) -> None:
    """The eval/GTA forward, K2's eval variant (``TrainConfig.train``
    False): 16 steps through the kernels against the plain drivers on the
    same card inputs at B=50, T=128 (no residual stream kept), then
    ``model.eval()``'s teacher-forced forward at B=10, T=32, F=32 on the
    card against the same forward on the CPU plain path (prenet dropout on:
    the hashed masks are the same on both), teacher forcing 0.5."""
    import dataclasses

    import torch

    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    model = train_model(hp, sd).eval()
    batch = train_batch(hp, TRAIN_B, TRAIN_T, TRAIN_F, SEED + 13)
    torch.manual_seed(SEED + 14)
    cfg, ops, memory, mtb, mask_add, shifted = decoder_inputs(
        hp, model, batch, CHECK_STEPS)
    cfg = dataclasses.replace(cfg, train=False)
    teacher = [1, 0] * (CHECK_STEPS // 2)
    args = (ops, cfg, memory, mtb, mask_add, shifted, teacher, (11, 12))
    with torch.no_grad():
        st_k, carry_k = ftd.train_decode_forward(*args)
        st_p, carry_p = ftd.train_decode_forward(*args, plain=True)
    torch.cuda.synchronize()
    if set(st_k) != {"spec", "stop", "w"}:
        fail(f"the eval forward kept streams {sorted(st_k)}")
    worst = {f"forward {k}": rel(st_k[k], st_p[k]) for k in st_p}
    worst.update({f"forward carry {k}": rel(carry_k[k], carry_p[k])
                  for k in carry_p})
    name, top = max(worst.items(), key=lambda kv: kv[1])
    f32 = cfg.dtype == torch.float32
    chain_tol = (TRAIN_F32_CHAIN_TOL[kind_group(cfg)] if f32
                 else TRAIN_CHAIN_TOL)
    if top > chain_tol:
        fail(f"eval forward, {CHECK_STEPS} steps: {name} off by relative "
             f"{top}")
    say(f"[train:eval] {CHECK_STEPS} eval-forward steps at B={TRAIN_B} "
        f"T={TRAIN_T} {dtype_label(cfg.dtype)}, kernels vs plain: relative "
        f"error of spec, stop, w and the carries at most {top:.3g} ({name}; "
        f"bound {chain_tol}); no residual stream kept")

    small = train_batch(hp, 10, 32, 32, SEED + 15)
    teacher = [1, 0] * 16
    keys = ("pre_prediction", "post_prediction", "alignment")
    got = {}
    for dev in ("cuda", "cpu"):
        m = train_model(hp, sd, dev).eval()
        t = {k: torch.as_tensor(getattr(small, k), device=dev) for k in (
            "utterances", "utterance_lengths", "mel_spectrograms",
            "spectrogram_lengths", "speakers", "languages")}
        if dev == "cuda":
            ftd.reset_launch_counts()
        o = m(t["utterances"], t["utterance_lengths"], t["mel_spectrograms"],
              t["spectrogram_lengths"], t["speakers"], t["languages"],
              teacher, (77, 88))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(ftd.LAUNCHES)
        if o["pre_prediction"].grad_fn is not None or \
                o["alignment"].grad_fn is not None:
            fail("the eval forward's decoder outputs carry a grad_fn")
        valid = t["mel_spectrograms"].new_zeros(o["stop_token"].shape,
                                                dtype=torch.bool)
        for i, n in enumerate(small.spectrogram_lengths):
            valid[i, :int(n)] = True
        got[dev] = {k: o[k].detach().float().cpu() for k in keys}
        got[dev]["stop_token"] = o["stop_token"][valid].detach().float().cpu()
    k2, _ = cfg.kernels
    missing = [k for k in k2 if launches[k] == 0]
    stray = [k for k in launches if k not in k2 and launches[k] != 0]
    if missing or stray:
        fail(f"eval forward on the card: K2 kernels never launched {missing},"
             f" other kernels launched {stray}")
    checks = {k: rel(got["cuda"][k], got["cpu"][k]) for k in got["cpu"]}
    name, top = max(checks.items(), key=lambda kv: kv[1])
    e2e_tol = TRAIN_F32_E2E_TOL if f32 else TRAIN_E2E_TOL
    if top > e2e_tol:
        fail(f"eval forward card vs CPU: {name} off by relative {top}")
    say(f"[train:eval] model.eval() forward B=10 T=32 F=32, card vs CPU "
        f"plain path ({dtype_label(cfg.dtype)}, teacher forcing 0.5): "
        f"relative error at most {top:.3g} ({name}; bound {e2e_tol}); "
        + ", ".join(
              f"{k} {v:.3g}" for k, v in checks.items()))
    say(f"[train:eval] launches of the eval forward (32 steps): "
          f"{ {k: launches[k] for k in k2} }; K3 none")


# [train:loop]: training from a corpus on disk, at the flagship's width.
# 16 speakers over the 5 languages, 40 training and 10 dev items a language
# (4 steps an epoch at B=50), texts from tests/data/css_comvoi/val.txt, each
# item's audio (a speaker's tone under a slow envelope, and noise) 48 + 4
# frames a character, at most LOOP_MAX_FRAMES frames
LOOP_SPEAKERS = (4, 3, 3, 3, 3)
LOOP_TRAIN, LOOP_DEV, LOOP_MAX_FRAMES, LOOP_B = 40, 10, 512, 50
# GTA files held card against CPU: the --cpu run exports cli/gta.py's first
# batch (its default 16 rounded down to the 5 languages), whose files the
# card's run writes too
LOOP_GTA_CHECK = 2


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def loop_corpus(root: Path, hp) -> int:
    """Write the corpus's WAVs and its ``train.txt``/``val.txt`` (8 fields,
    empty cache columns; items interleaved by language, so that a prefix
    of ``train.txt`` holds the first items of every language); returns the
    largest item's frame count."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.ops.io import save_wav

    n_items = LOOP_TRAIN + LOOP_DEV
    texts = {lang: [] for lang in hp.languages}
    with open(ROOT / "tests" / "data" / "css_comvoi" / "val.txt",
              encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            if cols[2] in texts and len(texts[cols[2]]) < n_items:
                texts[cols[2]].append(cols[6])
    hop = int(hp.sample_rate * hp.stft_shift_ms / 1000)
    rng = np.random.RandomState(SEED)
    rows = {"train": [], "val": []}
    longest, serial = 0, 0
    for k in range(n_items):
        for li, lang in enumerate(hp.languages):
            text = texts[lang][k]
            spk = k % LOOP_SPEAKERS[li]
            frames = min(LOOP_MAX_FRAMES, 48 + 4 * len(text))
            n = (frames - 1) * hop
            t = np.arange(n) / hp.sample_rate
            f0 = 100.0 + 30.0 * (4 * li + spk)
            wav = (0.2 * np.sin(2 * np.pi * f0 * t)
                   * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
                   + 0.01 * rng.randn(n))
            rel_path = f"{lang}/{serial:06}.wav"
            (root / lang).mkdir(parents=True, exist_ok=True)
            save_wav(wav, str(root / rel_path), hp.sample_rate)
            rows["train" if k < LOOP_TRAIN else "val"].append(
                f"{serial:06}|{spk:02}-{lang}|{lang}|{rel_path}|||{text}|")
            longest = max(longest, frames)
            serial += 1
    for name, lines in rows.items():
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n",
                                          encoding="utf-8")
    return longest


def _moments(trainer):
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return {names[id(p)]: {k: v.detach().clone() for k, v in st.items()}
            for p, st in trainer.optimizer.state.items()}


def _train_records(trainer, kind="train"):
    trainer.logger._jsonl.flush()
    with open(Path(trainer.logger.log_dir) / "metrics.jsonl",
              encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _finite_losses(records, what):
    import math

    for r in records:
        vals = [v for k, v in r.items()
                if k.startswith("loss_") or k in ("total_loss",
                                                  "gradient_norm", "mcd")]
        if not vals or not all(math.isfinite(v) for v in vals):
            fail(f"{what}: non-finite losses {r}")


LOOP_BASE = ROOT / "build" / "train_loop"


def loop_hp():
    from multilingual_text_to_speech_tpu_torch import flagship_hparams

    hp = flagship_hparams()
    hp.batch_size, hp.dataset = LOOP_B, "loop"
    return hp


def state_digest(model) -> str:
    """sha256 of a model's state dict, tensor by tensor in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def moments_digest(trainer) -> str:
    """sha256 of a trainer's Adam state, parameter by parameter in name
    order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, st in sorted(_moments(trainer).items()):
        h.update(name.encode())
        for k in ("step", "exp_avg", "exp_avg_sq"):
            h.update(torch.as_tensor(st[k]).detach().cpu().contiguous()
                     .view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def no_conv_dropout(model) -> None:
    """The encoder's and postnet's dropout off (their masks come from each
    device's own generator); the prenet's and zoneout's hashed masks stay."""
    for m in model.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


def loop_setup():
    """``[train:loop]``'s corpus, written and its caches filled on the card
    by ``cli/prepare.py --fill_metafile`` before the kernels' build; then
    the CPU's two training steps started in a child process
    (``chip_smoke.py --loop-cpu-steps``, ``loop_cpu_steps``), which runs
    while nvcc builds.  Returns the child (stopped at exit)."""
    import atexit
    import shutil

    import torch

    from multilingual_text_to_speech_tpu_torch.cli import prepare

    card = card_label()
    shutil.rmtree(LOOP_BASE, ignore_errors=True)
    root = LOOP_BASE / "data" / "loop"
    hp = loop_hp()
    t0 = time.perf_counter()
    longest = loop_corpus(root, hp)
    t1 = time.perf_counter()
    for name in ("train.txt", "val.txt"):
        prepare.main(["--fill_metafile", str(root / name), "--root",
                      str(root), "--sample_rate", str(hp.sample_rate),
                      "--num_fft", str(hp.num_fft)])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_lang = len(hp.languages)
    say(f"[train:loop] corpus: {n_lang * (LOOP_TRAIN + LOOP_DEV)} items "
        f"({n_lang} languages, {sum(LOOP_SPEAKERS)} speakers, at most "
        f"{longest} frames) written in {t1 - t0:.3f} s; mel and linear "
        f"caches filled on the card by cli/prepare.py --fill_metafile in "
        f"{t2 - t1:.3f} s (host clock; {card})")
    with open(LOOP_BASE / "cpu_steps.log", "w") as log:
        child = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--loop-cpu-steps"],
            stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if child.poll() is None:
            child.kill()
            child.wait()
    atexit.register(stop)
    return child


def loop_wait(child) -> float:
    """Wait for the CPU steps' child (before the phases that time on the
    host clock); returns the seconds waited."""
    t0 = time.perf_counter()
    if child.wait() != 0:
        log = (LOOP_BASE / "cpu_steps.log").read_text()[-2000:]
        fail(f"[train:loop] the CPU steps' process failed:\n{log}")
    return time.perf_counter() - t0


def loop_cpu_steps() -> int:
    """The child: the first two steps of a ``Trainer`` on the CPU (seed
    SEED, as the card's; the conv dropouts off), its records, seconds and
    initial weights' digest written to ``cpu_steps.json``."""
    import torch

    from multilingual_text_to_speech_tpu_torch.data import (
        TextToSpeechDatasetCollection,
    )
    from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer

    # leave cores to the two nvcc processes of the build
    torch.set_num_threads(max(1, (os.cpu_count() or 4) - 2))
    hp = loop_hp()
    tr = Trainer(hp, TextToSpeechDatasetCollection(
        str(LOOP_BASE / "data" / "loop"), hp, device="cpu"), device="cpu",
        seed=SEED, log_dir=str(LOOP_BASE / "logs_cpu"))
    digest = state_digest(tr.model)
    no_conv_dropout(tr.model)
    t0 = time.perf_counter()
    tr.train_epoch(max_steps=2)
    seconds = time.perf_counter() - t0
    (LOOP_BASE / "cpu_steps.json").write_text(json.dumps({
        "records": _train_records(tr), "seconds": seconds,
        "digest": digest, "threads": torch.get_num_threads()}))
    return 0


def phase_train_loop(cpu_waited: float) -> None:
    """``[train:loop]``: the flagship (``config.flagship_hparams()``, B=50)
    trained from the corpus of ``loop_setup``: host batches/s through
    ``batch_iterator`` and ``prefetch`` alone; a ``Trainer`` epoch (every
    K2/K3 kernel launched, no other), ``evaluate`` (K2's eval variant, no
    K3; DTW-MCD; the Griffin-Lim render), ``save``; a new ``Trainer`` from
    the checkpoint bit-identical (weights, batch-norm statistics, Adam
    moments, step, epoch) and one more epoch; the first two steps on the
    card against the CPU's (``loop_cpu_steps``, ``cpu_waited`` the
    seconds the run waited for it) from the same weights, flags and seeds
    (``no_conv_dropout``) within TRAIN_E2E_TOL;
    ``cli/gta.py`` on the checkpoint (a file per training item) and
    LOOP_GTA_CHECK files against a ``--cpu`` run within the eval forward's
    bound (TRAIN_E2E_TOL)."""
    import math

    import numpy as np
    import torch

    from multilingual_text_to_speech_tpu_torch.cli import gta
    from multilingual_text_to_speech_tpu_torch.data import (
        PerfectBatchSampler,
        TextToSpeechDatasetCollection,
        batch_iterator,
    )
    from multilingual_text_to_speech_tpu_torch.data.prefetch import prefetch
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )
    from multilingual_text_to_speech_tpu_torch.training.checkpoint import (
        load_checkpoint,
    )
    from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer

    card = card_label()
    base = LOOP_BASE
    root = base / "data" / "loop"
    hp = loop_hp()
    n_lang = len(hp.languages)

    data = TextToSpeechDatasetCollection(str(root), hp, device="cuda")
    frames = [int(np.load(root / it["spectrogram"], mmap_mode="r").shape[1])
              for it in data.train.items]
    if max(frames) > LOOP_MAX_FRAMES or len(data.train) != n_lang * \
            LOOP_TRAIN:
        fail(f"[train:loop] corpus: {len(data.train)} items, frames up to "
             f"{max(frames)}")
    t0 = time.perf_counter()
    tr = Trainer(hp, data, device="cuda", seed=SEED,
                 log_dir=str(base / "logs"),
                 checkpoint_dir=str(base / "ckpt"))
    init_s = time.perf_counter() - t0

    # the host's input pipeline alone: two epochs of collated batches from
    # the caches on disk (read warm: just written) through prefetch
    langs = [it["language"] for it in data.train.items]
    sampler = PerfectBatchSampler(langs, n_lang, LOOP_B, shuffle=True,
                                  drop_last=True, seed=SEED + 1)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in range(2) for _ in prefetch(
        batch_iterator(data.train, sampler, tr.collate)))
    host_s = time.perf_counter() - t0
    host_bps = n_batches / host_s

    k2, k3 = ftd.TrainConfig.from_hp(hp, tr.model.decoder.memory_dim,
                                     tr.model.dtype).kernels

    def check_launches(what, want):
        launches = {k: v for k, v in ftd.LAUNCHES.items() if v}
        missing = [k for k in want if not ftd.LAUNCHES[k]]
        stray = [k for k in launches if k not in want] + [
            k for k, v in fd.LAUNCHES.items() if v]
        if missing or stray:
            fail(f"[train:loop] {what}: kernels never launched {missing}, "
                 f"other kernels launched {stray}")
        return launches

    ftd.reset_launch_counts()
    fd.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = tr.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = check_launches("epoch", k2 + k3)
    records = _train_records(tr)
    _finite_losses(records, "[train:loop] epoch")
    if steps != n_lang * LOOP_TRAIN // LOOP_B or len(records) != steps:
        fail(f"[train:loop] epoch of {steps} steps, {len(records)} logged")
    say(f"[train:loop] Trainer.train_epoch B={LOOP_B} (flagship, "
        f"{dtype_label(tr.model.dtype)}, frames up to {max(frames)}): "
        f"{steps} steps in {epoch_s:.4f} s = {steps / epoch_s:.3f} steps/s "
        f"(host clock, the first epoch of the process, metrics logged each "
        f"step; {card}); Trainer built in {init_s:.3f} s")
    say(f"[train:loop] host input pipeline alone (batch_iterator + "
        f"prefetch, caches read warm): {n_batches} batches in {host_s:.4f} "
        f"s = {host_bps:.3f} batches/s against the epoch's "
        f"{steps / epoch_s:.3f} steps/s ({card})")
    say("[train:loop] losses: " + "; ".join(
        f"step {r['step']} total {r['total_loss']:.5f}, grad norm "
        f"{r['gradient_norm']:.4f}" for r in records))
    say(f"[train:loop] launches over the epoch: {launches}")

    ftd.reset_launch_counts()
    t0 = time.perf_counter()
    eval_loss = tr.evaluate()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    check_launches("evaluate", k2)
    (ev,) = _train_records(tr, "eval")
    _finite_losses([ev], "[train:loop] evaluate")
    if not math.isfinite(eval_loss) or ev["audio_generated_samples"] <= 0:
        fail(f"[train:loop] evaluate: loss {eval_loss}, record {ev}")
    parts = tr.eval_seconds
    say(f"[train:loop] evaluate ({len(data.dev)} dev items): {eval_s:.4f} s"
        f" = teacher-forced pass {parts['forced']:.4f} + free-running pass "
        f"{parts['free']:.4f} + DTW-MCD {parts['mcd']:.4f} + Griffin-Lim "
        f"render {parts['render']:.4f} s (host clock; {card}); eval loss "
        f"{eval_loss:.5f}, MCD {ev['mcd']:.4f}, classifier accuracy "
        f"{ev.get('classifier_acc', 0.0):.4f}")

    t0 = time.perf_counter()
    path = tr.save(eval_loss)
    save_s = time.perf_counter() - t0
    saved = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    saved_moments = _moments(tr)
    t0 = time.perf_counter()
    hp2 = load_checkpoint(path)["hp"]
    tr2 = Trainer(hp2, TextToSpeechDatasetCollection(str(root), hp2,
                                                     device="cuda"),
                  device="cuda", seed=SEED + 1, from_checkpoint=path,
                  log_dir=str(base / "logs_resumed"))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    diffs = [k for k, v in tr2.model.state_dict().items()
             if not k.endswith("num_batches_tracked")
             and not torch.equal(v, saved[k])]
    moments = _moments(tr2)
    diffs += [f"{n}.{k}" for n, st in saved_moments.items()
              for k in ("exp_avg", "exp_avg_sq", "step")
              if n not in moments or not torch.equal(st[k], moments[n][k])]
    if set(moments) != set(saved_moments):
        diffs.append("the set of parameters with Adam state")
    if (tr2.step, tr2.epoch, tr2.scheduler.last_epoch) != (
            tr.step, tr.epoch + 1, tr.scheduler.last_epoch):
        diffs.append(f"step/epoch/schedule {tr2.step}, {tr2.epoch}, "
                     f"{tr2.scheduler.last_epoch}")
    if diffs:
        fail(f"[train:loop] resume is not bit-identical: {diffs[:8]}")
    mib = os.path.getsize(path) / 2 ** 20
    say(f"[train:loop] save {mib:.1f} MiB (weights and Adam moments) in "
        f"{save_s:.3f} s; a new Trainer from the checkpoint on the card in "
        f"{resume_s:.3f} s (host clock; {card}): weights, batch-norm "
        f"statistics, Adam moments ({len(moments)} parameters), step "
        f"{tr2.step} and epoch {tr2.epoch} bit-identical")
    ftd.reset_launch_counts()
    t0 = time.perf_counter()
    steps2 = tr2.train_epoch()
    torch.cuda.synchronize()
    epoch2_s = time.perf_counter() - t0
    check_launches("resumed epoch", k2 + k3)
    records2 = _train_records(tr2)
    _finite_losses(records2, "[train:loop] resumed epoch")
    say(f"[train:loop] resumed epoch: {steps2} steps (steps "
        f"{records2[0]['step']}-{records2[-1]['step']}) in {epoch2_s:.4f} s "
        f"= {steps2 / epoch2_s:.3f} steps/s ({card}); losses "
        + ", ".join(f"{r['total_loss']:.5f}" for r in records2))
    del tr2

    # the first two steps on the card against the CPU's (loop_cpu_steps):
    # the same weights, batches, flags and seeds (each trainer's Draws from
    # the same seed)
    cpu = json.loads((base / "cpu_steps.json").read_text())
    hp_c = hp.copy()
    t = Trainer(hp_c, TextToSpeechDatasetCollection(str(root), hp_c,
                                                    device="cuda"),
                device="cuda", seed=SEED, log_dir=str(base / "logs_cuda"))
    if state_digest(t.model) != cpu["digest"]:
        fail("[train:loop] the card's and the CPU's trainers start from "
             "other weights")
    no_conv_dropout(t.model)
    t0 = time.perf_counter()
    t.train_epoch(max_steps=2)
    torch.cuda.synchronize()
    sk = time.perf_counter() - t0
    rk, rp = _train_records(t), cpu["records"]
    del t
    checks = {f"step {a['step']} {k}": abs(a[k] - b[k]) / (abs(b[k]) + 1e-12)
              for a, b in zip(rk, rp) for k in b
              if k.startswith("loss_") or k in ("total_loss",
                                                "gradient_norm")}
    name, top = max(checks.items(), key=lambda kv: kv[1])
    if len(rk) != 2 or len(rp) != 2 or top > TRAIN_E2E_TOL:
        fail(f"[train:loop] first two steps card vs CPU: {name} off by "
             f"relative {top}")
    say(f"[train:loop] first two steps B={LOOP_B}, card ({sk:.3f} s; "
        f"{card}) vs CPU plain path ({cpu['seconds']:.3f} s on "
        f"{cpu['threads']} threads, in a process that ran during the "
        f"kernels' build; waited for {cpu_waited:.3f} s after it), bf16, "
        f"encoder and postnet dropout off: loss terms and gradient norms "
        f"within relative {top:.3g} ({name}; bound {TRAIN_E2E_TOL})")

    # GTA on the card over the whole training set, then the first batch on
    # the CPU from a prefix of train.txt (the same batch, serials, seeds
    # and speaker indices)
    out = base / "gta"
    t0 = time.perf_counter()
    gta.main(["--checkpoint", path, "--data_root", str(base / "data"),
              "--output", str(out / "card")])
    torch.cuda.synchronize()
    gta_s = time.perf_counter() - t0
    names = sorted(os.listdir(out / "card"))
    if len(names) != len(data.train):
        fail(f"[train:loop] cli/gta.py wrote {len(names)} files for "
             f"{len(data.train)} training items")
    gta_b = 16 // n_lang * n_lang
    cpu_root = base / "data_cpu" / "loop"
    cpu_root.mkdir(parents=True)
    lines = (root / "train.txt").read_text(encoding="utf-8").splitlines()
    (cpu_root / "train.txt").write_text("\n".join(lines[:gta_b]) + "\n",
                                        encoding="utf-8")
    for d in ("spectrograms", "linear_spectrograms", *hp.languages):
        os.symlink(root / d, cpu_root / d)
    t0 = time.perf_counter()
    gta.main(["--checkpoint", path, "--data_root", str(base / "data_cpu"),
              "--output", str(out / "cpu"), "--cpu"])
    gta_cpu_s = time.perf_counter() - t0
    cpu_names = sorted(os.listdir(out / "cpu"))
    if cpu_names != names[:gta_b]:
        fail(f"[train:loop] cli/gta.py --cpu wrote {cpu_names[:4]}..., the "
             f"card {names[:4]}...")
    errs = {}
    for n in cpu_names[:LOOP_GTA_CHECK]:
        a, b = np.load(out / "card" / n), np.load(out / "cpu" / n)
        errs[n] = (float(np.linalg.norm(a - b) / np.linalg.norm(b))
                   if a.shape == b.shape and np.isfinite(a).all()
                   else math.inf)
    worst = max(errs.values())
    if worst > TRAIN_E2E_TOL:
        fail(f"[train:loop] GTA card vs CPU: relative errors {errs}")
    say(f"[train:loop] cli/gta.py on the checkpoint: {len(names)} files "
        f"([bins, F]) in {gta_s:.3f} s on the card (model load included; "
        f"{card}); the first batch ({gta_b}) with --cpu in {gta_cpu_s:.3f} "
        f"s: {', '.join(f'{n} {e:.3g}' for n, e in errs.items())} relative "
        f"error (bound {TRAIN_E2E_TOL})")
    say(f"[train:loop] peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")


# [train:dp]: data-parallel training on the one card (parallel/,
# Trainer(mesh=)): the mesh of one over NCCL against the plain step, then
# DP_WORLD ranks over gloo in child processes (chip_smoke.py --dp-child),
# each running K2/K3 on its rows of the global B=50
DP_WORLD = 2
DP_BASE = ROOT / "build" / "train_dp"
# each child process and each collective: a hang fails the run
DP_TIMEOUT = 240
# the first step of the ranks against the single process on the same global
# batch, dropout and zoneout off (the shards' masks differ by design): each
# loss term, the gradient norm and each parameter's gradient as its max
# |difference| over its largest |value|, by group (dp_group).  bf16 at the
# bounds of the training check card against CPU (phase_train_vs_cpu): the
# ranks' batch moments and loss sums add in another order and bf16
# roundings follow them, and the generated encoder's gradients sum
# bf16-rounded products with much cancellation; float32, under
# device.exact_float32, within 1e-4 throughout
DP_STEP_TOL = {
    "bfloat16": {"loss": TRAIN_E2E_TOL, "encoder": TRAIN_E2E_ENCODER_TOL,
                 "other": TRAIN_E2E_PARAM_TOL},
    "float32": {"loss": 1e-4, "encoder": 1e-4, "other": 1e-4}}
# timed steps after each side's first step, and timed gradient all-reduces
DP_TIMED = 3


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_hp(dtype: str):
    """The flagship for the first-step check: ``dtype`` compute, the
    global batch TRAIN_B, prenet dropout and zoneout off."""
    hp = flagship(MAX_FRAMES, CHUNK, compute_dtype=dtype)
    hp.batch_size = TRAIN_B
    hp.dropout = 0.0
    hp.zoneout_hidden = hp.zoneout_cell = 0.0
    return hp


def dp_step(hp, mesh, sd=None, shape=(TRAIN_B, TRAIN_T, TRAIN_F),
            device="cuda"):
    """``train_step`` of the seeded model (``sd``, ``seeded_state_dict(hp)``
    by default; encoder and postnet dropout off) on ``device``, on the
    global batch ``train_batch(hp, *shape)`` or, with a
    mesh of several ranks, this rank's rows of it; teacher forcing 1.0.
    Returns (model, loss terms, gradient norm, each parameter's gradient on
    the CPU after the step, the weights' digest after it, a function that
    runs one more step and returns its seconds)."""
    import torch

    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        Tacotron,
        TacotronLossState,
    )
    from multilingual_text_to_speech_tpu_torch.parallel import shard_batch
    from multilingual_text_to_speech_tpu_torch.training.trainer import (
        make_optimizer,
        train_step,
    )

    model = Tacotron(hp, compute_type(hp), mesh=mesh)
    model.load_state_dict(seeded_state_dict(hp) if sd is None else sd)
    no_conv_dropout(model)
    model = model.to(device)
    opt, sched = make_optimizer(model, hp)
    batch = train_batch(hp, *shape, SEED + 20)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    teacher, state = [1] * shape[2], TacotronLossState.init(hp)

    def step():
        return train_step(model, opt, sched, batch, state, None,
                          teacher=teacher, seeds=(11, 12), device=device)

    def timed() -> float:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        if device != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    res = step()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    return (model, {k: float(v) for k, v in res.losses.items()},
            float(res.grad_norm), grads, state_digest(model), timed)


def dp_errors(got, ref):
    """Each loss term's, the gradient norm's and each parameter's gradient's
    max |got - ref| over its largest |ref| (``dp_step``'s results)."""
    (_, lg, ng, gg, _, _), (_, lr, nr, gr, _, _) = got, ref
    if set(lg) != set(lr) or set(gg) != set(gr):
        fail("[train:dp] the ranks' step and the single process's differ "
             "in their loss terms or in which parameters get gradients")
    errs = {f"loss {k}": abs(lg[k] - lr[k]) / (abs(lr[k]) + 1e-30)
            for k in lr}
    errs["gradient norm"] = abs(ng - nr) / nr
    errs.update({f"grad {n}": float((gg[n] - g).abs().max())
                 / (float(g.abs().max()) + 1e-30) for n, g in gr.items()})
    return errs


def dp_group(name: str) -> str:
    """``dp_errors``'s key -> its DP_STEP_TOL group."""
    if not name.startswith("grad "):
        return "loss"
    return "encoder" if name.startswith("grad encoder.") else "other"


def dp_child(rank: int, port: int) -> int:
    """A rank of ``[train:dp]``'s gloo group on the card: the first-step
    check in bf16 and float32 (rank 0 saves its results), DP_TIMED gradient
    all-reduces timed, then a ``Trainer`` epoch on ``[train:loop]``'s
    corpus, ``evaluate`` and ``save``, each with its K2/K3 launches;
    writes ``rank{rank}.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from multilingual_text_to_speech_tpu_torch.data import (
        TextToSpeechDatasetCollection,
    )
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )
    from multilingual_text_to_speech_tpu_torch.parallel import (
        all_reduce_gradients,
        make_mesh,
    )
    from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False      # as the parent runs
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=DP_WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    out = {"rank": rank}
    # one state dict for both compute types (the parameters are float32)
    sd = seeded_state_dict(dp_hp("float32"))
    for dtype in ("bfloat16", "float32"):
        hp = dp_hp(dtype)
        mesh = make_mesh(hp, device="cuda")
        ftd.reset_launch_counts()
        model, *res, timed = dp_step(hp, mesh, sd)
        out[dtype] = {"launches": {k: v for k, v in ftd.LAUNCHES.items()
                                   if v},
                      "want": [k for ks in ftd.TrainConfig.from_hp(
                          hp, model.decoder.memory_dim, model.dtype).kernels
                               for k in ks],
                      "seconds": [timed() for _ in range(
                          DP_TIMED if dtype == "bfloat16" else 0)]}
        if rank == 0:
            torch.save(res, DP_BASE / f"step_{dtype}.pt")
        if dtype == "bfloat16":
            params = [p for p in model.parameters() if p.grad is not None]
            ms = []
            for _ in range(DP_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_gradients(params, mesh)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            out["all_reduce"] = {"ms": ms, "bytes": 4 * sum(
                p.numel() + 1 for p in params)}
        del model, res, timed
        torch.cuda.empty_cache()

    hp = loop_hp()
    mesh = make_mesh(hp, device="cuda")
    data = TextToSpeechDatasetCollection(
        str(LOOP_BASE / "data" / "loop"), hp, device="cuda")
    tr = Trainer(hp, data, seed=SEED, mesh=mesh,
                 log_dir=str(DP_BASE / "logs"),
                 checkpoint_dir=str(DP_BASE / "ckpt"))
    k2, k3 = ftd.TrainConfig.from_hp(hp, tr.model.decoder.memory_dim,
                                     tr.model.dtype).kernels
    torch.cuda.reset_peak_memory_stats()
    ftd.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = tr.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_launches = {k: v for k, v in ftd.LAUNCHES.items() if v}
    ftd.reset_launch_counts()
    t0 = time.perf_counter()
    eval_loss = tr.evaluate()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {k: v for k, v in ftd.LAUNCHES.items() if v}
    path = tr.save(eval_loss)
    out.update(
        k2=list(k2), k3=list(k3), steps=steps, epoch_s=epoch_s,
        eval_s=eval_s, eval_loss=eval_loss, path=path,
        epoch_launches=epoch_launches, eval_launches=eval_launches,
        digest=state_digest(tr.model), moments=moments_digest(tr),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        logs=tr.logger is not None)
    (DP_BASE / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block, cuDNN's and PyTorch's own
    where it has one (the embeddings' backward accumulates by atomics
    otherwise), so that two runs of the same step agree bit for bit;
    restored on leaving."""
    import torch

    old = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old[0]
        torch.use_deterministic_algorithms(old[1], warn_only=old[2])


def phase_train_dp() -> None:
    """``[train:dp]``: (a) a mesh of one over NCCL (a store in the process)
    takes the flagship's bf16 step at B=50 bit-identical to the plain
    ``train_step`` (both under ``deterministic``), each timed; (b)
    DP_WORLD ranks on the one card over gloo (``dp_child``): their first
    steps in bf16 and float32 against this process's single-process steps
    on the same global batch (DP_STEP_TOL), the gradient all-reduce timed
    with its bytes, a ``Trainer`` epoch on ``[train:loop]``'s corpus (every
    K2/K3 kernel launched on every rank), ``evaluate`` (K2 only) and rank
    0's save, after which every rank's weights, batch-norm statistics and
    Adam moments are bit-identical; each rank's peak memory."""
    import datetime
    import math
    import shutil

    import torch
    import torch.distributed as dist

    from multilingual_text_to_speech_tpu_torch.parallel import make_mesh

    card = card_label()
    shutil.rmtree(DP_BASE, ignore_errors=True)
    DP_BASE.mkdir(parents=True)

    # (a) the mesh of one over NCCL against the plain step; one state dict
    # for every step here (the parameters are float32 in both types)
    hp = dp_hp("bfloat16")
    sd = seeded_state_dict(hp)
    hp.dropout, hp.zoneout_hidden, hp.zoneout_cell = 0.5, 0.1, 0.1
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    try:
        mesh = make_mesh(hp, device="cuda")
        if (mesh.size, mesh.backend) != (1, "nccl"):
            fail(f"[train:dp] the NCCL mesh of one: size {mesh.size}, "
                 f"backend {mesh.backend}")
        with deterministic():
            plain = dp_step(hp, None, sd)
            one = dp_step(hp, mesh, sd)
            # timed in turns: plain, mesh, mesh, plain, plain, mesh
            secs = {id(plain): [], id(one): []}
            for i in range(2 * DP_TIMED):
                r = (plain, one)[(i + i // 2) % 2]
                secs[id(r)].append(r[5]())
    finally:
        dist.destroy_process_group()
    same = (plain[1] == one[1] and plain[2] == one[2]
            and plain[4] == one[4] and plain[3].keys() == one[3].keys()
            and all(torch.equal(g, one[3][n]) for n, g in plain[3].items()))
    if not same:
        diffs = {k: v for k, v in dp_errors(one, plain).items() if v}
        fail(f"[train:dp] the NCCL mesh of one is not bit-identical to the "
             f"plain step: {diffs or 'the weights after the step'}")
    p_ms, o_ms = (1e3 * sum(secs[id(r)]) / DP_TIMED for r in (plain, one))
    say(f"[train:dp] NCCL mesh of one (store in the process) vs the plain "
        f"train_step, flagship bf16 B={TRAIN_B} T={TRAIN_T} F={TRAIN_F}, "
        f"prenet dropout and zoneout on (encoder and postnet dropout off), "
        f"deterministic algorithms: loss terms, gradient "
        f"norm, every gradient and the weights after the step bit-identical;"
        f" step {o_ms:.2f} ms against {p_ms:.2f} ms plain (mean of "
        f"{DP_TIMED} each, in turns, host clock, synchronized; {card})")
    del plain, one

    # the single process's first steps on the global batch, then the ranks
    single, single_s = {}, []
    for dtype in ("bfloat16", "float32"):
        model, *single[dtype], timed = dp_step(dp_hp(dtype), None, sd)
        if dtype == "bfloat16":
            single_s = [timed() for _ in range(DP_TIMED)]
        del model, timed
        torch.cuda.empty_cache()
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    port = free_port()
    logs = [open(DP_BASE / f"rank{r}.log", "w") for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-child", str(r),
         str(port)], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(DP_WORLD)]
    try:
        for c in children:
            c.wait(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, c in enumerate(children):
        if c.returncode != 0:
            tail = (DP_BASE / f"rank{r}.log").read_text()[-3000:]
            fail(f"[train:dp] rank {r} exited {c.returncode}:\n{tail}")
    ranks = [json.loads((DP_BASE / f"rank{r}.json").read_text())
             for r in range(DP_WORLD)]

    over = []
    for dtype in ("bfloat16", "float32"):
        got = (None, *torch.load(DP_BASE / f"step_{dtype}.pt",
                                 weights_only=False), None)
        errs = dp_errors(got, (None, *single[dtype], None))
        for r in ranks:
            missing = [k for k in r[dtype]["want"]
                       if not r[dtype]["launches"].get(k)]
            if missing:
                fail(f"[train:dp] rank {r['rank']}'s {dtype} step never "
                     f"launched {missing}")
        worst = {}
        for name, e in errs.items():
            g = dp_group(name)
            if e > DP_STEP_TOL[dtype][g]:
                over.append(f"{dtype} {name} {e:.3g}")
            if e >= worst.get(g, ("", -1.0))[1]:
                worst[g] = (name, e)
        say(f"[train:dp] {DP_WORLD} gloo ranks on one card, "
            f"{TRAIN_B // DP_WORLD} rows each, vs the single process on the "
            f"global batch B={TRAIN_B} T={TRAIN_T} F={TRAIN_F} ({dtype}, "
            f"dropout and zoneout off), each tensor's max |difference| over "
            f"its largest: " + "; ".join(
                f"{g} at most {e:.3g} ({n}; bound {DP_STEP_TOL[dtype][g]})"
                for g, (n, e) in worst.items())
            + f"; each rank's K2/K3 launches {ranks[0][dtype]['launches']}")
    if over:
        fail(f"[train:dp] the ranks' first step vs the single process over "
             f"its bounds: {over[:12]}")

    a, b = ranks[0], ranks[1]
    diffs = [k for k in ("digest", "moments", "eval_loss", "steps", "path")
             if a[k] != b[k]]
    if diffs:
        fail(f"[train:dp] the ranks differ after the epoch in {diffs}")
    for r in ranks:
        missing = [k for k in r["k2"] + r["k3"] if not r["epoch_launches"]
                   .get(k)]
        missing += [k for k in r["k2"] if not r["eval_launches"].get(k)]
        stray = [k for k in r["k3"] if r["eval_launches"].get(k)]
        if missing or stray:
            fail(f"[train:dp] rank {r['rank']}: kernels never launched "
                 f"{missing}, K3 in evaluate {stray}")
    if (a["logs"], b["logs"]) != (True, False) or os.listdir(
            DP_BASE / "ckpt") != [os.path.basename(a["path"])]:
        fail("[train:dp] logs or checkpoints written by another rank than 0")
    if not math.isfinite(a["eval_loss"]):
        fail(f"[train:dp] eval loss {a['eval_loss']}")
    say(f"[train:dp] Trainer on {DP_WORLD} gloo ranks (one card), "
        f"[train:loop]'s corpus at global B={LOOP_B}: {a['steps']} steps in "
        f"{a['epoch_s']:.4f} / {b['epoch_s']:.4f} s by rank, evaluate "
        f"{a['eval_s']:.4f} / {b['eval_s']:.4f} s (eval loss "
        f"{a['eval_loss']:.5f} on both), rank 0 saved; weights, batch-norm "
        f"statistics and Adam moments bit-identical across the ranks (state "
        f"sha256 {a['digest'][:12]}); epoch launches per rank "
        f"{a['epoch_launches']} (host clock; {card})")
    red = [sum(r["all_reduce"]["ms"]) / DP_TIMED for r in ranks]
    mib = a["all_reduce"]["bytes"] / 2 ** 20
    say(f"[train:dp] gradient all-reduce over gloo (CUDA tensors staged "
        f"through the host), {a['all_reduce']['bytes']} bytes = {mib:.1f} "
        f"MiB float32: {red[0]:.2f} / {red[1]:.2f} ms by rank (mean of "
        f"{DP_TIMED}, each " + ", ".join(f"{m:.2f}" for m in
                                        a["all_reduce"]["ms"])
        + f" on rank 0; host clock, synchronized; {card})")
    s1 = 1e3 * sum(single_s) / DP_TIMED
    s2 = [1e3 * sum(r["bfloat16"]["seconds"]) / DP_TIMED for r in ranks]
    say(f"[train:dp] bf16 step on the global batch B={TRAIN_B}: {DP_WORLD} "
        f"ranks on one card " + " / ".join(f"{v:.2f}" for v in s2)
        + f" ms by rank against the single process's {s1:.2f} ms (mean of "
        f"{DP_TIMED}, host clock, synchronized; one card shows no scaling: "
        f"the ranks share its SMs; {card})")
    say(f"[train:dp] peak device memory by rank " + " / ".join(
        f"{r['peak_gib']:.2f}" for r in ranks) + f" GiB (the epoch), the "
        f"single process's steps {single_peak:.2f} GiB; the children's run "
        f"{wall:.1f} s ({card})")


# F3: the attention kernels of all three decoders on long texts; past T =
# 2,304 att_bwd runs its sub-tiled layout (ops/fused_train_decoder.py::
# att_bwd_plan: location-sensitive float32 past 2,304, bf16 past 3,968;
# the family past 3,328 and 6,272)
LONG_T, LONG_B = (600, 1000, 1500, 2304, 4096, 8192), 8
# the flagship's train step on a long text, card against CPU in both
# compute types: B, T, F (the generated encoder takes batches of whole
# language groups: 5 rows, its 5 languages, is the smallest)
LONG_STEP = (5, 4096, 32)
# float32 weights of a long row: each carries the absolute float32 error of
# its energy (sums over 128 channels in another order), within this share
# of the row's largest weight
LONG_W_F32_TOL = 1e-4


def phase_train_long(sd_by_kind) -> None:
    """Texts of 600 to 8,192 symbols (``att_bwd_tiles``: 8 CTAs of 80 to
    1,024 positions; in float32 the tile's rows stay in device memory in
    ``train_attention``; ``att_bwd`` in sub-tiles past its single tile,
    ``att_bwd_plan``) at the flagship's widths, B=8, each attention kind
    and compute type: K2's ``train_attention`` (one step with its streams),
    K3's ``att_bwd`` and K1's ``lsa_attention`` or ``fwd_attention`` (on
    the compute type's streams and on int8 streams) against their plain
    versions on the same random inputs.  float32: the
    weights within LONG_W_F32_TOL of each row's largest, every other
    output within F32_TOL of its largest; bf16: the bounds of the T=128
    checks (W_TOL, CTX_TOL, ``att_bwd``'s TRAIN_KERNEL_TOL).  Then the
    device time of ``train_attention`` and ``att_bwd`` (location-sensitive)
    at each length and of the family's ``att_bwd`` past T = 1,500, beside
    ``att_bwd``'s bound, a bf16 train step at T=600 on the card
    against the CPU, and the flagship's step at LONG_STEP in bf16 and in
    float32 on the card against the CPU."""
    import torch

    from multilingual_text_to_speech_tpu_torch.models.tacotron import Tacotron
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    b = LONG_B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def check(what, got, ref, f32, rows=False, bound=None, slack=0.0):
        """max |got - ref| over the largest |ref| (of each row: rows, less
        ``slack`` of each row's absolute error); the check of ``what`` at
        the loop's ``tag``."""
        g, r = got.detach().float(), ref.detach().float()
        if not torch.isfinite(g).all():
            fail(f"{tag} {what}: non-finite values")
        if rows:
            err = float((((g - r).abs().amax(1) - slack)
                         / r.abs().amax(1)).max())
            bound = LONG_W_F32_TOL if f32 else W_TOL
        else:
            err = float((g - r).abs().max() / (r.abs().max() + 1e-30))
            bound = bound if bound is not None else (F32_TOL if f32
                                                     else CTX_TOL)
        if err > bound:
            fail(f"{tag} {what}: kernel vs plain off by {err:.3g} (bound "
                 f"{bound})")
        return err

    times = {}
    for kind, label in (("location_sensitive", "ls"), *FAMILY.items()):
        hp = flagship(32, 16, kind)
        model = Tacotron(hp)
        model.load_state_dict(sd_by_kind[kind])
        cell = model.decoder.cell.cuda()
        h, a = hp.decoder_dimension, hp.attention_dimension
        mem = model.decoder.memory_dim
        for dtype in (torch.bfloat16, torch.float32):
            f32 = dtype == torch.float32
            cfg = ftd.TrainConfig.from_hp(hp, mem, dtype)
            ops = ftd.compute_operands(ftd.train_operands(cell, cfg), cfg)
            bundle = fd.extract_decoder_bundle(cell, dtype,
                                               quantize_gates=True)
            bundle_q8 = fd.extract_decoder_bundle(cell, dtype,
                                                  quantize_gates=True,
                                                  q_streams=True)
            for t in LONG_T:
                worst = {}
                tag = f"{label} {dtype_label(dtype)} T={t}"
                memory = rnd(b, t, mem).to(dtype)
                mtb = rnd(b, t, a, scale=0.5).to(dtype)
                lengths = torch.randint(t // 2, t + 1, (b,), device="cuda",
                                        generator=gen)
                mask = torch.arange(t, device="cuda")[None] < lengths[:, None]
                mask_add = torch.where(mask, 0.0, -1e9)
                if cfg.family:
                    state = torch.clamp(torch.rand(b, t, device="cuda",
                                                   generator=gen) ** 4 * mask,
                                        min=1e-6)
                    state = state / state.sum(-1, keepdim=True)
                else:
                    pos = (0.2 + 0.6 * torch.rand(b, 1, device="cuda",
                                                  generator=gen)) * lengths[
                        :, None]
                    state = torch.clamp(pos - torch.arange(
                        t, device="cuda")[None], 0.0, 1.0) * mask
                tp0 = 0.1 + 0.8 * torch.rand(b, device="cuda", generator=gen)
                h_att, x = rnd(b, h), rnd(b, hp.prenet_dimension).relu()
                q = rnd(b, a).to(dtype).float()

                def forward(fn):
                    cc = state.clone()
                    o = [torch.empty(b, t, device="cuda"),
                         torch.empty(b, t, dtype=dtype, device="cuda"),
                         torch.empty(b, mem, device="cuda")]
                    dsts = [torch.empty(b, mem, dtype=dtype, device="cuda")
                            for _ in range(3)]
                    agent = (ftd.AgentArgs(tp0.clone(), torch.empty(
                        b, device="cuda"), h_att, x, ops["ta_w"], ops["ta_b"])
                        if cfg.agent else None)
                    fn(q, cc, memory, mtb, mask_add, ops.get("lc"), ops["v"],
                       o[0], o[1], o[2], dsts, agent=agent)
                    return [cc, *o, *dsts] + ([agent.tp] if agent else [])

                got = forward(ftd.train_attention)
                ref = forward(ftd.PLAIN.train_attention)
                worst["train_attention w"] = check(
                    "train_attention w", got[1], ref[1], f32, rows=True)
                worst["train_attention ctx"] = check(
                    "train_attention ctx", got[3], ref[3], f32)
                if cfg.agent:
                    worst["train_attention tp"] = check(
                        "train_attention tp", got[-1], ref[-1], f32,
                        bound=ATOL)
                if not torch.equal(got[2], ref[2]):
                    fail(f"{tag}: train_attention's state stream differs")

                w_s = ref[1]
                dctx, dw = rnd(b, mem), rnd(b, t, scale=0.1)
                dcum0, dtp0 = rnd(b, t, scale=0.1), rnd(b, scale=0.5)
                dh0 = rnd(b, h, scale=0.1)

                def backward(fn):
                    acc = [torch.zeros(b, t, a, device="cuda"),
                           None if cfg.family else torch.zeros(
                               b, cfg.taps, a, device="cuda"),
                           torch.zeros(b, a, device="cuda"), dcum0.clone()]
                    o = [torch.empty(b, a, dtype=dtype, device="cuda"),
                         torch.empty(b, mem, dtype=dtype, device="cuda")]
                    extra, fam = [], None
                    if cfg.agent:
                        extra = [dtp0.clone(), torch.empty(b, device="cuda"),
                                 dh0.clone(), torch.empty(
                                     b, hp.prenet_dimension, device="cuda")]
                        fam = ftd.FamilyBwd(mask_add, tp0, ref[-1], extra[0],
                                            extra[1], ops["ta_w"], extra[2],
                                            extra[3])
                    elif cfg.family:
                        fam = ftd.FamilyBwd(mask_add)
                    fn(q, ref[2], w_s, memory, mtb, ops.get("lc"), ops["v"],
                       dctx, dw, acc[3], acc[0], acc[1], acc[2], *o, fam=fam)
                    return [x for x in acc if x is not None] + o + extra

                ftd.reset_launch_counts()
                got, ref_b = backward(ftd.att_bwd), backward(ftd.PLAIN.att_bwd)
                inst = ftd.instance("att_bwd_fwd" if cfg.family
                                    else "att_bwd", dtype)
                if ftd.LAUNCHES[inst] != 1:
                    fail(f"{tag}: {inst} launched {ftd.LAUNCHES[inst]} times "
                         f"for one call")
                bound = TRAIN_KERNEL_TOL["att_bwd"]
                for i, (g, r) in enumerate(zip(got, ref_b)):
                    worst[f"att_bwd output {i}"] = check(
                        f"att_bwd output {i}", g, r, f32,
                        bound=F32_TOL if f32 else bound[
                            "bf16" if r.dtype == torch.bfloat16 else "f32"])

                # K1 on the compute type's streams, then on int8 streams
                # (the _q8 instances; in bf16 the staged ones), quantized
                # as a serving chunk quantizes them
                mem_q, mtb_q, _ = fd.chunk_operands(bundle_q8, memory, mtb,
                                                    mask)
                for k1, bnd, mm, mt in (("K1", bundle, memory, mtb),
                                        ("K1 q8", bundle_q8, mem_q, mtb_q)):
                    fd.reset_launch_counts()
                    if cfg.family:
                        tp = tp0[:, None] if cfg.agent else None
                        got = fd.fwd_attention(h_att, state, tp, mm, mt,
                                               mask_add, x, bnd)
                        ref_k = fd.fwd_attention_plain(h_att, state, tp, mm,
                                                       mt, mask_add, x, bnd)
                        w_k, w_p, slack = got[1], ref_k[1], 0.0
                    else:
                        got = fd.lsa_attention(h_att, state, mm, mt,
                                               mask_add, bnd)
                        ref_k = fd.lsa_attention_plain(h_att, state, mm, mt,
                                                       mask_add, bnd)
                        # the weights read back as cum' - cum: in float32
                        # each side's cum + w carries its own rounding, one
                        # ulp of the largest cum', which past T = 2,304
                        # exceeds LONG_W_F32_TOL of a row's largest weight
                        # (as tests/test_torch_gpu.py::_cum_slack); taken
                        # out of the reading there
                        w_k, w_p = got[1] - state, ref_k[1] - state
                        slack = (torch.finfo(torch.float32).eps
                                 * float(ref_k[1].abs().max())
                                 if f32 and t > 2304 else 0.0)
                    name = fd.instance("fwd_attention" if cfg.family
                                       else "lsa_attention", dtype,
                                       bnd.q_streams)
                    if fd.LAUNCHES[name] != 1:
                        fail(f"{tag}: {name} launched {fd.LAUNCHES[name]} "
                             f"times for one call")
                    worst[f"{k1} ctx"] = check(f"{k1} ctx", got[0],
                                               ref_k[0], f32)
                    worst[f"{k1} w"] = check(f"{k1} w", w_k, w_p, f32,
                                             rows=True, slack=slack)
                top = max(worst, key=worst.get)
                plan = ftd.att_bwd_plan(t, a, mem, cfg.family, dtype)
                layout = (f"sub-tiles of {plan.sub}" if plan.sub
                          else "single tile")
                say(f"[train:long] {tag} B={b}: train_attention, att_bwd "
                    f"({plan.cluster} CTAs of {plan.tile}, {layout}) and "
                    f"K1's attention (also on int8 streams) vs plain, "
                    f"{len(worst)} outputs, each within its bound; the worst "
                    f"{top} {worst[top]:.3g}")
                # the device times: location-sensitive at every length,
                # the family's att_bwd past T = 1,500
                if cfg.family and t <= 1500:
                    continue
                n_bytes, ops_n, *mm_ops = train_work(cfg, b, t)[
                    "att_bwd_fwd" if cfg.family else "att_bwd"]
                b_ms, b_by, _ = row_bound("att_bwd", n_bytes, ops_n,
                                          "f32" if f32 else "bf16", *mm_ops)
                times.setdefault((label, dtype_label(dtype)), []).append(
                    (t, None if cfg.family else device_ms(
                        lambda: forward(ftd.train_attention), ours_only=True),
                     device_ms(lambda: backward(ftd.att_bwd),
                               ours_only=True), b_ms, b_by, layout))
    for (label, d), rows in times.items():
        what = "att_bwd" if label in FAMILY.values() else (
            "train_attention / att_bwd")
        say(f"[train:long] {label} {d} device time (torch.profiler, B={b}) "
            f"of {what}, att_bwd's bound: " + "; ".join(
                f"T={t} " + ("" if f is None else f"{f:.4f} / ")
                + f"{g:.4f} ms, bound {bm:.5f} ms ({by}; {layout})"
                for t, f, g, bm, by, layout in rows)
            + f" ({card_label()})")
    hp, sd = flagship(32, 16), sd_by_kind["location_sensitive"]
    phase_train_vs_cpu(hp, sd, t_len=LONG_T[0])
    b, t, f = LONG_STEP
    phase_train_vs_cpu(hp, sd, t_len=t, b=b)
    phase_train_f32_vs_cpu(flagship(32, 16, **F32), sd, b=b, t_len=t,
                           frames=f, unguarded_too=False)


def train_work(cfg, b, t_len):
    """(bytes each input once + outputs once, operations) of each K2/K3
    kernel row at B=b, T=t_len, compute-type operands and streams of
    ``cfg.dtype``'s size (``bf``: 2 bytes in bf16, 4 in float32)."""
    h, p, m, mem, a, k, n = (cfg.hidden, cfg.prenet_dim, cfg.mmel,
                             cfg.mem_dim, cfg.att_dim, cfg.taps,
                             cfg.n_prenet)
    ka, kg, kh = cfg.ka, cfg.kg, cfg.kh
    f32, bf = 4, cfg.dtype.itemsize
    pre_w = (m * p + (n - 1) * p * p)
    # one LSTM cell's backward as it runs fused: the activations and the
    # previous c read, dc read and written, dg and dh_reg written (its h
    # cotangent stays in registers)
    cell = b * (4 * h * bf + h * bf + 2 * h * f32 + 4 * h * bf + h * f32)
    return {
        "train_prenet": (b * m * (bf + f32) + pre_w * bf + n * p * f32
                         + b * m * bf + n * b * p * bf + b * p * bf,
                         2 * b * pre_w),
        # both LSTMs of a step: rows, weights, biases, h/c carries read and
        # written, activations, c stream and two h copies out
        "train_gate_lstm": (b * (ka + kg) * bf + 4 * h * (ka + kg) * bf
                            + 2 * 4 * h * f32
                            + 2 * (4 * b * h * f32 + 4 * b * h * bf
                                   + b * h * bf + 2 * b * h * bf),
                            2 * b * (ka + kg) * 4 * h),
        "train_query": (b * h * bf + h * a * bf + b * a * f32, 2 * b * h * a),
        # the location conv's band product apart (the third item)
        "train_attention": (b * a * f32 + 2 * b * t_len * f32
                            + b * t_len * (mem + a) * bf + b * t_len * f32
                            + k * a * bf + a * f32 + b * t_len * (f32 + bf)
                            + b * mem * (f32 + 3 * bf),
                            2 * b * t_len * (a * (k + 1) + mem),
                            2 * b * t_len * a * k),
        "train_head": (b * kh * bf + (m + 1) * kh * bf + (m + 1) * f32
                       + b * (2 * m + 1) * f32, 2 * b * kh * (m + 1)),
        # with the generator cell: dctx_tot written, dh_gen_tot not; the
        # product's operations apart (the third item: row_ops)
        "bwd_head": (b * (2 * m + 1) * f32 + (m + 1) * kh * bf
                     + b * kh * f32 + b * m * bf + b * mem * f32 + cell,
                     2 * b * (m + 1) * kh + 20 * b * h,
                     2 * b * (m + 1) * kh),
        # both LSTM cells of a step, inside their host launches
        "bwd_cell": (2 * cell, 2 * 20 * b * h),
        # the three products of a step: generator, query (with the
        # attention cell, dh_att_tot read and not written), attention
        "bwd_gemm": (b * 8 * h * bf + 4 * h * (kg + ka) * bf + h * a * bf
                     + b * a * bf + b * (kg + ka + 2 * h + mem) * f32 + cell,
                     2 * b * 4 * h * (kg + ka) + 2 * b * a * h + 20 * b * h),
        "att_bwd": (b * a * f32 + b * t_len * (bf + f32)
                    + b * t_len * (mem + a) * bf + k * a * bf + a * f32
                    + b * mem * f32
                    + b * t_len * f32 * 3 + 2 * b * t_len * a * f32
                    + 2 * b * k * a * f32 + 2 * b * a * f32 + b * a * bf
                    + b * mem * bf,
                    2 * b * t_len * (3 * a * k + mem + 4 * a),
                    2 * b * t_len * 3 * a * k),
        "bwd_prenet": (b * p * f32 + n * b * p * bf + pre_w * bf
                       + n * b * p * bf + b * m * (bf + f32), 2 * b * pre_w),
        # the forward family's: no location conv; with the transition
        # agent, its t_prob, h_att, prenet output and weights
        "train_attention_fwd": (
            b * a * f32 + 2 * b * t_len * f32 + b * t_len * (mem + a) * bf
            + b * t_len * f32 + a * f32 + b * t_len * (f32 + bf)
            + b * mem * (f32 + 3 * bf)
            + (3 * b * f32 + b * (h + p) * f32 + (mem + h + p + 1) * f32
               if cfg.agent else 0),
            2 * b * t_len * (a + mem) + (2 * b * (mem + h + p)
                                         if cfg.agent else 0)),
        "att_bwd_fwd": (
            b * a * f32 + b * t_len * (bf + f32) + b * t_len * (mem + a) * bf
            + b * t_len * f32 + a * f32 + b * mem * f32 + b * t_len * f32
            + 2 * b * t_len * f32 + 2 * b * t_len * a * f32
            + 2 * b * a * f32 + b * a * bf + b * mem * bf
            + (5 * b * f32 + (mem + h + p) * f32 + 2 * b * h * f32
               + b * p * f32 if cfg.agent else 0),
            2 * b * t_len * (mem + 3 * a) + (2 * b * (mem + h + p)
                                             if cfg.agent else 0)),
    }


def phase_train_timings(hp, errs, launches, per_step, inputs, main,
                        frames: int = TRAIN_F):
    import torch

    ftd, calls, unfused = inputs
    model, opt, sched, batch, state = main
    cfg = ftd.TrainConfig.from_hp(hp, model.decoder.memory_dim, model.dtype)
    ops = ftd.compute_operands(ftd.train_operands(model.decoder.cell, cfg),
                               cfg)
    # the yardsticks in the compute type (float32: full float32, as main
    # checks torch.backends.cuda.matmul.allow_tf32 is False)
    b, dev, ct = TRAIN_B, "cuda", cfg.dtype
    rows_in = {w: torch.randn(b, ops[f"{w}_w"].shape[1], device=dev).to(ct)
               for w in ("att", "gen", "head")}
    h16 = torch.randn(b, cfg.hidden, device=dev).to(ct)
    dg = torch.randn(b, 4 * cfg.hidden, device=dev).to(ct)
    dq = torch.randn(b, cfg.att_dim, device=dev).to(ct)
    dfv = torch.randn(b, cfg.mmel + 1, device=dev).to(ct)
    da_p = torch.randn(b, cfg.prenet_dim, device=dev).to(ct)
    library = {
        "train_gate_lstm": lambda: (
            torch.addmm(ops["att_b"].to(ct), rows_in["att"], ops["att_w"].t()),
            torch.addmm(ops["gen_b"].to(ct), rows_in["gen"],
                        ops["gen_w"].t())),
        "train_query": lambda: torch.mm(h16, ops["wq"]),
        "train_head": lambda: torch.addmm(ops["head_b"].to(ct),
                                          rows_in["head"], ops["head_w"].t()),
        # [dframe | dstop] @ the head weight, added to the h_gen | ctx
        # cotangents
        "bwd_head": lambda: torch.addmm(rows_in["head"], dfv, ops["head_w"]),
        "bwd_gemm":lambda: (torch.mm(dg, ops["gen_w"]),
                             torch.mm(dq, ops["wq"].t()),
                             torch.mm(dg, ops["att_w"])),
        # da @ W^T of each layer, the product only (no masks)
        "bwd_prenet": lambda: [torch.mm(da_p, w.t()) for w, _ in
                               ftd.prenet_layers(ops, cfg)],
    }
    work = train_work(cfg, b, TRAIN_T)
    k2, _ = cfg.kernels
    peak = "f32" if ct == torch.float32 else "bf16"
    rows_ms = {}
    # the cells' row is a difference of readings of a few microseconds:
    # those readings (the hosts with and without their cell) over more
    # calls
    cell_iters = 50
    alone = ({k: device_ms(lambda r=run: r(ftd.KERNELS), iters=cell_iters,
                           ours_only=True)
              for k, run in unfused.items()} if "bwd_cell" in calls else {})
    rows = []
    for name, run in calls.items():
        if name == "bwd_cell":
            # what the two cells add to the launches that run them
            ms = (rows_ms["bwd_head"] + alone["dq_product_with_cell"]
                  - alone["bwd_head"] - alone["dq_product"])
            events = "a difference of readings"
            plain_ms = device_ms(lambda: unfused["cells_alone"](ftd.PLAIN),
                                 iters=5)
            say(f"[train:time] bwd_cell fused: bwd_head {alone['bwd_head']:.4f}"
                  f" -> {rows_ms['bwd_head']:.4f} ms with the generator cell, "
                  f"the dq product {alone['dq_product']:.4f} -> "
                  f"{alone['dq_product_with_cell']:.4f} ms with the attention "
                  f"cell; the two cells alone (bwd_cell's own launches) "
                  f"{alone['cells_alone']:.4f} ms")
        elif name in TURN_ROWS:
            ms, plain_ms, turns, events = turns_ms(
                lambda: run(ftd.KERNELS), lambda: run(ftd.PLAIN))
            events += ", in turns with plain: " + ", ".join(
                f"{x:.4f}" for x in turns)
        else:
            ms = device_ms(lambda: run(ftd.KERNELS), ours_only=True,
                           iters=cell_iters if name == "bwd_head" else 10)
            events = events_note()
            plain_ms = device_ms(lambda: run(ftd.PLAIN), iters=5)
        rows_ms[name] = ms
        lib_ms = device_ms(library[name]) if name in library else None
        n_bytes, ops_n, *mm_ops = work[name]
        b_ms, b_by, ffma = row_bound(name, n_bytes, ops_n, peak, *mm_ops)
        inst = ftd.instance(name, ct)
        # the configuration beside the instance's name, its dtype left out
        label = ":".join(x for x in _LABEL.split(":") if x and x != "f32")
        rows.append({
            "name": f"{inst}[{label}]" if label else inst, "route": "cuda",
            "source": TRAIN_SOURCE,
            "replaces": REPLACES["K2" if inst in k2 else "K3"],
            "launches": launches[inst], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
        })
        # the library's bwd_head is the product alone: beside it, the
        # kernel without its fused cell
        alone_note = (f" (the kernel without its cell "
                      f"{alone['bwd_head']:.4f} ms)"
                      if name == "bwd_head" and "bwd_head" in alone else "")
        say(f"[train:time] {inst} (device time, torch.profiler): kernel "
            f"{ms:.4f} ms ({events}), plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}){ffma}, "
            f"library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            + alone_note + f", "
            f"{per_step[inst] / frames:.2f} launches per decoder step")

    from torch.profiler import ProfilerActivity, profile

    from multilingual_text_to_speech_tpu_torch.training import trainer

    gen = torch.Generator().manual_seed(SEED + 11)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(model, opt, sched, batch, state, gen,
                           teacher=[1] * frames)
        torch.cuda.synchronize()
    busy = device_busy(prof)
    if busy is None:
        say("[train:profile] device busy share: not measured (the profiler "
              "recorded no device events)")
    else:
        share, window, by_name = busy
        say(f"[train:profile] one train step under torch.profiler: device "
              f"busy {share:.4f} of {window / 1e3:.3f} ms from first to last "
              f"kernel; device ms by kernel: " + ", ".join(
                  f"{k} {v / 1e3:.2f}" for k, v in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:14]))
    return rows


def phase_train_f32_and_long(sd) -> list:
    """Float32 compute in training (K2/K3's float32 instances) at the
    flagship's widths: the kernels against plain, four timed steps, the
    card against the CPU (with and without the guard of the cuDNN calls),
    the eval forward and the times; the forward family in float32 at a
    smaller depth; then texts over 512 symbols (``[train:long]``).  ``sd``:
    the flagship's weights.  Returns the kernel rows."""
    with labelled("f32"):
        hp32 = flagship(MAX_FRAMES, CHUNK, **F32)
        with phase("train:kernels"):
            errs32, inputs32 = phase_train_kernels(hp32, sd)
        with phase("train:main"):
            l32, per32, _, main32 = phase_train_main(hp32, sd)
        with phase("train:cpu"):
            phase_train_f32_vs_cpu(hp32, sd)
        with phase("train:eval"):
            phase_train_eval(hp32, sd)
        with phase("train:time"):
            rows = phase_train_timings(hp32, errs32, l32, per32, inputs32,
                                       main32)
        del main32, inputs32
    sd_kind = {"location_sensitive": sd}
    for kind, label in FAMILY.items():
        with labelled(f"f32:{label}"), phase("train"):
            hp_f = flagship(FAMILY_FRAMES, CHUNK, kind, **F32)
            sd_kind[kind] = sd_f = seeded_state_dict(hp_f)
            errs_f, inputs_f = phase_train_kernels(
                hp_f, sd_f, only=FAMILY_TRAIN_KERNELS)
            l_f, per_f, _, main_f = phase_train_main(
                hp_f, sd_f, timed=1, frames=F32_FAMILY_FRAMES)
            rows += phase_train_timings(hp_f, errs_f, l_f, per_f, inputs_f,
                                        main_f, frames=F32_FAMILY_FRAMES)
            del main_f, inputs_f
    # texts over 512 symbols: all three attention kernels, both compute
    # types, a train step at T=600, and the flagship's steps at T=4,096
    with phase("train:long"):
        phase_train_long(sd_kind)
    return rows


# ---------------------------------------------------------------------------
# the CBHG linear postnet and the cosine-similarity classifier
# ---------------------------------------------------------------------------

# [cbhg]: lines synthesized (MAX_FRAMES frames each), of them checked card
# against CPU (32 frames) and vocoded card against CPU; lines of the float32
# evaluation chain (EVAL_FRAMES frames)
CBHG_LINES, CBHG_CHECK_LINES, EVAL_LINES, EVAL_FRAMES = 16, 2, 4, 32
# the evaluation chain's MCD of the card's CLI output against the CPU's,
# float32 on both (dB; DTW over equal lengths)
EVAL_MCD_TOL = 0.1


def reference_layout():
    """``tests/torch_reference_layout.py`` (a weight tree as the reference
    model's PyTorch checkpoint), loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_reference_layout", ROOT / "tests" / "torch_reference_layout.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cbhg_hp(max_frames: int, chunk: int, **over):
    """The flagship with the CBHG postnet (``predict_linear``) and the
    cosine-similarity classifier, served, with linear normalization
    constants; ``over`` as ``flagship``'s."""
    hp = flagship(max_frames, chunk, **{
        "predict_linear": True, "reversal_classifier_type": "cosine",
        **over})
    bins = hp.num_fft // 2 + 1
    hp.lin_normalize_mean = [float(-3.0 + 0.002 * i) for i in range(bins)]
    hp.lin_normalize_variance = [float(1.0 + 0.001 * i)
                                 for i in range(bins)]
    return hp


def postnet_ms(hp, sd, frames: int):
    """CUDA-event times of ``model.postnet``'s forward and backward (its
    weights' and its input's gradients) at B=TRAIN_B, ``frames`` frames,
    in train mode, and of the CBHG's GRU alone (None for the conv
    postnet): its packed forward and backward on the highway layers'
    width."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    model = train_model(hp, sd)
    pre = torch.randn(TRAIN_B, frames, hp.num_mels, device="cuda",
                      requires_grad=True)
    lengths = torch.full((TRAIN_B,), frames, device="cuda")

    def run():
        model.postnet(pre, lengths).float().sum().backward()
    total = cuda_ms(run, iters=5, warmup=2)
    if not hp.predict_linear:
        return total, None
    gru = model.postnet.bigru
    x = torch.randn(TRAIN_B, frames, gru.input_size, device="cuda",
                    requires_grad=True)

    def run_gru():
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True)
        gru(packed)[0].data.sum().backward()
    return total, cuda_ms(run_gru, iters=5, warmup=2)


def phase_cbhg(flagship_step_s: float) -> None:
    """``[cbhg]``: the flagship with the CBHG postnet and the cosine
    classifier (``cbhg_hp``, seeded weights).  A bf16 training step at
    B=50, T=128, F=512 (``phase_train_main``: every K2/K3 kernel launched,
    no other) against the flagship's conv-postnet step, and each postnet's
    forward and backward alone; the B=10 step card against CPU
    (``phase_train_vs_cpu``, the [train:*] bounds); CBHG_LINES lines x
    MAX_FRAMES frames through K1 (launch counts reset just before and read
    just after), CBHG_CHECK_LINES of them at 32 frames card against CPU;
    ``vocode_batch`` of the linear spectrograms (no NNLS) timed, and
    Griffin-Lim card against CPU from shared phases; a reference-layout
    checkpoint through the port's import CLI to ``from_checkpoint`` on the
    card; in float32, the synthesis CLI on card and CPU writing the
    evaluation layout, ``evaluation.mcd`` scoring the card against the CPU
    and ``evaluation.asr`` + ``cer`` with a local recognizer that echoes
    the metafile."""
    import io
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from multilingual_text_to_speech_tpu_torch.cli import (
        import_reference_checkpoint as import_cli,
    )
    from multilingual_text_to_speech_tpu_torch.cli import synthesize as cli
    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.evaluation import asr, cer, mcd
    from multilingual_text_to_speech_tpu_torch.interop import params_to_jax
    from multilingual_text_to_speech_tpu_torch.ops import audio
    from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
    from multilingual_text_to_speech_tpu_torch.ops import mel, stft
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
    from multilingual_text_to_speech_tpu_torch.training import checkpoint

    label = card_label()
    hp = cbhg_hp(MAX_FRAMES, CHUNK)
    sd = seeded_state_dict(hp)
    bins = hp.num_fft // 2 + 1

    # training: the step, its share beside the conv postnet's, the card
    # against the CPU
    with torch.enable_grad(), labelled("cbhg"):
        _, _, step_s, state = phase_train_main(hp, sd, timed=2)
        del state
        cbhg_ms, gru_ms = postnet_ms(hp, sd, TRAIN_F)
        conv_hp = flagship(MAX_FRAMES, CHUNK)
        conv_ms, _ = postnet_ms(conv_hp, seeded_state_dict(conv_hp),
                                TRAIN_F)
        phase_train_vs_cpu(hp, sd)
    say(f"[cbhg] train_step B={TRAIN_B} T={TRAIN_T} F={TRAIN_F} bf16 with "
        f"the CBHG and the cosine classifier: {step_s:.4f} s, "
        f"{step_s / flagship_step_s:.3f} x the conv postnet's "
        f"{flagship_step_s:.4f} s ([train:main]); the postnet's forward "
        f"and backward alone: CBHG {cbhg_ms:.3f} ms "
        f"({cbhg_ms / 1e3 / step_s:.1%} of its step; its GRU alone "
        f"{gru_ms:.3f} ms), conv {conv_ms:.3f} ms (CUDA events); {label}")

    # synthesis through K1 and the card against the CPU
    lines = lines_for(hp, -(-CBHG_LINES // len(hp.languages)),
                      SEED + 20)[:CBHG_LINES]
    syn = Synthesizer(hp, sd, device="cuda")
    syn.synthesize_batch_lines(lines[:2], seed=1)          # warm-up
    torch.cuda.synchronize()
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    specs = syn.synthesize_batch_lines(lines, seed=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fd.LAUNCHES)
    b = syn.bundle
    path = fd.path_kernels(b.att_kind, b.dtype, b.q_streams)
    if any(launches[k] == 0 for k in path) or any(
            launches[k] for k in launches if k not in path):
        fail(f"[cbhg] synthesis kernels {path}: launches {launches}")
    if any(s.shape != (bins, MAX_FRAMES) or not np.isfinite(s).all()
           for s in specs):
        fail("[cbhg] synthesis: wrong shapes or non-finite spectrograms")
    frames = CBHG_LINES * MAX_FRAMES
    say(f"[cbhg] {CBHG_LINES} lines x {MAX_FRAMES} frames through K1 "
        f"({mode_of(b)}) and the CBHG: [{bins}, {MAX_FRAMES}] linear "
        f"spectrograms, {frames} frames in {seconds:.4f} s = "
        f"{frames / seconds:.1f} mel frames/s (host clock, after a warm-up"
        f"); launches { {k: v for k, v in launches.items() if v} }; {label}")
    small = cbhg_hp(32, 16)
    check = lines[:CBHG_CHECK_LINES]
    got = Synthesizer(small, sd, device="cuda").synthesize_batch_lines(
        check, seed=4)
    ref = Synthesizer(small, sd, device="cpu").synthesize_batch_lines(
        check, seed=4)
    errs = [float(np.linalg.norm(g - r) / np.linalg.norm(r))
            for g, r in zip(got, ref)]
    if max(errs) > E2E_REL_TOL or any(g.shape != r.shape
                                      for g, r in zip(got, ref)):
        fail(f"[cbhg] synthesis card vs CPU: relative errors {errs}")
    say(f"[cbhg] {len(check)} lines x 32 frames, card vs CPU plain path "
        f"(bf16): max relative error {max(errs):.3g} (bound {E2E_REL_TOL})")

    # Griffin-Lim on the linear spectrograms
    hop = audio.ms_to_frames(hp.stft_shift_ms, hp)
    syn.vocode_batch(specs[:2], seed=1)                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = syn.vocode_batch(specs, seed=2)
    torch.cuda.synchronize()
    vocode_s = time.perf_counter() - t0
    if any(w.shape != (hop * (MAX_FRAMES - 1),) or not np.isfinite(w).all()
           for w in wavs):
        fail("[cbhg] vocode_batch: wrong lengths or non-finite waveforms")
    audio_s = CBHG_LINES * hop * (MAX_FRAMES - 1) / hp.sample_rate
    n_fft, win = hp.num_fft, audio.ms_to_frames(hp.stft_window_ms, hp)
    mag = mel.db_to_amplitude(torch.as_tensor(
        np.stack(specs), device="cuda")) ** hp.griffin_lim_power
    gl_ms = cuda_ms(lambda: stft.griffin_lim(
        mag, n_fft, hop, win, n_iter=hp.griffin_lim_iters,
        generator=torch.Generator("cuda").manual_seed(0)), iters=3,
        warmup=1)
    pair = np.stack(specs[:CBHG_CHECK_LINES])
    angles = stft.random_angles(pair.shape, torch.Generator().manual_seed(
        SEED), "cpu")
    hp10 = HParams.from_state_dict(hp.state_dict())
    hp10.griffin_lim_iters = 10
    card, cpu = (audio.inverse_spectrogram_batch(
        pair, hp10, mel=False, angles=angles, device=dev)
        for dev in ("cuda", "cpu"))
    gl_err = max(float(np.abs(c - r).max() / np.abs(r).max())
                 for c, r in zip(card, cpu))
    if gl_err > GL_TOL:
        fail(f"[cbhg] Griffin-Lim on linear spectrograms, card vs CPU: "
             f"{gl_err} of the peak (bound {GL_TOL})")
    say(f"[cbhg] vocode_batch of {CBHG_LINES} linear spectrograms x "
        f"{MAX_FRAMES} frames ({hp.griffin_lim_iters} iterations, no NNLS) "
        f"on the card: {vocode_s:.4f} s (host clock, synchronized) = "
        f"{audio_s / vocode_s:.1f} audio-seconds/s, Griffin-Lim alone "
        f"{gl_ms:.3f} ms (CUDA events); 10 iterations card vs "
        f"CPU from shared phases: max |diff| {gl_err:.3g} of the peak "
        f"(bound {GL_TOL}); {label}")
    del syn

    with tempfile.TemporaryDirectory() as tmp:
        # a reference-layout checkpoint through the import CLI (the
        # importer ports the reversal classifier only, as the JAX one)
        hp_ref = cbhg_hp(32, 16, reversal_classifier_type="reversal")
        sd_ref = seeded_state_dict(hp_ref)
        src = os.path.join(tmp, "reference.pt")
        reference_layout().save_reference_checkpoint(
            src, params_to_jax(sd_ref, hp_ref), hp_ref)
        out = os.path.join(tmp, "imported.ckpt")
        t0 = time.perf_counter()
        import_cli.main([src, "-o", out])
        import_s = time.perf_counter() - t0
        restored = Synthesizer.from_checkpoint(out)
        got_sd = restored.model.state_dict()
        differ = [k for k, t in sd_ref.items()
                  if not torch.equal(got_sd[k].cpu(), t)]
        if restored.device.type != "cuda" or differ:
            fail(f"[cbhg] imported checkpoint: on {restored.device}, "
                 f"tensors differing {differ[:3]}")
        got = restored.synthesize_batch_lines(check, seed=5)
        ref = Synthesizer(hp_ref, sd_ref, device="cuda"
                          ).synthesize_batch_lines(check, seed=5)
        if any(not np.array_equal(g, r) for g, r in zip(got, ref)):
            fail("[cbhg] imported checkpoint: spectrograms differ from the "
                 "in-memory synthesizer's")
        say(f"[cbhg] reference-layout checkpoint -> import CLI in "
            f"{import_s:.2f} s -> Synthesizer.from_checkpoint on the card: "
            f"{len(sd_ref)} tensors and {len(check)} lines' spectrograms "
            "bit-identical to the in-memory model's")
        del restored

        # the evaluation chain in float32: the CLI on the card and on the
        # CPU, MCD of one against the other, ASR and CER
        hp32 = cbhg_hp(EVAL_FRAMES, 16, compute_dtype="float32")
        hp32.griffin_lim_iters = 10
        ckpt = os.path.join(tmp, "f32.ckpt")
        checkpoint.save_checkpoint(ckpt, epoch=0, step=0, state_dict=sd,
                                   hp=hp32, criterion_state={})
        where = os.path.join(tmp, "eval")
        language = "german"
        eval_lines = [f"{i:06d}|{line.split('|')[1][:40]}|"
                      f"{line.split('|')[2]}|de"
                      for i, line in enumerate(lines[:EVAL_LINES])]
        os.makedirs(os.path.join(where, "all_meta_files"))
        with open(os.path.join(where, "all_meta_files", f"{language}.txt"),
                  "w", encoding="utf-8") as f:
            for line in eval_lines:
                idx, text = line.split("|")[:2]
                print(f"{idx}|{text}|", file=f)
        runs = {"card": [], "cpu": ["--cpu"]}
        for name, extra in runs.items():
            stdin = sys.stdin
            sys.stdin = io.StringIO("\n".join(eval_lines) + "\n")
            try:
                cli.main(["--checkpoint", ckpt, "--output",
                          os.path.join(tmp, name), "--batch_size",
                          str(EVAL_LINES), "--save_spec", "--seed", "3"]
                         + extra)
            finally:
                sys.stdin = stdin
        specs_dir = os.path.join(where, "card", "spectrograms", language)
        audios_dir = os.path.join(where, "card", "audios", language)
        truth_dir = os.path.join(where, "ground-truth", "spectrograms")
        for d in (specs_dir, audios_dir, truth_dir):
            os.makedirs(d)
        for line in eval_lines:
            idx = line.split("|")[0]
            shutil.move(os.path.join(tmp, "card", f"{idx}.npy"), specs_dir)
            shutil.move(os.path.join(tmp, "card", f"{idx}.wav"), audios_dir)
            shutil.move(os.path.join(tmp, "cpu", f"{idx}.npy"), truth_dir)
        mcds = mcd.evaluate_language(language, "card", where)
        texts = dict(line.split("|")[:2] for line in eval_lines)

        def echo(path, code, rate):
            idx = os.path.basename(path)[:-4]
            return [{"alternatives": [{"transcript": texts[idx]}]}]

        n = asr.transcribe_language(language, "card", where,
                                    hp32.sample_rate, recognize_fn=echo)
        cers = cer.evaluate_language(language, "card", where)
        cer.write_report(cers, os.path.join(where, "card", "cer",
                                            f"{language}.txt"))
        worst = max(v for _, v in mcds)
        if (len(mcds) != EVAL_LINES or worst > EVAL_MCD_TOL
                or n != EVAL_LINES or [c for _, c in cers]
                != [0.0] * EVAL_LINES):
            fail(f"[cbhg] evaluation chain: MCD {mcds} (bound "
                 f"{EVAL_MCD_TOL}), {n} transcribed, CER {cers}")
        say(f"[cbhg] evaluation chain in float32: the synthesis CLI wrote "
            f"{EVAL_LINES} lines x {EVAL_FRAMES} frames on the card and on "
            f"the CPU; evaluation.mcd card vs CPU at most {worst:.4g} dB "
            f"(bound {EVAL_MCD_TOL}); evaluation.asr with a local "
            f"recognizer echoing the metafile: {n} transcripts, CER "
            f"{max(c for _, c in cers)}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "multilingual_text_to_speech_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--loop-cpu-steps"]:
        return loop_cpu_steps()
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(int(sys.argv[2]), int(sys.argv[3]))
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

    # [train:loop]'s corpus, and its CPU steps in a process during the build
    cpu_steps = loop_setup()
    torch.set_grad_enabled(False)
    # PyTorch runs float32 matrix products in full float32 by default: the
    # plain versions and the library yardsticks rely on it
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("torch.backends.cuda.matmul.allow_tf32 is not False")
    # the plain versions' float32 convolutions in full float32 too (the
    # float32 synthesis phases restore the default around the card's run,
    # cudnn_default)
    torch.backends.cudnn.allow_tf32 = False
    say(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build()
    hp = flagship(MAX_FRAMES, CHUNK)
    sd = seeded_state_dict(hp)
    with phase("kernels"):
        errs = phase_kernels(hp, sd)
    # no CPU work of another process under the host-clock timings below
    cpu_waited = loop_wait(cpu_steps)
    with phase("main"):
        syn, launches, _ = phase_main(hp, sd, flagship(32, 16))
    with phase("time"):
        rows = phase_timings(hp, syn, errs, launches)
    del syn
    # from a checkpoint file to WAVs: from_checkpoint, synthesis, the CLI
    # and Griffin-Lim on the card
    with phase("serve:checkpoint"):
        phase_checkpoint(hp, sd)
    # float32 compute and int8 streams at the flagship's widths
    rows += phase_k1_variants(sd)
    # serving at the shared strategy's 548-wide memory (K1 against plain
    # and timed there too, also on int8 streams in bf16 and float32) and
    # the separate strategy's 288
    for name in SWITCHING:
        with labelled(name):
            hp_s = switching(name, SWITCHING_FRAMES, CHUNK)
            sd_s = seeded_state_dict(hp_s)
            if name == "shared":
                with phase("kernels"):
                    errs_s = phase_kernels(hp_s, sd_s, modes=(True,))
                    phase_shared_streams(sd_s)
            with phase("main"):
                syn_s, launches_s, _ = phase_main(hp_s, sd_s,
                                                  switching(name, 32, 16))
            if name == "shared":
                with phase("time"):
                    phase_timings(hp_s, syn_s, errs_s, launches_s)
            del syn_s
    # the forward family: K1's fwd_attention against plain (W8A8 and bf16
    # gates), synthesis through it, and its time; the card against the CPU
    # plain path at the transition agent; then its float32 and int8-stream
    # instances
    for kind, label in FAMILY.items():
        with labelled(label):
            hp_f = flagship(FAMILY_FRAMES, CHUNK, kind)
            sd_f = seeded_state_dict(hp_f)
            with phase("kernels"):
                errs_f = phase_kernels(hp_f, sd_f)
            with phase("main"):
                syn_f, launches_f, _ = phase_main(
                    hp_f, sd_f, flagship(32, 16, kind)
                    if label == "fwd_trans" else None)
            with phase("time"):
                rows += phase_timings(hp_f, syn_f, errs_f, launches_f,
                                      only=("fwd_attention",))
            del syn_f
        rows += phase_k1_variants(sd_f, kind)
    torch.set_grad_enabled(True)
    with phase("train:kernels"):
        train_errs, train_inputs = phase_train_kernels(hp, sd)
    with phase("train:main"):
        t_launches, t_per_step, step_s, main_state = phase_train_main(hp,
                                                                      sd)
    with phase("train:cpu"):
        phase_train_vs_cpu(hp, sd)
    with phase("train:eval"):
        phase_train_eval(hp, sd)
    with phase("train:time"):
        rows += phase_train_timings(hp, train_errs, t_launches, t_per_step,
                                    train_inputs, main_state)
    del main_state, train_inputs
    # training from a corpus on disk at the flagship's width: the data
    # pipeline, the Trainer's epochs, evaluation, checkpoint and resume, the
    # first steps on the card against the CPU, and GTA
    with phase("train:loop"):
        phase_train_loop(cpu_waited)
    # data parallel: the mesh of one over NCCL, then two ranks over gloo on
    # the one card, on [train:loop]'s corpus
    with phase("train:dp"):
        phase_train_dp()
    # the CBHG postnet and the cosine classifier: training, synthesis,
    # vocoding, the import CLI and the evaluation chain
    with phase("cbhg"):
        phase_cbhg(step_s)
    # training steps of both strategies (K2/K3 against plain and timed at
    # the shared strategy's 548-wide memory)
    for name in SWITCHING:
        with labelled(name), phase("train"):
            hp_s = switching(name, SWITCHING_FRAMES, CHUNK)
            sd_s = seeded_state_dict(hp_s)
            if name == "shared":
                errs_s, inputs_s = phase_train_kernels(hp_s, sd_s)
            l_s, per_s, _, main_s = phase_train_main(hp_s, sd_s, timed=2)
            phase_train_vs_cpu(hp_s, sd_s)
            if name == "shared":
                phase_train_timings(hp_s, errs_s, l_s, per_s, inputs_s,
                                    main_s)
                del inputs_s
            del main_s
    # the forward family's K2/K3 variants against plain, training steps
    # through them, and their times; the card against the CPU (a train
    # step and the eval forward) at the transition agent
    for kind, label in FAMILY.items():
        with labelled(label), phase("train"):
            hp_f = flagship(FAMILY_FRAMES, CHUNK, kind)
            sd_f = seeded_state_dict(hp_f)
            errs_f, inputs_f = phase_train_kernels(
                hp_f, sd_f, only=FAMILY_TRAIN_KERNELS)
            l_f, per_f, _, main_f = phase_train_main(
                hp_f, sd_f, timed=2 if label == "fwd_trans" else 1)
            if label == "fwd_trans":
                phase_train_vs_cpu(hp_f, sd_f)
                phase_train_eval(hp_f, sd_f)
            rows += phase_train_timings(hp_f, errs_f, l_f, per_f, inputs_f,
                                        main_f)
            del main_f, inputs_f
    rows += phase_train_f32_and_long(sd)
    # the rows by the time their launches spend past their bounds
    loss = {r["name"]: r["launches"] * (r["ms"] - r["bound_ms"])
            for r in rows}
    say("[rank] launches x (ms - bound ms), launch-ms: " + ", ".join(
        f"{name} {v:.1f}"
        for name, v in sorted(loss.items(), key=lambda kv: -kv[1])[:16]))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
