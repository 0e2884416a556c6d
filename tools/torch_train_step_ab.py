#!/usr/bin/env python3
"""Time the PyTorch port's flagship training step, or the serving
decoder's kernel rows, from two checkouts in turns, on one NVIDIA GPU.

    python3 tools/torch_train_step_ab.py BASE CHANGE [--pairs 4]
        [--dtype float32] [--attention forward_transition_agent]
    python3 tools/torch_train_step_ab.py BASE CHANGE --rows [--pairs 2]
        [--attention forward_transition_agent] [--set q8] [--only head ...]
    python3 tools/torch_train_step_ab.py BASE CHANGE --train-rows
        [--attention forward] [--set f32] [--only att_bwd_fwd ...]
    python3 tools/torch_train_step_ab.py BASE CHANGE --serve [--set f32]
        [--attention forward]

BASE and CHANGE are roots of checkouts of the repository (for example a
``git archive`` of the parent commit unpacked under the ignored ``build/``,
and ``.``).  Each run is a fresh process that imports ``chip_smoke`` and the
port from its checkout (the kernels build on the first step) and runs
``chip_smoke.phase_train_main`` (the flagship in its bfloat16 compute, or
with ``--dtype float32`` in float32, as ``chip_smoke.py``'s float32
training phase runs it; at ``--attention``, the flagship's widths with
another attention family): a warm-up step, three timed steps at
teacher forcing 1.0 and one at 0.5 (host clock, each ending in a
synchronize), then one step split by CUDA events into forward and loss,
backward, and clipping and Adam; then two more steps under
``torch.profiler``, whose device kernels it counts and sums (device ms and
kernel launches a step, in all and by kernel name, the mean of the two).  Runs go base, change,
change, base, and
again, ``--pairs`` pairs in all, so that a drift of the shared host's load
falls on both sides alike.  Prints every run and, last, one JSON object with
each run's numbers, also written to ``train_step_ab_<dtype>.json`` in
the ignored output directory.

With ``--rows`` each run instead builds the serving flagship's
``Synthesizer`` (at ``--attention``, with ``--set`` one of
``chip_smoke``'s configurations: ``f32``, ``f32-exact``, ``q8``,
``f32-q8``) and runs ``chip_smoke.phase_timings`` on the rows ``--only``
names (every kernel of the path when none is named): the device time of
one call of each kernel alone, as ``chip_smoke.py``'s ``[time]`` rows read
it.  With ``--train-rows`` each run checks and times the training
decoder's kernels of ``--only`` (every one when none is named) as
``chip_smoke.py``'s ``[train:time]`` rows read them, at ``--attention``
and ``--set`` (``f32``), at the depth of ``chip_smoke.py``'s training
phase there: the checks (``phase_train_kernels``), one timed step
(``phase_train_main``), then ``phase_train_timings``.  With ``--serve``
each run synthesizes as ``chip_smoke.py``'s main phases do
(``phase_main``: 240 lines x 256 frames at ``--attention`` and ``--set``,
after a warm-up run) and reads its mel frames/s (host clock).  The last
JSON object then holds each row's times (or the frames/s) by side.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json, sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
hp = cs.flagship(cs.MAX_FRAMES, cs.CHUNK, {attention!r})
sd = cs.seeded_state_dict(hp)
if {f32!r}:
    hp = cs.flagship(cs.MAX_FRAMES, cs.CHUNK, {attention!r}, **cs.F32)
_, _, step_s, (model, opt, sched, batch, state) = cs.phase_train_main(hp, sd)
from torch.profiler import ProfilerActivity, profile
from multilingual_text_to_speech_tpu_torch.training import trainer
gen = torch.Generator().manual_seed(21)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(2):
        trainer.train_step(model, opt, sched, batch, state, gen,
                           teacher=[1] * cs.TRAIN_F)
    torch.cuda.synchronize()
kernels = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
by_kernel = {{}}
for e in kernels:
    name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
    ms, n = by_kernel.get(name, (0.0, 0))
    by_kernel[name] = (ms + (e.time_range.end - e.time_range.start) / 2e3,
                       n + 0.5)
device_ms = sum(ms for ms, _ in by_kernel.values())
print("AB_RESULT " + json.dumps({{"step_s": step_s, "device_ms": device_ms,
                                  "kernels": len(kernels) / 2,
                                  "by_kernel": by_kernel}}))
"""
_ROWS = r"""
import json, sys
from collections import defaultdict
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_grad_enabled(False)
over = {{"": {{}}, "f32": cs.F32, "f32-exact": cs.F32_EXACT, "q8": cs.Q8,
         "f32-q8": cs.F32_Q8}}[{setting!r}]
hp = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, {attention!r}, **over)
syn = Synthesizer(hp, cs.seeded_state_dict(hp), device="cuda")
rows = cs.phase_timings(hp, syn, defaultdict(float), defaultdict(int),
                        only={only!r} or None, chunk=False)
print("AB_RESULT " + json.dumps({{r["name"]: r["ms"] for r in rows}}))
"""
_TRAIN_ROWS = r"""
import json, sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
over = {{"": {{}}, "f32": cs.F32}}[{setting!r}]
family = {attention!r} in cs.FAMILY
hp = cs.flagship(cs.FAMILY_FRAMES if family else cs.MAX_FRAMES, cs.CHUNK,
                 {attention!r}, **over)
# the frames of chip_smoke's training phase at this configuration
frames = cs.F32_FAMILY_FRAMES if family and over else cs.TRAIN_F
sd = cs.seeded_state_dict(hp)
errs, inputs = cs.phase_train_kernels(hp, sd, only={only!r} or None)
launches, per_step, _, main = cs.phase_train_main(hp, sd, timed=1,
                                                  frames=frames)
rows = cs.phase_train_timings(hp, errs, launches, per_step, inputs, main,
                              frames=frames)
print("AB_RESULT " + json.dumps({{r["name"]: r["ms"] for r in rows}}))
"""
_SERVE = r"""
import json, sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_grad_enabled(False)
over = {{"": {{}}, "f32": cs.F32, "f32-exact": cs.F32_EXACT, "q8": cs.Q8,
         "f32-q8": cs.F32_Q8}}[{setting!r}]
# the weights of the attention family's bf16 flagship, as chip_smoke's
# phases take them
sd = cs.seeded_state_dict(cs.flagship(cs.FAMILY_FRAMES, cs.CHUNK,
                                      {attention!r}))
hp = cs.flagship(cs.FAMILY_FRAMES, cs.CHUNK, {attention!r}, **over)
_, _, fps = cs.phase_main(hp, sd)
print("AB_RESULT " + json.dumps({{"mel_frames_s": fps}}))
"""
_SPLIT = re.compile(r"forward and loss ([\d.]+) ms, backward ([\d.]+) ms, "
                    r"clip and Adam ([\d.]+) ms")
_STEPS = re.compile(r"steps at teacher forcing 1\.0 ([\d., ]+) s \(mean")


def run_rows(root: Path, args) -> dict:
    """One ``--rows``, ``--train-rows`` or ``--serve`` run: each row's
    device ms, or the mel frames/s."""
    script = (_TRAIN_ROWS if args.train_rows else
              _SERVE if args.serve else _ROWS)
    code = script.format(
        root=str(root), attention=args.attention, setting=args.setting,
        only=list(args.only))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("AB_RESULT "):
            return json.loads(line[len("AB_RESULT "):])
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    raise SystemExit(f"train_step_ab: the run in {root} failed")


def rows_ab(roots: dict, order, args, smi: str) -> dict:
    times = {side: {} for side in roots}
    for i, side in enumerate(order):
        res = run_rows(roots[side], args)
        for name, ms in res.items():
            times[side].setdefault(name, []).append(ms)
        print(f"[ab] run {i + 1} {side}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()))
    return {"card": smi, "attention": args.attention, "set": args.setting,
            "times": times}


def run_once(root: Path, f32: bool, attention: str) -> dict:
    proc = subprocess.run([sys.executable, "-c",
                           _RUN.format(root=str(root), f32=f32,
                                       attention=attention)],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("[train:main]"):
            print(f"  {line}")
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"train_step_ab: the run in {root} failed")
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("AB_RESULT "):
            out.update(json.loads(line[len("AB_RESULT "):]))
        m = _SPLIT.search(line)
        if m:
            out["forward_ms"], out["backward_ms"], out["optimizer_ms"] = (
                float(x) for x in m.groups())
        m = _STEPS.search(line)
        if m:
            out["steps_s"] = [float(x) for x in m.group(1).split(",")]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the compute type of the step")
    ap.add_argument("--rows", action="store_true",
                    help="time the serving decoder's kernel rows instead")
    ap.add_argument("--train-rows", action="store_true",
                    help="time the training decoder's kernel rows instead")
    ap.add_argument("--serve", action="store_true",
                    help="read the serving flagship's mel frames/s instead")
    ap.add_argument("--attention", default="location_sensitive")
    ap.add_argument("--set", dest="setting", default="",
                    choices=("", "f32", "f32-exact", "q8", "f32-q8"))
    ap.add_argument("--only", nargs="*", default=())
    args = ap.parse_args()
    f32 = args.dtype == "float32"
    roots = {"base": args.base.resolve(), "change": args.change.resolve()}
    for root in roots.values():
        if not (root / "chip_smoke.py").is_file():
            raise SystemExit(f"train_step_ab: no chip_smoke.py in {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    order = (["base", "change", "change", "base"]
             * args.pairs)[:2 * args.pairs]
    if args.rows or args.train_rows or args.serve:
        print(json.dumps(rows_ab(roots, order, args, smi)))
        return 0
    runs = []
    for i, side in enumerate(order):
        print(f"[ab] run {i + 1} of {len(order)}: {side} ({roots[side]})")
        res = run_once(roots[side], f32, args.attention)
        res.update(run=i + 1, side=side)
        runs.append(res)
        print(f"[ab] run {i + 1} {side}: mean step {res['step_s']:.4f} s, "
              f"backward {res.get('backward_ms', float('nan')):.3f} ms; "
              f"device {res['device_ms']:.3f} ms and {res['kernels']:.0f} "
              f"kernel launches a step (torch.profiler)")
    summary = {"card": smi, "dtype": args.dtype,
               "attention": args.attention, "runs": runs}
    for side in roots:
        steps = [r["step_s"] for r in runs if r["side"] == side]
        summary[f"{side}_steps_s"] = steps
        summary[f"{side}_device_ms"] = [r["device_ms"] for r in runs
                                        if r["side"] == side]
        print(f"[ab] {side}: mean steps "
              + ", ".join(f"{s:.4f}" for s in steps) + " s; device ms a step "
              + ", ".join(f"{d:.3f}" for d in summary[f"{side}_device_ms"]))
    # device ms a step by kernel, each side's mean over its runs
    mean = {}
    for side in roots:
        side_runs = [r["by_kernel"] for r in runs if r["side"] == side]
        names = set().union(*side_runs)
        mean[side] = {k: sum(r.get(k, (0.0, 0))[0] for r in side_runs)
                      / len(side_runs) for k in names}
    names = sorted(set(mean["base"]) | set(mean["change"]),
                   key=lambda k: -abs(mean["change"].get(k, 0.0)
                                      - mean["base"].get(k, 0.0)))
    for k in names[:12]:
        print(f"[ab] {k}: base {mean['base'].get(k, 0.0):.3f} ms, change "
              f"{mean['change'].get(k, 0.0):.3f} ms a step")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    kind = ("" if args.attention == "location_sensitive"
            else f"_{args.attention}")
    (out / f"train_step_ab_{args.dtype}{kind}.json").write_text(
        json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
