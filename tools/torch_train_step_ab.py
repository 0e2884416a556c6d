#!/usr/bin/env python3
"""Time the PyTorch port's flagship training step from two checkouts in
turns, on one NVIDIA GPU.

    python3 tools/torch_train_step_ab.py BASE CHANGE [--pairs 4]

BASE and CHANGE are roots of checkouts of the repository (for example a
``git archive`` of the parent commit unpacked under the ignored ``build/``,
and ``.``).  Each run is a fresh process that imports ``chip_smoke`` and the
port from its checkout (the kernels build on the first step) and runs
``chip_smoke.phase_train_main``: a warm-up step, three timed steps at
teacher forcing 1.0 and one at 0.5 (host clock, each ending in a
synchronize), then one step split by CUDA events into forward and loss,
backward, and clipping and Adam; then two more steps under
``torch.profiler``, whose device kernels it counts and sums (device ms and
kernel launches a step, in all and by kernel name, the mean of the two).  Runs go base, change,
change, base, and
again, ``--pairs`` pairs in all, so that a drift of the shared host's load
falls on both sides alike.  Prints every run and, last, one JSON object with
each run's numbers, also written to ``chiprun_out/train_step_ab.json``.
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
hp = cs.flagship(cs.MAX_FRAMES, cs.CHUNK)
sd = cs.seeded_state_dict(hp)
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
_SPLIT = re.compile(r"forward and loss ([\d.]+) ms, backward ([\d.]+) ms, "
                    r"clip and Adam ([\d.]+) ms")
_STEPS = re.compile(r"steps at teacher forcing 1\.0 ([\d., ]+) s \(mean")


def run_once(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=str(root))],
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
    args = ap.parse_args()
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
    runs = []
    for i, side in enumerate(order):
        print(f"[ab] run {i + 1} of {len(order)}: {side} ({roots[side]})")
        res = run_once(roots[side])
        res.update(run=i + 1, side=side)
        runs.append(res)
        print(f"[ab] run {i + 1} {side}: mean step {res['step_s']:.4f} s, "
              f"backward {res.get('backward_ms', float('nan')):.3f} ms; "
              f"device {res['device_ms']:.3f} ms and {res['kernels']:.0f} "
              f"kernel launches a step (torch.profiler)")
    summary = {"card": smi, "runs": runs}
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
    (out / "train_step_ab.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
