#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s checks, or time one kernel, on changed copies of
the PyTorch port's CUDA sources, on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py faults
    python3 tools/torch_kernel_variants.py time lsa_l2_prefetch att_bwd_l2_prefetch

Each variant copies ``multilingual_text_to_speech_tpu_torch`` under the
ignored ``build/variants/<name>/``, replaces one piece of a ``csrc`` source
there (the piece must occur exactly once), and runs in a fresh process that
imports the copy before the checkout's own package, so the kernels build
from the changed source into the copy's own build directory.

``faults`` plants one wrong location-conv tap at a time (K1's
``lsa_attention``; K3's ``att_bwd``, in its cum gradient and in its filter
gradient) and runs the checks of that kernel's ``chip_smoke`` phase
(``phase_kernels`` for K1, ``phase_train_kernels`` for K3) with
``chip_smoke.fail`` recording each failed check instead of stopping, so
every check's reading prints.  The run fails unless every fault fails at
least one check.

``time`` times each named variant's kernel and the checkout's own in turns
(as is, variant, variant, as is): ``lsa_attention`` at the serving path's
B=240, T=128, W8A8, alone (``chip_smoke.device_ms``) and a step inside a
32-step chunk (``torch.profiler``); ``att_bwd`` at the training path's
B=50, T=128 on random inputs of the flagship's widths, alone.

Prints every run and, last, one JSON object of the results, also written
to ``build/variants/kernel_variants_<mode>.json``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "multilingual_text_to_speech_tpu_torch"

# name: (source, piece, replacement, what to run)
VARIANTS = {
    "lsa_location_tap": (
        "fused_decoder.cu",
        "cum + (size_t)b * T, 0, half, T);",
        "cum + (size_t)b * T, 0, half + 1, T);", "K1"),
    "att_bwd_dcum_tap": (
        "fused_train_decoder.cu",
        "const int t2 = t - lane + half;",
        "const int t2 = t - lane + half + 1;", "K3"),
    "att_bwd_dlc_tap": (
        "fused_train_decoder.cu",
        "band_dlc(acc[kh], s_cum + mt * 16 + kh * 16,",
        "band_dlc(acc[kh], s_cum + mt * 16 + kh * 16 + 1,", "K3"),
    # a hint to L2 at the start, one prefetch per 128-byte line, of the
    # bytes the kernel reads later (lsa_attention: the row's memory and
    # memory transform; att_bwd: its tile's memory transform and dmt)
    "lsa_l2_prefetch": (
        "fused_decoder.cu",
        "  const int k_lo = rank * L.kq, a_chunks = A / 8;\n",
        "  if (live) {\n"
        "    for (size_t off = tid * 128; off < (size_t)T * M * 2; off += "
        "LSA_THREADS * 128)\n"
        "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)mem_b + off));\n"
        "    for (size_t off = tid * 128; off < (size_t)T * A * 2; off += "
        "LSA_THREADS * 128)\n"
        "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)mtb_b + off));\n"
        "  }\n"
        "  const int k_lo = rank * L.kq, a_chunks = A / 8;\n", "time K1"),
    "att_bwd_l2_prefetch": (
        "fused_train_decoder.cu",
        "  for (int a = tid; a < A; a += AB_THREADS) {\n",
        "  for (size_t off = tid * 128; off < (size_t)min(tile, T - t_lo) * A"
        " * 2; off += AB_THREADS * 128)\n"
        "    asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)(mtb + (rowT + t_lo) * A) + off));\n"
        "  for (size_t off = tid * 128; off < (size_t)min(tile, T - t_lo) * A"
        " * 4; off += AB_THREADS * 128)\n"
        "    asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)(dmt + (rowT + t_lo) * A) + off));\n"
        "  for (int a = tid; a < A; a += AB_THREADS) {\n", "time K3"),
}

_PRELUDE = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
hp = cs.flagship(cs.MAX_FRAMES, cs.CHUNK)
sd = cs.seeded_state_dict(hp)
"""

_CHECKS = _PRELUDE + r"""
failed = []
def record(msg):
    failed.append(msg)
    print("[variant] check failed: " + msg)
cs.fail = record
if {phase!r} == "K1":
    torch.set_grad_enabled(False)
    cs.phase_kernels(hp, sd)
else:
    cs.phase_train_kernels(hp, sd)
print("VARIANT_RESULT " + json.dumps({{"failed": failed}}))
"""

_TIME_K1 = _PRELUDE + r"""
from torch.profiler import ProfilerActivity, profile
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
torch.set_grad_enabled(False)
syn = Synthesizer(hp, sd, device="cuda")
bundle, kw = syn.bundle, syn.decode_kwargs
memory, mt, mask, carry = cs.encoded_batch(syn, hp)
mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
alone = cs.device_ms(lambda: fd.lsa_attention(
    carry["h_att"], carry["att_state"]["weights"], mem, mtb, mask_add,
    bundle), ours_only=True)
steps = 32
def chunk():
    fd.decode_chunk(bundle, carry, memory, mt, mask, (1, 2), steps, **kw)
chunk()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    chunk()
    torch.cuda.synchronize()
busy = cs.device_busy(p)
in_chunk = None
if busy is not None:
    in_chunk = sum(v for k, v in busy[2].items()
                   if k.startswith("lsa_attention_kernel")) / steps
print("VARIANT_RESULT " + json.dumps({{"alone_ms": alone,
                                      "in_chunk_us": in_chunk}}))
"""

# att_bwd at B=50, T=128 and the flagship's widths (A=128, Mem=292, 31
# taps) on random inputs, the accumulators and dcum updated in place
_TIME_K3 = _PRELUDE + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
b, t, a, mem, k = cs.TRAIN_B, cs.TRAIN_T, 128, 292, 31
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
bf = torch.bfloat16
args = (rnd(b, a).to(bf).float(), rnd(b, t).abs().to(bf),
        torch.softmax(rnd(b, t), -1), rnd(b, t, mem).to(bf),
        rnd(b, t, a, scale=0.5).to(bf), rnd(k, a, scale=0.1).to(bf),
        rnd(a, scale=a ** -0.5), rnd(b, mem), rnd(b, t, scale=0.1),
        rnd(b, t, scale=0.1), torch.zeros(b, t, a, device="cuda"),
        torch.zeros(b, k, a, device="cuda"), torch.zeros(b, a, device="cuda"),
        torch.empty(b, a, dtype=bf, device="cuda"),
        torch.empty(b, mem, dtype=bf, device="cuda"))
alone = cs.device_ms(lambda: ftd.att_bwd(*args), ours_only=True)
print("VARIANT_RESULT " + json.dumps({{"alone_ms": alone}}))
"""


def make_copy(name: str) -> Path:
    """The package under build/variants/<name>/ with the variant's piece
    replaced; its own build directory starts empty."""
    source, piece, repl, _ = VARIANTS[name]
    root = ROOT / "build" / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / PKG / "csrc" / source
    text = path.read_text()
    if text.count(piece) != 1:
        raise SystemExit(f"kernel_variants: {name}: the piece to replace "
                         f"occurs {text.count(piece)} times in {source}")
    path.write_text(text.replace(piece, repl))
    return root


def run(root: Path, script: str, **fmt) -> dict:
    code = script.format(repo=str(ROOT), root=str(root), **fmt)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith(("[variant]", "[kernels", "[train:kernels]")):
            print(f"  {line}")
    for line in proc.stdout.splitlines():
        if line.startswith("VARIANT_RESULT "):
            return json.loads(line[len("VARIANT_RESULT "):])
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    raise SystemExit(f"kernel_variants: the run in {root} failed")


def faults() -> dict:
    out, caught = {}, True
    for name, (_, _, _, phase) in VARIANTS.items():
        if phase.startswith("time"):
            continue
        print(f"[faults] {name} ({phase})")
        res = run(make_copy(name), _CHECKS, phase=phase)
        out[name] = res["failed"]
        caught = caught and bool(res["failed"])
        print(f"[faults] {name}: {len(res['failed'])} check(s) failed")
    if not caught:
        raise SystemExit("kernel_variants: a planted fault passed every "
                         "check: " + json.dumps(out))
    return out


def time_variants(names) -> dict:
    out = {}
    for name in names:
        if not VARIANTS.get(name, "---")[3].startswith("time"):
            raise SystemExit(f"kernel_variants: {name} is not a timing "
                             "variant")
        script = _TIME_K1 if VARIANTS[name][3] == "time K1" else _TIME_K3
        roots = {"as is": ROOT, name: make_copy(name)}
        out[name] = {k: [] for k in roots}
        for which in ("as is", name, name, "as is"):
            res = run(roots[which], script)
            out[name][which].append(res)
            print(f"[time] {which}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in res.items() if v is not None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("faults", "time"))
    ap.add_argument("names", nargs="*", help="the variants to time: " +
                    ", ".join(k for k, v in VARIANTS.items()
                              if v[3].startswith("time")))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown"
    print(f"[variants] {card}")
    result = {"card": card, args.what: (
        faults() if args.what == "faults" else time_variants(args.names))}
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"kernel_variants_{args.what}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
