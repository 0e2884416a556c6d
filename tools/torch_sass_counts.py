#!/usr/bin/env python3
"""Count instructions of the PyTorch port's kernels in the compiled SASS, for
one or more checkouts, on a machine with the CUDA toolkit.

    python3 tools/torch_sass_counts.py [ROOT ...] [--kernel att_bwd_kernel
        --kernel bwd_head_kernel --kernel train_attention_kernel
        --kernel bwd_prenet_kernel --kernel prenet_tile_kernel
        --kernel att_bwd_family_kernel --kernel lsa_attention_kernel]
        [--op HMMA.1688.F32.TF32 --op FFMA --op CGABAR_ARV ...]

Each ROOT (the checkout itself when none is given) builds both decoders'
sources (``csrc/fused_decoder.cu``, ``csrc/fused_train_decoder.cu``) as
the port does (``ops/_build.py``, into that checkout's ignored
``build/kernels/``), runs ``cuobjdump -sass`` and ``-res-usage`` on each
library and prints, for each kernel instance whose mangled name holds one
of ``--kernel``, how many SASS lines hold each ``--op`` (a static count:
a loop's body counts once) and its registers a thread (``REG``) and bytes
of local memory (``LOCAL``: spills).  The last line is one JSON object of
the counts by root and instance.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

_SOURCES = ("fused_decoder", "fused_train_decoder")
_BUILD = ("import sys; sys.path.insert(0, {root!r}); "
          "from multilingual_text_to_speech_tpu_torch.ops import _build; "
          "print(*(_build._target(s) for s in {sources!r}), sep='\\n'); "
          "_build.build({sources!r})")
_CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def libraries(root: Path) -> list:
    """The built libraries of both decoders' kernels in ``root``."""
    out = subprocess.run([sys.executable, "-c",
                          _BUILD.format(root=str(root), sources=_SOURCES)],
                         cwd=root, capture_output=True, text=True, check=True)
    return [Path(x) for x in out.stdout.splitlines()[:len(_SOURCES)]]


def counts(so: Path, kernels, ops) -> dict:
    sass = subprocess.run([_CUOBJDUMP, "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in kernels) else None
            if fn:
                found[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                found[fn][op] += op in line
    # registers a thread and local-memory bytes, from the resource usage
    usage = subprocess.run([_CUOBJDUMP, "-res-usage", str(so)],
                           capture_output=True, text=True, check=True).stdout
    fn = None
    for line in usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1) if m.group(1) in found else None
        elif fn:
            for key in ("REG", "LOCAL"):
                r = re.search(key + r":(\d+)", line)
                if r:
                    found[fn][key] = int(r.group(1))
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path, default=[Path(".")])
    ap.add_argument("--kernel", action="append",
                    default=None, help="a piece of the mangled name")
    ap.add_argument("--op", action="append", default=None)
    args = ap.parse_args()
    kernels = args.kernel or ["att_bwd_kernel", "bwd_head_kernel",
                              "train_attention_kernel", "bwd_prenet_kernel",
                              "prenet_tile_kernel", "att_bwd_family_kernel",
                              "lsa_attention_kernel"]
    ops = args.op or ["HMMA.1688.F32.TF32", "HMMA.16816", "FFMA", "LDSM",
                      "LDGSTS", "CGABAR_ARV", "CGABAR_WAIT"]
    result = {}
    for root in args.roots:
        res = {}
        for so in libraries(root.resolve()):
            res.update(counts(so, kernels, ops))
        result[str(root)] = res
        for fn, c in res.items():
            print(f"[sass] {root} {fn}: " + ", ".join(
                f"{op} {n}" for op, n in c.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
