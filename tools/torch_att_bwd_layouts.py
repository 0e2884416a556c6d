"""K3's ``att_bwd`` in its two shared-memory layouts, timed in turns on the
card: the single tile (every per-position row in shared memory) against
the sub-tiled layout of long texts (``ops/fused_train_decoder.py::
att_bwd_plan(..., sub_tiled=True)``: the location-sensitive passes in
sub-tiles of 64 positions, the forward family's tanh terms recomputed from
mtb), at lengths where both fit, each attention kind and compute type, at
the flagship's widths (A = 128, Mem = 292, H = 1024, P = 256) on random
inputs.  Each reading is ``chip_smoke.device_ms`` of the port's kernel
alone, in the order single, sub, sub, single; one JSON line per case.

    python3 tools/torch_att_bwd_layouts.py [--b 8] [--t 2304 4096]

A length at which a case's single tile does not fit is skipped.  Needs the
card (the kernels build at first use).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--t", type=int, nargs="+", default=[2304, 4096])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    if not torch.cuda.is_available():
        raise SystemExit("torch_att_bwd_layouts: no CUDA device")
    torch.set_grad_enabled(False)
    b, a, mem, h, p, k = args.b, 128, 292, 1024, 256, 31
    card = cs.card_label()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    for t in args.t:
        mask_add = torch.zeros(b, t, device="cuda")
        for kind in ("ls", "fwd", "fwd_trans"):
            family = kind != "ls"
            for ct in (torch.bfloat16, torch.float32):
                if ftd.att_bwd_plan(t, a, mem, family, ct).sub:
                    continue
                fam = None
                if kind == "fwd":
                    fam = ftd.FamilyBwd(mask_add)
                elif kind == "fwd_trans":
                    fam = ftd.FamilyBwd(
                        mask_add, torch.rand(b, device="cuda", generator=gen),
                        torch.rand(b, device="cuda", generator=gen), rnd(b),
                        torch.empty(b, device="cuda"),
                        rnd(mem + h + p, scale=0.03), rnd(b, h),
                        torch.empty(b, p, device="cuda"))
                cum = (torch.softmax(rnd(b, t), -1) if family
                       else rnd(b, t).abs())
                call = (rnd(b, a).to(ct).float(), cum.to(ct),
                        torch.softmax(rnd(b, t), -1), rnd(b, t, mem).to(ct),
                        rnd(b, t, a, scale=0.5).to(ct),
                        None if family else rnd(k, a, scale=0.1).to(ct),
                        rnd(a, scale=a ** -0.5), rnd(b, mem),
                        rnd(b, t, scale=0.1), rnd(b, t, scale=0.1),
                        torch.zeros(b, t, a, device="cuda"),
                        None if family else torch.zeros(b, k, a,
                                                        device="cuda"),
                        torch.zeros(b, a, device="cuda"),
                        torch.empty(b, a, dtype=ct, device="cuda"),
                        torch.empty(b, mem, dtype=ct, device="cuda"))
                ms = {False: [], True: []}
                for sub in (False, True, True, False):
                    ms[sub].append(cs.device_ms(
                        lambda: ftd.att_bwd(*call, fam=fam, sub_tiled=sub),
                        ours_only=True))
                plan = ftd.att_bwd_plan(t, a, mem, family, ct,
                                        sub_tiled=True)
                print(json.dumps({
                    "kind": kind, "dtype": cs.dtype_label(ct), "b": b,
                    "t": t, "tile": plan.tile, "sub": plan.sub,
                    "single_ms": ms[False], "sub_ms": ms[True],
                    "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
