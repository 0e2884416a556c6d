"""K3's ``att_bwd`` planner (``ops/fused_train_decoder.py::att_bwd_plan``)
on the CPU: for every text length from 1 to 8,192 symbols, each attention
kind and compute type, at the flagship's attention width and at the memory
widths of the generated (292) and shared (548) encoders, the plan covers
the row with no empty CTA, fits a CTA's 227 KiB of shared memory, and keeps
the single tile's layout exactly where that layout fit before the
sub-tiled one existed.  The layout of that earlier kernel is transcribed
below (``_single_tile_bytes``), apart from the module's mirror, so that a
change to the mirror's single-tile count shows here.  The GPU tests hold
the mirror to the count the built kernel exports."""

import pytest
import torch

from multilingual_text_to_speech_tpu_torch.ops import (
    fused_train_decoder as ftd,
)

A = 128                              # the flagship's attention width
T_MAX = 8192
KINDS = ("location_sensitive", "forward", "forward_transition_agent")
SMEM = 227 * 1024                    # a CTA's shared memory on the H100


def _a16(n):
    return (n + 15) // 16 * 16


def _single_tile_bytes(tile, a, mem, family, es):
    """``AbLayout(tile, A, Mem, family, es).total`` of the kernel that had
    only the single tile's layout: every per-position row in shared
    memory, float32 band operands aliased (dlc's partial over lc, w over
    P)."""
    band_k, threads = 32, 256
    tf32 = es == 4 and not family
    ld = a if tf32 else a + 8
    lc = 0
    dz = lc + (0 if family else _a16((2 if tf32 else 1) * band_k * ld * es))
    p = dz + (0 if family else _a16(tile * ld * es))
    dlcp = lc if tf32 else p + (0 if family else _a16(tile * band_k * 4))
    q = (p + _a16(tile * band_k * 4) if tf32
         else dlcp + (0 if family else _a16(band_k * a * 4)))
    dqp = q + 3 * _a16(a * 4)
    w = p if tf32 else dqp + _a16(a * 4)
    de = dqp + _a16(a * 4) if tf32 else w + _a16(tile * 4)
    cum = de + _a16(tile * 4) + _a16(mem * 4)
    cum_lo = cum + (0 if family else _a16((tile + band_k) * es))
    red = cum_lo + (_a16((tile + band_k) * 4) if tf32 else 0)
    tz = red + 32 * 4 + 32 + (_a16(5 * tile * 4) if family else 0)
    gp = _a16(max(a, 2 * threads) * 4) if family else 0
    gdv = tz + (_a16(tile * a * es) if family else 0)
    return gdv + 2 * gp


def _bytes(plan, mem, family, es):
    return ftd.att_bwd_smem_bytes(plan.tile, A, mem, family, es, plan.sub)


@pytest.mark.parametrize("mem", [292, 548])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_covers_fits_and_keeps_the_single_tile(kind, dtype, mem):
    family, es = kind != "location_sensitive", dtype.itemsize
    assert ftd.SMEM_MAX == SMEM
    single = []
    for t in range(1, T_MAX + 1):
        plan = ftd.att_bwd_plan(t, A, mem, family, dtype)
        tile, cl, sub = plan
        assert (tile, cl) == ftd.att_bwd_tiles(t)
        # whole mma tiles, at most a portable cluster, T covered, no CTA
        # empty
        assert tile % 16 == 0 and 1 <= cl <= 8, (t, plan)
        assert cl * tile >= t > (cl - 1) * tile, (t, plan)
        assert _bytes(plan, mem, family, es) <= SMEM, (t, plan)
        fits_before = _single_tile_bytes(tile, A, mem, family, es) <= SMEM
        assert (sub == 0) == fits_before, (t, plan)
        if sub:
            assert sub % 16 == 0 and sub == min(64, tile), (t, plan)
        else:
            single.append(t)
    # the training shapes run as before; past the single tile's limit
    # every length runs sub-tiled
    assert 128 in single and 2304 in single
    assert single == list(range(1, single[-1] + 1))
    assert single[-1] < T_MAX


@pytest.mark.parametrize("mem", [292, 548])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_forced_sub_tiled_plan_fits_every_length(kind, dtype, mem):
    family, es = kind != "location_sensitive", dtype.itemsize
    for t in range(1, T_MAX + 1):
        plan = ftd.att_bwd_plan(t, A, mem, family, dtype, sub_tiled=True)
        assert (plan.tile, plan.cluster) == ftd.att_bwd_tiles(t)
        assert plan.sub == min(64, plan.tile), (t, plan)
        assert _bytes(plan, mem, family, es) <= SMEM, (t, plan)


@pytest.mark.parametrize("family", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mirror_keeps_the_single_tile_layout(family, dtype):
    """The mirror's single-tile count (sub 0) is the earlier kernel's, at
    every tile that a T up to 8,192 gives and attention widths of 128 and
    256;
    the sub-tiled one is smaller wherever the tile holds two sub-tiles or
    more (below that the float32 band layout's aliased rows save more)."""
    es = dtype.itemsize
    for tile in range(16, T_MAX // 8 + 1, 16):
        for a in (128, 256):
            for mem in (288, 292, 548):
                whole = ftd.att_bwd_smem_bytes(tile, a, mem, family, es)
                assert whole == _single_tile_bytes(tile, a, mem, family, es)
                if tile >= 128:
                    assert ftd.att_bwd_smem_bytes(
                        tile, a, mem, family, es, 64) < whole


@pytest.mark.parametrize("kind", KINDS)
def test_plan_raises_past_the_sub_tiled_layout_with_the_limit(kind):
    family = kind != "location_sensitive"
    with pytest.raises(ValueError, match=f"T=200000.*{SMEM}"):
        ftd.att_bwd_plan(200_000, A, 292, family, torch.float32)
    with pytest.raises(ValueError, match="T >= 1"):
        ftd.att_bwd_plan(0, A, 292, family, torch.bfloat16)


@pytest.mark.parametrize("kind,dtype,longest", [
    ("location_sensitive", torch.bfloat16, 101_120),
    ("location_sensitive", torch.float32, 54_912),
    ("forward", torch.bfloat16, 63_872),
    ("forward_transition_agent", torch.float32, 63_872),
])
def test_longest_text_the_sub_tiled_layout_takes(kind, dtype, longest):
    """The longest T whose sub-tiled layout fits a CTA at A = 128 and the
    shared strategy's 548-wide memory: past it the plan raises (the
    figures PERF.md quotes)."""
    family = kind != "location_sensitive"
    ftd.att_bwd_plan(longest, A, 548, family, dtype)
    with pytest.raises(ValueError, match=str(SMEM)):
        ftd.att_bwd_plan(longest + 1, A, 548, family, dtype)
