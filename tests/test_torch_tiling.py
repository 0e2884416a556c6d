"""The pure-Python pieces around the port's split kernels, on the CPU: how
``splitk_kernel``'s K is split (``ops/_splitk.py``, shared by both
decoders) and how large the one scratch of a decoder pass or serving chunk
must be; how the prenet kernels (the forward ``prenet`` and
``train_prenet``, and ``bwd_prenet``) split each layer's columns over the
CTAs of a cluster (``prenet_split``) and exchange their bf16 rows.  The
kernels themselves run only on the card (``tests/test_torch_gpu.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu_torch.ops import _splitk
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd

# splitk_kernel's tile (csrc/tile.cuh: SK_BM, SK_BN, SK_BK) and two blocks
# per SM of an H100
_TILE, _BLOCKS = (64, 64, 32), 2 * 132


@pytest.mark.parametrize("tile,blocks", [
    (_TILE, _BLOCKS), ((32, 64, 16), 2 * 108), ((128, 128, 64), 2 * 132)])
@pytest.mark.parametrize("m,n,k", [
    (50, 2368, 4096), (50, 1600, 4096), (50, 1024, 128), (1024, 128, 25600),
    (50, 128, 1024), (50, 81, 1344), (1, 1572, 4096), (510, 2368, 4096),
    (10, 48, 16), (10, 64, 120), (7, 9, 1000), (50, 2340, 300),
    (240, 81, 1344)])
def test_splitk_slices_cover_k(m, n, k, tile, blocks):
    """S slices of kslice cover K with none empty; kslice is a whole number
    of K tiles and, when K is split, at least two long; the blocks of a
    split product stay within the target, whatever the tile and the card."""
    bm, bn, bk = tile
    s, kslice = _splitk.splitk_slices(m, n, k, tile, blocks)
    assert kslice % bk == 0 and 1 <= s <= 32
    assert (s - 1) * kslice < k <= s * kslice
    if s > 1:
        assert kslice >= 2 * bk
        assert -(-m // bm) * -(-n // bn) * s <= blocks


def test_splitk_slices_at_the_flagship_shapes():
    """B=50, H=1024, A=128, F=512 on an H100: the generator's and the
    attention's dgates @ W (K = 4H) fill the card by splitting K; the query
    h @ Wq (K = H) and the head (K = 1344) split into 64-long slices of
    their two output tiles; dq @ Wq^T (K = A) splits in two; dWq (K = F*B)
    splits too.  The serving head at B=240 (8 output tiles), which aims at
    one block per SM, splits K = 1344 into 14 slices of 96."""
    assert _splitk.splitk_slices(50, 2368, 4096, _TILE, _BLOCKS) == (7, 608)
    assert _splitk.splitk_slices(50, 1600, 4096, _TILE, _BLOCKS) == (10, 416)
    assert _splitk.splitk_slices(50, 128, 1024, _TILE, _BLOCKS) == (16, 64)
    assert _splitk.splitk_slices(50, 81, 1344, _TILE, _BLOCKS) == (21, 64)
    assert _splitk.splitk_slices(50, 1024, 128, _TILE, _BLOCKS) == (2, 64)
    assert _splitk.splitk_slices(1024, 128, 25600, _TILE, _BLOCKS) == (8, 3200)
    assert _splitk.splitk_slices(240, 81, 1344, _TILE, _BLOCKS // 2) == (
        14, 96)


# the split-K products of one flagship pass (B=50, F=512): the forward's
# query and head, the backward's five; the serving chunk's head (B=240)
_FORWARD = [(50, 128, 1024), (50, 81, 1344)]
_BACKWARD = [(50, 2368, 4096), (50, 128, 1024), (50, 1024, 128),
             (50, 1600, 4096), (1024, 128, 50 * 512)]


@pytest.mark.parametrize("products,floats", [
    (_FORWARD, 16 * 50 * 128), (_BACKWARD, 8 * 1024 * 128),
    ([(50, 64, 64), (7, 9, 32)], 0)])
def test_splitk_scratch_holds_the_partials_of_every_product(products,
                                                            floats):
    """The one scratch of a pass (or chunk) holds the [S, M, N] partials of
    each of its products in turn, and is as large as the largest of them; a
    pass whose products all leave K whole needs none."""
    need = _splitk.splitk_scratch_floats(products, _TILE, _BLOCKS)
    assert need == floats
    for m, n, k in products:
        s, _ = _splitk.splitk_slices(m, n, k, _TILE, _BLOCKS)
        assert s == 1 or s * m * n <= need


def test_splitk_scratch_of_the_serving_chunk():
    """The serving chunk's one scratch holds the head's partials at B=240,
    split for one block per SM: 14 slices of [240, 81]."""
    assert _splitk.splitk_scratch_floats(
        [(240, 81, 1344)], _TILE, _BLOCKS // 2) == 14 * 240 * 81


@pytest.mark.parametrize("in_dim,p,want", [
    (80, 256, (8, 32, 16)), (96, 256, (8, 32, 16)), (20, 24, (3, 8, 8)),
    (80, 7, (1, 8, 80)), (1, 1000, (8, 128, 8)), (27, 40, (5, 8, 8)),
    (80, 8, (1, 8, 80))])
def test_bwd_prenet_split_at_known_widths(in_dim, p, want):
    """The flagship's prenet (M=80, P=256) runs 8 CTAs of 32 columns of P
    and 16 of the frame's 80 (the last three own none); a P of one
    8-column tile runs one CTA.  The forward prenet kernels take the same
    split of P (``prenet_split`` is the one helper of all three)."""
    assert fd.prenet_split(in_dim, p) == want
    assert ftd.prenet_split is fd.prenet_split


def test_wide_prenet_split_covers_every_width():
    """The forward prenets' wide split (non-portable clusters): whole
    8-column tiles, at most 16 CTAs, every column of P owned, none empty;
    16 CTAs of 16 columns at the flagship's P = 256.  Only float32
    launches of at most 64 rows take it (``prenet_wide``)."""
    for p in range(1, 300):
        cl, cols_p, _ = fd.prenet_split(80, p, wide=True)
        assert 1 <= cl <= 16 and cols_p % 8 == 0
        assert (cl - 1) * cols_p < p <= cl * cols_p
    assert fd.prenet_split(80, 256, wide=True)[:2] == (16, 16)
    assert [fd.prenet_wide(d, b) for d, b in (
        (torch.float32, 1), (torch.float32, 64), (torch.float32, 65),
        (torch.bfloat16, 50))] == [True, True, False, False]


def test_bwd_prenet_split_covers_every_width():
    """Whole 8-column tiles, at most 8 CTAs, every column of P and of the
    input frame owned, and no CTA of P's columns empty."""
    for p in range(1, 300):
        for in_dim in (1, 7, 80, 96, 257):
            cl, cols_p, cols_in = fd.prenet_split(in_dim, p)
            assert 1 <= cl <= 8 and cols_p % 8 == 0 and cols_in % 8 == 0
            assert (cl - 1) * cols_p < p <= cl * cols_p
            assert in_dim <= cl * cols_in
    with pytest.raises(ValueError):
        fd.prenet_split(0, 8)


def _split_bwd_prenet(dx, outs, ops, cfg):
    """``bwd_prenet`` as its kernel splits it: each CTA masks its own
    columns of da, the CTAs exchange their bf16 slices (the full rows are
    the slices in rank order), and each computes its columns of dx =
    bf16(da) @ W^T from its rows of W.  -> (da per layer, d input frame)."""
    p, m = cfg.prenet_dim, cfg.mmel
    cl, cols_p, cols_in = fd.prenet_split(m, p)
    scale = 1.0 / (1.0 - cfg.dropout_rate)
    layers = ftd.prenet_layers(ops, cfg)
    own = [slice(r * cols_p, min(p, (r + 1) * cols_p)) for r in range(cl)]

    def mask(layer, r, x):
        out = outs[layer][:, own[r]].float()
        return torch.where(out > 0.0, x * scale, torch.zeros_like(x))

    slices = [mask(cfg.n_prenet - 1, r, dx[:, own[r]]) for r in range(cl)]
    das = [None] * cfg.n_prenet
    for layer in range(cfg.n_prenet - 1, -1, -1):
        da = torch.cat(slices, 1)
        das[layer] = da
        w = layers[layer][0]
        n = cols_in if layer == 0 else cols_p
        cols = [w[r * n:(r + 1) * n] for r in range(cl)]
        dx_cols = [ftd._mm(da, c.t()) for c in cols]
        if layer > 0:
            slices = [mask(layer - 1, r, x) for r, x in enumerate(dx_cols)]
    return das, torch.cat(dx_cols, 1)


@pytest.mark.parametrize("in_dim", [80, 96])
@pytest.mark.parametrize("n_prenet", [1, 2, 3])
def test_bwd_prenet_split_is_the_plain_backward(n_prenet, in_dim):
    """The column split and exchange of ``bwd_prenet`` at P=256 (8 CTAs)
    equals ``bwd_prenet_plain``: each layer's da and the input frame's
    gradient within float32 sum order (rtol 1e-6), on bf16 weights and
    post-dropout outputs with zeros from the ReLU and the dropout."""
    p = 256
    cfg = ftd.TrainConfig(hidden=16, mem_dim=8, prenet_dim=p,
                          n_prenet=n_prenet, mmel=in_dim, att_dim=16, taps=3,
                          dropout_rate=0.5, zoneout_h=0.1, zoneout_c=0.1,
                          use_zoneout=True, dtype=torch.bfloat16)
    rng = np.random.RandomState(10 * n_prenet + in_dim)
    n_w = in_dim * p + (n_prenet - 1) * p * p
    ops = {"pre_w": torch.as_tensor(rng.randn(n_w) / 16.0,
                                    dtype=torch.float32).bfloat16(),
           "pre_b": torch.zeros(n_prenet * p)}
    b = 50
    outs = [torch.as_tensor(np.maximum(rng.randn(b, p), 0.0)
                            * (rng.uniform(size=(b, p)) < 0.5),
                            dtype=torch.float32).bfloat16()
            for _ in range(n_prenet)]
    dx = torch.as_tensor(rng.randn(b, p), dtype=torch.float32)
    das, dx_in = _split_bwd_prenet(dx, outs, ops, cfg)
    ref_das, ref_in = ftd.bwd_prenet_plain(dx, outs, ops, cfg)
    for g, r in zip(das, ref_das):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(dx_in[:, :in_dim], ref_in, rtol=1e-6,
                               atol=1e-6)
    assert dx_in.shape[1] >= in_dim


def _split_prenet(x, layers, rate, seeds, salt0, wide=False):
    """The forward prenet as its kernel splits it: the rows in 16-row tiles
    (the last one ragged, its pad rows zero), each CTA of a tile's cluster
    computing its own columns of a layer, relu(bf16(x) @ W[:, cols] + b),
    with the dropout mask drawn at the global columns; the CTAs exchange
    their bf16 slices (the full rows are the slices in rank order) as the
    next layer's input.  -> (each layer's float32 output, each layer's keep
    mask), the pad rows dropped."""
    b, in_dim = x.shape
    p = layers[0][0].shape[1]
    cl, cols_p, _ = fd.prenet_split(in_dim, p, wide)
    own = [slice(r * cols_p, min(p, (r + 1) * cols_p)) for r in range(cl)]
    rows = -(-b // 16) * 16
    a = torch.zeros(rows, in_dim)
    a[:b] = x.float()
    outs, keeps = [], []
    for i, (w, bias) in enumerate(layers):
        bits = fd.rand_bits((rows, p), seeds[0], seeds[1], salt0 + i)
        keep = bits < fd.keep_threshold(rate)
        slices, kept = [], []
        for r in range(cl):
            y = torch.relu(fd._mm(a, w[:, own[r]]) + bias[own[r]])
            y = torch.where(keep[:, own[r]], y * (1.0 / (1.0 - rate)),
                            torch.zeros_like(y))
            slices.append(y)
            kept.append(keep[:, own[r]])
        y = torch.cat(slices, 1)
        outs.append(y[:b])
        keeps.append(torch.cat(kept, 1)[:b])
        a = y.bfloat16().float()   # the exchange of the bf16 rows
    return outs, keeps


def _prenet_weights(in_dim, p, n_prenet, seed):
    rng = np.random.RandomState(seed)
    n_w = in_dim * p + (n_prenet - 1) * p * p
    return (torch.as_tensor(rng.randn(n_w) / 8.0,
                            dtype=torch.float32).bfloat16(),
            torch.as_tensor(0.1 * rng.randn(n_prenet * p),
                            dtype=torch.float32))


_PRENET_WIDTHS = [(80, 256), (80, 40), (27, 24)]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("in_dim,p", _PRENET_WIDTHS)
@pytest.mark.parametrize("n_prenet", [1, 2, 3])
def test_prenet_split_is_the_plain_serving_prenet(n_prenet, in_dim, p,
                                                  wide):
    """The column split and bf16 exchange of the forward prenet kernel, at
    B=50 (a ragged last 16-row tile), dropout 0.5, step 3, in clusters of
    up to 8 CTAs and up to 16 (``wide``), equals
    ``fused_decoder.prenet_plain``: the keep masks exactly, the float32
    output within float32 sum order (rtol 1e-6)."""
    w, bias = _prenet_weights(in_dim, p, n_prenet, 7 * n_prenet + p)
    bundle = SimpleNamespace(pre_w=w, pre_b=bias,
                             pre_dims=(in_dim, p, n_prenet))
    bundle.prenet_layers = lambda: fd.DecoderBundle.prenet_layers(bundle)
    b, step, seeds = 50, 3, (123456789, 987654321)
    frame = torch.as_tensor(np.random.RandomState(p).randn(b, in_dim),
                            dtype=torch.float32)
    outs, keeps = _split_prenet(frame, bundle.prenet_layers(), 0.5, seeds,
                                step * n_prenet + 1, wide)
    keep_p = torch.zeros(n_prenet, b, p, dtype=torch.uint8)
    ref = fd.prenet_plain(frame, bundle, 0.5, seeds, step, keep_out=keep_p)
    assert torch.equal(torch.stack(keeps).to(torch.uint8), keep_p)
    assert bool((keep_p == 0).any() and (keep_p == 1).any())
    torch.testing.assert_close(outs[-1], ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_dim,p", _PRENET_WIDTHS)
@pytest.mark.parametrize("n_prenet", [1, 2, 3])
def test_prenet_split_is_the_plain_train_prenet(n_prenet, in_dim, p):
    """The same split against ``train_prenet``'s plain route (the CPU path
    of ``fused_train_decoder.train_prenet``) at both teacher flags, with
    the raw and per-layer streams and without them (the eval forward): the
    raw frame and every bf16 output equal; the masks (zero weights and
    positive biases, so that every zero is a dropped unit) exactly those of
    the plain version."""
    w, bias = _prenet_weights(in_dim, p, n_prenet, 3 * n_prenet + p)
    cfg = ftd.TrainConfig(hidden=16, mem_dim=8, prenet_dim=p,
                          n_prenet=n_prenet, mmel=in_dim, att_dim=16, taps=3,
                          dropout_rate=0.5, zoneout_h=0.1, zoneout_c=0.1,
                          use_zoneout=True, dtype=torch.bfloat16)
    b, gs, seeds = 50, 11, (2654435761, 40503)
    rng = np.random.RandomState(in_dim)
    shifted = torch.as_tensor(rng.randn(b, in_dim),
                              dtype=torch.float32).bfloat16()
    frame = torch.as_tensor(rng.randn(b, in_dim), dtype=torch.float32)
    for masks in (False, True):
        ops = ({"pre_w": torch.zeros_like(w), "pre_b": bias.abs() + 1.0}
               if masks else {"pre_w": w, "pre_b": bias})
        layers = ftd.prenet_layers(ops, cfg)
        for teacher in (0, 1):
            x = shifted if teacher else frame
            outs, keeps = _split_prenet(x, layers, 0.5, seeds,
                                        cfg.prenet_salt(gs))
            for streams in (True, False):
                raw = torch.zeros(b, in_dim, dtype=torch.bfloat16)
                pre = torch.zeros(n_prenet, b, p, dtype=torch.bfloat16)
                dst = torch.zeros(b, p, dtype=torch.bfloat16)
                ftd.train_prenet(shifted, frame, teacher, ops, cfg, seeds,
                                 gs, raw if streams else None,
                                 pre if streams else None, dst)
                assert torch.equal(dst, outs[-1].bfloat16())
                if streams:
                    assert torch.equal(raw, x.bfloat16())
                    for got, want in zip(pre, outs):
                        assert torch.equal(got, want.bfloat16())
                if masks:
                    assert torch.equal(dst == 0, ~keeps[-1])
                    if streams:
                        for got, keep in zip(pre, keeps):
                            assert torch.equal(got == 0, ~keep)
