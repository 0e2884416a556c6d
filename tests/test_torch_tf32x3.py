"""Why the port's float32 products run three TF32 passes, on the CPU.

Both decoders' float32 instances compute their gate and split-K products,
K3's head backward and K3's attention-backward band products on the tensor
cores as three TF32 passes (``csrc/tile.cuh``: ``tf32_split``,
``mma_tf32x3``): each float32 operand x is split into hi = tf32(x) and lo =
tf32(x - hi), rounded to nearest with ties away from zero (``cvt.rna``),
and each 8-deep K step of ``mma.sync.m16n8k8`` adds a_lo b_hi, a_hi b_lo
and a_hi b_hi, small terms first, into a float32 accumulator.  This file
emulates that arithmetic in torch at the flagship's shapes (B=50 rows
against the gate weights, K = 1572 and 2340 against 4H = 4096, and the
backward's K = 4H = 4096 against 2340; the head backward's K = 80 mels
against H + Mem = 1316; the band products at A = 128 and 31 taps in
BAND_K = 32 over tiles of 16 and 192 positions: loc = band(cum) @ lc, dlc
= band(cum)^T @ dz, P = dz @ lc^T) and holds it against a float64 product:
three passes land within 1e-5 of the largest output (the bound of
``chip_smoke.py``'s float32 checks), one pass does not.  TF32 rounding is
done on the bits: add half of the 13 dropped mantissa bits, then mask them.

It also holds the float32 band routine's operand maps as
``csrc/tile.cuh`` writes them: the m16n8k8 TF32 A fragment of the Hankel
band read from the staged cum row (``band_frag_tf32``), for loc's band and
dlc's transposed band, and the swizzle of the float32 operand tiles
(``band_swz``): a permutation of 16-byte chunks whose fragment reads fall
in distinct shared-memory banks.
"""

import numpy as np
import pytest
import torch

# chip_smoke.py's F32_TOL: every float32 output within this share of its
# largest value
F32_TOL = 1e-5
# the flagship's products: (K, N) at B=50 rows
_SHAPES = [(1572, 4096), (2340, 4096), (4096, 2340)]
_ROWS = 50


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: the 13 low bits of the
    magnitude rounded away on the bit pattern (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """hi = tf32(x), lo = tf32(x - hi); x - hi is exact in float32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_product(a: torch.Tensor, w: torch.Tensor, passes: int
                 ) -> torch.Tensor:
    """a [M, K] @ w [N, K]^T as the kernels run it: for each 8-deep K step,
    the passes' products summed in float32 (exact: 11-bit by 11-bit
    significands) and added to a float32 accumulator, a_lo w_hi, a_hi w_lo,
    then a_hi w_hi; ``passes`` 1 keeps a_hi w_hi alone."""
    a_hi, a_lo = tf32_split(a)
    w_hi, w_lo = tf32_split(w)
    terms = [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)][3 - passes:]
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in terms:
            acc += x[:, k:k + 8] @ y[:, k:k + 8].T
    return acc


def _operands(k: int, n: int, seed: int):
    """Rows of unit scale and weights of the decoders' init scale
    (1/sqrt(K)), float32, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((_ROWS, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(w)


def _error(k: int, n: int, passes: int) -> float:
    """Largest |emulated - float64| over the float64 product's largest."""
    a, w = _operands(k, n, seed=k + n)
    ref = a.double() @ w.double().T
    got = tf32_product(a, w, passes).double()
    return float((got - ref).abs().max() / ref.abs().max())


def test_tf32_rounding_keeps_ten_bits_and_rounds_to_nearest():
    """The rounding clears the 13 low mantissa bits, is within half a TF32
    ulp (2^-11 of the value), rounds a tie away from zero in either sign,
    and carries into the exponent; the split's hi + lo is x within 2^-22
    of |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10000)
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= x.abs().double() * 2.0 ** -22).all()
    tie = 1.0 + 2.0 ** -11            # halfway between two TF32 values
    got = tf32_rna(torch.tensor([tie, -tie, 2.0 - 2.0 ** -12]))
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 2.0]


@pytest.mark.parametrize("k,n", _SHAPES)
def test_three_tf32_passes_are_float32_accurate(k, n):
    """Three passes, float32 accumulators: within F32_TOL of the largest
    output of the float64 product at the flagship's gate and backward
    shapes (about 1e-6: the float32 sums; the terms left out are about
    2^-22 of each product)."""
    assert _error(k, n, passes=3) <= F32_TOL


@pytest.mark.parametrize("k,n", _SHAPES)
def test_one_tf32_pass_misses_the_float32_bound(k, n):
    """One pass (the lo terms dropped: 10-bit operands) misses F32_TOL at
    the same shapes, which is why the kernels run three."""
    assert _error(k, n, passes=1) > F32_TOL


# ---------------------------------------------------------------------------
# K3's float32 head backward and attention-backward band products
# ---------------------------------------------------------------------------

_BAND_K, _TAPS, _ATT = 32, 31, 128
_MELS, _HEAD_N = 80, 1316


def _relative_error(a, w, passes):
    """Largest |emulated a @ w^T - float64| over the float64 product's
    largest."""
    ref = a.double() @ w.double().T
    got = tf32_product(a, w, passes).double()
    return float((got - ref).abs().max() / ref.abs().max())


def _band_operands(rows, seed):
    """A tile's staged cum row (a cumulative attention: a ramp plus noise,
    ``rows + 32`` values with the halo), its band [rows, 32] (31 taps and a
    zero 32nd), the folded filter lc [32, A] (its 32nd tap zero) and a
    cotangent dz [rows, A] of the energy's scale, float32."""
    rng = np.random.default_rng(seed)
    s_cum = np.clip(np.linspace(1.5, -0.5, rows + _BAND_K)
                    + 0.05 * rng.standard_normal(rows + _BAND_K), 0.0, None)
    idx = np.arange(rows)[:, None] + np.arange(_BAND_K)[None]
    band = s_cum[idx]
    band[:, _TAPS:] = 0.0
    lc = 0.1 * rng.standard_normal((_BAND_K, _ATT))
    lc[_TAPS:] = 0.0
    dz = 0.05 * rng.standard_normal((rows, _ATT))
    return tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (s_cum, band, lc, dz))


def _k3_products(rows):
    """The four products of K3's float32 instances as (a [M, K], w [N, K])
    pairs of ``tf32_product``: bwd_head's round(dspec + dframe) [B, 80] @
    W[:80] [80, 1316] (W stored one row an output mel: the product's B as
    it lies), and at a tile of ``rows`` positions loc = band @ lc, dlc =
    band^T @ dz and P = dz @ lc^T."""
    rng = np.random.default_rng(rows)
    dft = rng.standard_normal((_ROWS, _MELS)).astype(np.float32) * 1.4
    head_w = (rng.standard_normal((_MELS, _HEAD_N))
              / np.sqrt(_HEAD_N)).astype(np.float32)
    _, band, lc, dz = _band_operands(rows, seed=rows + 1)
    return {"bwd_head": (torch.from_numpy(dft), torch.from_numpy(head_w).T),
            "loc": (band, lc.T), "dlc": (band.T, dz.T), "P": (dz, lc)}


_K3_CASES = pytest.mark.parametrize("name,rows", [
    ("bwd_head", 16), ("loc", 16), ("loc", 192), ("dlc", 16), ("dlc", 192),
    ("P", 16), ("P", 192)])


@_K3_CASES
def test_three_tf32_passes_hold_k3_float32_products(name, rows):
    """K3's float32 head backward (K = 80) and band products (K = 32 taps,
    a tile's 16 or 192 positions, A = 128) in three passes: within F32_TOL
    of the largest output of the float64 product."""
    a, w = _k3_products(rows)[name]
    assert _relative_error(a, w, passes=3) <= F32_TOL


@_K3_CASES
def test_one_tf32_pass_misses_k3_float32_bound(name, rows):
    """The same products in one pass miss F32_TOL."""
    a, w = _k3_products(rows)[name]
    assert _relative_error(a, w, passes=1) > F32_TOL


def _hankel_fragment(s_cum, off, lane):
    """``band_frag_tf32``: lane's a[0..3] of the A fragment at p = s_cum +
    off, i = lane / 4 + lane % 4: p[i], p[i + 8], p[i + 4], p[i + 12]."""
    i = lane // 4 + lane % 4
    return [float(s_cum[off + i + d]) for d in (0, 8, 4, 12)]


def _tile_fragment(m, r0, c0, lane):
    """The m16n8k8 A fragment of the dense matrix ``m`` at rows r0.. and
    columns c0..: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    g, t = lane // 4, lane % 4
    return [float(m[r0 + g + dr, c0 + t + dc])
            for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4))]


@pytest.mark.parametrize("r0,c0", [(0, 0), (0, 8), (0, 24), (16, 8),
                                   (176, 16)])
def test_hankel_fragment_is_the_band_tile(r0, c0):
    """loc's A fragment of band(cum) rows r0.. (positions) and taps c0..,
    read from s_cum + r0 + c0, is the dense band's 16 x 8 tile, lane by
    lane."""
    s_cum, band, _, _ = _band_operands(192, seed=7)
    band = s_cum[np.arange(192)[:, None] + np.arange(_BAND_K)[None]]
    for lane in range(32):
        assert _hankel_fragment(s_cum, r0 + c0, lane) == \
            _tile_fragment(band, r0, c0, lane)


@pytest.mark.parametrize("r0,c0", [(0, 0), (0, 8), (16, 0), (16, 8),
                                   (16, 184)])
def test_hankel_fragment_is_the_transposed_band_tile(r0, c0):
    """dlc's A fragment of band(cum)^T taps r0.. (0 or 16) and positions
    c0.., read from s_cum + c0 + r0 (the kernel's s_cum + k0 + 16 kh), is
    the dense transposed band's 16 x 8 tile, lane by lane."""
    s_cum, _, _, _ = _band_operands(192, seed=8)
    band_t = s_cum[np.arange(192)[:, None] + np.arange(_BAND_K)[None]].T
    for lane in range(32):
        assert _hankel_fragment(s_cum, c0 + r0, lane) == \
            _tile_fragment(band_t, r0, c0, lane)


def band_swz(row, col, ld):
    """``csrc/tile.cuh::band_swz``: the word of (row, col) in a swizzled
    float32 tile of rows of ``ld`` words."""
    return (row * ld + col) ^ (((row & 3) << 3) | (((row >> 2) & 1) << 2))


@pytest.mark.parametrize("rows,ld", [(32, 16), (32, 128), (16, 48),
                                     (288, 128)])
def test_swizzle_permutes_whole_chunks(rows, ld):
    """On a tile of ``rows`` x ``ld`` words (ld a multiple of 16: lc
    [32][A] and dz [tile][A] at A = 16, 48 and the flagship's 128) the
    swizzle is a bijection onto the tile's words that keeps each 16-byte
    chunk whole and in place within it (cp.async and ldmatrix move
    chunks)."""
    r = np.arange(rows)[:, None]
    c = np.arange(ld)[None]
    words = band_swz(r, c, ld)
    assert sorted(words.ravel().tolist()) == list(range(rows * ld))
    assert (words % 4 == c % 4).all()
    assert (words[:, ::4][:, :, None] + np.arange(4) == words.reshape(
        rows, ld // 4, 4)).all()


def test_swizzle_reads_are_free_of_bank_conflicts():
    """At ld = 128 words (A at the flagship's widths) each read of the
    band routine falls in 32 distinct banks: a "KN" fragment word (lane
    (g, t) at row k0 + t or k0 + t + 4, column n0 + g), and ldmatrix's 8
    rows of one 16-byte chunk (the "MK" and "NK" fragments)."""
    ld = 128
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for k0 in range(0, 32, 8):
        for n0 in range(0, ld, 8):
            for dk in (0, 4):
                banks = band_swz(k0 + t + dk, n0 + g, ld) % 32
                assert len(set(banks.tolist())) == 32
    for r0 in range(0, 32, 8):
        for col in range(0, ld, 4):
            first = band_swz(r0 + np.arange(8), col, ld) % 32
            banks = (first[:, None] + np.arange(4)[None]).ravel()
            assert len(set(banks.tolist())) == 32


# ---------------------------------------------------------------------------
# K2's float32 location-sensitive step and K3's float32 prenet backward
# ---------------------------------------------------------------------------

# the step's bound: every weight within this share of its row's largest
# weight (the float32 step in three passes: about 1e-7)
_STEP_TOL = 1e-6
_PRENET_P, _PRENET_ROWS, _WARPS = 256, 16, 8


def _attention_row(t_len, seed):
    """One batch row of K2's step at the flagship's widths: the cum carry
    (a ramp of attention mass plus noise), lc [32, A] (31 taps and a zero
    32nd), q [A], mtb [T, A], v [A] (the init scale, 1/sqrt(A)) and a mask
    with the last positions off, float32."""
    rng = np.random.default_rng(seed)
    cum = np.clip(np.linspace(2.0, -1.0, t_len)
                  + 0.05 * rng.standard_normal(t_len), 0.0, None)
    lc = 0.1 * rng.standard_normal((_BAND_K, _ATT))
    lc[_TAPS:] = 0.0
    q = 0.5 * rng.standard_normal(_ATT)
    mtb = 0.5 * rng.standard_normal((t_len, _ATT))
    v = rng.standard_normal(_ATT) / np.sqrt(_ATT)
    mask = np.zeros(t_len)
    mask[t_len - t_len // 10:] = -1e9
    return tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (cum, lc, q, mtb, v, mask))


def _staged_band(cum, t_len):
    """band(cum) [T, 32] built as the kernel stages it: tiles of
    ``att_bwd_tiles(T)`` positions, each CTA's cum row with its halo,
    s_cum[i] = cum[t_lo + i - half] (zero outside [0, T)), and the tile's
    rows r read as s_cum[r .. r + 32)."""
    from multilingual_text_to_speech_tpu_torch.ops.fused_train_decoder import (
        att_bwd_tiles,
    )

    tile, cluster = att_bwd_tiles(t_len)
    half = (_TAPS - 1) // 2
    padded = torch.zeros(t_len + cluster * tile + _BAND_K)
    padded[half:half + t_len] = cum
    rows = []
    for rank in range(cluster):
        s_cum = padded[rank * tile:rank * tile + tile + _BAND_K]
        idx = torch.arange(tile)[:, None] + torch.arange(_BAND_K)[None]
        rows.append(s_cum[idx])
    return torch.cat(rows)[:t_len]


def _attention_weights(t_len, passes):
    """The step's weights (loc = band(cum) @ lc in ``passes`` TF32 passes,
    then tanh((loc + q) + mtb), the v-sum, the mask and the softmax in
    float32) against the same step in float64: the largest |difference|
    over the row's largest weight."""
    cum, lc, q, mtb, v, mask = _attention_row(t_len, seed=t_len)
    band = _staged_band(cum, t_len)
    loc = tf32_product(band, lc.T, passes)
    e = (v * torch.tanh((loc + q) + mtb)).sum(-1) + mask
    w = torch.softmax(e, -1)
    band64 = band.double()
    e64 = ((v.double() * torch.tanh(band64 @ lc.double() + q.double()
                                    + mtb.double())).sum(-1)
           + mask.double())
    w64 = torch.softmax(e64, -1)
    return float((w.double() - w64).abs().max() / w64.abs().max())


@pytest.mark.parametrize("t_len", [128, 1500])
def test_three_tf32_passes_hold_the_float32_attention_step(t_len):
    """K2's float32 location-sensitive step with the band product in three
    TF32 passes (A = 128, 31 taps in BAND_K = 32, 16-position tiles at T =
    128, 192 at T = 1500): every weight within 1e-6 of the row's largest
    against the step in float64."""
    assert _attention_weights(t_len, passes=3) <= _STEP_TOL


@pytest.mark.parametrize("t_len", [128, 1500])
def test_one_tf32_pass_misses_the_float32_attention_step(t_len):
    """The same step with the band product in one pass misses it."""
    assert _attention_weights(t_len, passes=1) > _STEP_TOL


def tf32x3_splits(n):
    """``csrc/tile.cuh::tf32x3_splits``: the K slices of a float32 prenet
    layer (``bwd_prenet``'s and the forward prenets') over n columns, as
    many as the warps that its n8 tiles leave."""
    return _WARPS // (n // 8) if n // 8 < _WARPS else 1


def _warp_partial(a, w, passes):
    """A warp's partial over its K slice as ``bwd_prenet_kernel<float>``
    sums it: each pass (a_lo w_hi, a_hi w_lo, a_hi w_hi; one pass: the
    last alone) and each 8-deep k-step's parity in an accumulator of its
    own, then the small terms' four sums, then the hi products' two."""
    a_hi, a_lo = tf32_split(a)
    w_hi, w_lo = tf32_split(w)
    terms = [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)]
    acc = torch.zeros(2, 3, a.shape[0], w.shape[0])
    for step, k in enumerate(range(0, a.shape[1], 8)):
        for j, (x, y) in enumerate(terms):
            if passes == 3 or j == 2:
                acc[step % 2, j] += x[:, k:k + 8] @ y[:, k:k + 8].T
    return (((acc[0, 0] + acc[0, 1]) + (acc[1, 0] + acc[1, 1]))
            + (acc[0, 2] + acc[1, 2]))


def _bwd_prenet_layer(n, passes):
    """One CTA's columns of a layer of K3's float32 prenet backward, dx =
    da @ W^T at K = P = 256 over n columns and 16 rows: each warp's (n8
    tile, K slice) partial in ``passes`` TF32 passes (``_warp_partial``),
    the partials summed in K order in float32, against the float64
    product: the largest |difference| over the largest output."""
    rng = np.random.default_rng(n)
    keep = rng.random((_PRENET_ROWS, _PRENET_P)) < 0.5
    da = (0.2 * rng.standard_normal((_PRENET_ROWS, _PRENET_P)) * keep)
    w = rng.standard_normal((n, _PRENET_P)) / np.sqrt(_PRENET_P)
    da, w = (torch.from_numpy(x.astype(np.float32)) for x in (da, w))
    splits = tf32x3_splits(n)
    kslice = (_PRENET_P // splits + 7) // 8 * 8
    got = torch.zeros(_PRENET_ROWS, n)
    for ks in range(splits):
        k = slice(ks * kslice, min(_PRENET_P, (ks + 1) * kslice))
        got += _warp_partial(da[:, k], w[:, k], passes)
    ref = da.double() @ w.double().T
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n", [32, 16])
def test_three_tf32_passes_hold_bwd_prenet_float32_products(n):
    """K3's float32 prenet backward: a P x P layer's 32 columns a CTA (4 n8
    tiles in two K halves) and layer 0's 16 (2 tiles in four quarters),
    three passes: within 1e-6 of the largest output."""
    assert _bwd_prenet_layer(n, passes=3) <= _STEP_TOL


@pytest.mark.parametrize("n", [32, 16])
def test_one_tf32_pass_misses_bwd_prenet_float32_bound(n):
    """The same products in one pass miss it."""
    assert _bwd_prenet_layer(n, passes=1) > _STEP_TOL


@pytest.mark.parametrize("n,p", [(32, 256), (16, 256), (24, 256), (64, 512),
                                 (8, 32)])
def test_bwd_prenet_k_split_covers_every_tile_and_k_once(n, p):
    """The float32 ``bwd_prenet``'s warps (pair = warp, warp + 8, ...; n8
    tile pair % tiles, K slice pair / tiles) take every (n8 tile, K slice)
    once, and the K slices, 8-deep steps, tile [0, kp) in order (kp = P
    rounded up to 32): at the flagship's np = 32 two halves, at n0 = 16
    four quarters."""
    kp = (p + 31) // 32 * 32
    tiles, splits = n // 8, tf32x3_splits(n)
    kslice = (kp // splits + 7) // 8 * 8
    seen = []
    for warp in range(_WARPS):
        for pair in range(warp, tiles * splits, _WARPS):
            seen.append((pair % tiles, pair // tiles))
    assert sorted(seen) == [(t, s) for t in range(tiles)
                            for s in range(splits)]
    steps = [k for s in range(splits)
             for k in range(s * kslice, min(kp, (s + 1) * kslice), 8)]
    assert steps == list(range(0, kp, 8))
    assert {(32, 256): 2, (16, 256): 4}.get((n, p), splits) == splits


def _pair_fragment(m, r0, c0, lane):
    """The m16n8k8 A fragment of ``m`` at rows r0.. and the 8-deep step at
    column c0 with k taken in pairs (``csrc/tile.cuh::warp_tf32x3_kslice``):
    slot t holds column c0 + 2t and slot t + 4 column c0 + 2t + 1, so lane
    (g, t) holds (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)."""
    g, t = lane // 4, lane % 4
    return [float(m[r0 + g + dr, c0 + 2 * t + dc])
            for dr, dc in ((0, 0), (8, 0), (0, 1), (8, 1))]


def _half_warp_banks_distinct(words):
    """Each half-warp's 8-byte reads at 32-bit word offsets ``words`` (one
    a lane) fall in 32 distinct banks (the card serves a warp's 8-byte
    reads a half-warp at a time)."""
    for half in (words[:16], words[16:]):
        banks = np.concatenate([half, half + 1]) % 32
        if len(set(banks.tolist())) != 32:
            return False
    return True


def test_bwd_prenet_fragments_are_the_tiles_and_free_of_conflicts():
    """The float32 ``bwd_prenet``'s fragment reads at rows of ldw = kp + 4
    words: lane (g, t)'s A words ar[k], ar[8 ldw + k], ar[k + 4], ar[8 ldw
    + k + 4] (ar = s_a + g ldw + t) are da's 16 x 8 tile at column k, its B
    words wr[k], wr[k + 4] (wr = the weight rows + (8 nt + g) ldw + t) the
    "NK" fragment (k t, n g) of W^T, and each read falls in 32 distinct
    banks."""
    kp = _PRENET_P
    ldw = kp + 4
    rng = np.random.default_rng(3)
    da = rng.standard_normal((_PRENET_ROWS, kp)).astype(np.float32)
    w = rng.standard_normal((32, kp)).astype(np.float32)
    s_a = np.zeros(_PRENET_ROWS * ldw, np.float32)
    s_w = np.zeros(32 * ldw, np.float32)
    for r in range(_PRENET_ROWS):
        s_a[r * ldw:r * ldw + kp] = da[r]
    for r in range(32):
        s_w[r * ldw:r * ldw + kp] = w[r]
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for k in range(0, kp, 8):
        ar = g * ldw + t
        a_words = [ar + k, ar + 8 * ldw + k, ar + k + 4, ar + 8 * ldw + k + 4]
        for lane in range(32):
            assert [float(s_a[x[lane]]) for x in a_words] == \
                _tile_fragment(da, 0, k, lane)
        for words in a_words:
            assert len(set((words % 32).tolist())) == 32
        for nt in range(4):
            wr = (8 * nt + g) * ldw + t
            for lane in range(32):
                assert [float(s_w[wr[lane] + k]),
                        float(s_w[wr[lane] + k + 4])] == \
                    [float(w[8 * nt + g[lane], k + t[lane]]),
                     float(w[8 * nt + g[lane], k + t[lane] + 4])]
            for words in (wr + k, wr + k + 4):
                assert len(set((words % 32).tolist())) == 32


# ---------------------------------------------------------------------------
# K1's and K2's float32 forward prenet (prenet_tile_kernel<Epi, float>)
# ---------------------------------------------------------------------------

# the flagship's prenet: M = 80 mels in, P = 256, its columns in 8 CTAs of
# np = 32 (ops/fused_decoder.py::prenet_split); a CTA's shared memory
_PRENET_M, _SMEM_MAX = 80, 227 * 1024


def _prenet_layer(k, n, passes):
    """One CTA's columns of a float32 forward prenet layer, x [16, k] @ W
    [k, n] ("KN": W's column slice) over n = 32 columns: each warp's (n8
    tile, K slice) partial in ``passes`` TF32 passes (``_warp_partial``),
    the slices summed in K order in float32, against the float64 product:
    the largest |difference| over the largest output.  Layer 0 reads a mel
    frame (K = 80), the layers above ReLU outputs with half dropped (K =
    256); the weights at the init scale 1/sqrt(K)."""
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((_PRENET_ROWS, k))
    if k != _PRENET_M:
        x = np.maximum(x, 0.0) * (rng.random(x.shape) < 0.5) * 2.0
    w = rng.standard_normal((k, n)) / np.sqrt(k)
    x, w = (torch.from_numpy(v.astype(np.float32)) for v in (x, w))
    kp = (k + 15) // 16 * 16
    splits = tf32x3_splits(n)
    kslice = (kp // splits + 7) // 8 * 8
    got = torch.zeros(_PRENET_ROWS, n)
    for ks in range(splits):
        sl = slice(min(k, ks * kslice), min(k, (ks + 1) * kslice))
        got += _warp_partial(x[:, sl], w[sl].T, passes)
    ref = x.double() @ w.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("k", [80, 256])
def test_three_tf32_passes_hold_the_prenet_float32_layers(k):
    """The forward prenet's float32 layers in three passes, K split over
    the warps (4 n8 tiles x 2 slices at np = 32): within F32_TOL of the
    largest output at layer 0's K = 80 and the layers above's 256 (about
    1e-7)."""
    assert _prenet_layer(k, 32, passes=3) <= F32_TOL


@pytest.mark.parametrize("k", [80, 256])
def test_one_tf32_pass_misses_the_prenet_float32_bound(k):
    """The same layers in one pass miss it."""
    assert _prenet_layer(k, 32, passes=1) > F32_TOL


def pn_layout_total(in_dim, p, np_, n_layers, es=4, kslices=True):
    """Bytes of ``csrc/tile.cuh::PnLayout`` (``prenet_tile_kernel``'s
    shared memory); ``kslices`` False: the FFMA layout it replaced (the A
    tile's rows of kmax + 4 words, no K partials)."""
    def a16(x):
        return (x + 15) // 16 * 16

    pad = 16 // es
    kp0, kpp = (in_dim + 15) // 16 * 16, (p + 15) // 16 * 16
    kmax = max(kp0, kpp)
    lda = ((kmax + 31) // 32 * 32 + 8 if es == 4 and kslices
           else kmax + pad)
    ldw = ldo = np_ + pad
    ldx = a16(in_dim * 4)
    total = a16((kp0 + (n_layers - 1) * kpp) * ldw * es)
    total += a16(n_layers * np_ * 4)
    parts = (tf32x3_splits(np_) * _PRENET_ROWS * np_ * 4
             if es == 4 and kslices else 0)
    total += a16(max(_PRENET_ROWS * ldx, parts))
    total += a16(_PRENET_ROWS * lda * es)
    return total + 2 * a16(_PRENET_ROWS * ldo * es)


def _deepest(np_, **kw):
    n = 1
    while pn_layout_total(_PRENET_M, _PRENET_P, np_, n + 1, **kw) \
            <= _SMEM_MAX:
        n += 1
    return n


@pytest.mark.parametrize("np_", [32, 16])
def test_prenet_k_split_covers_every_tile_and_k_once(np_):
    """The float32 forward prenet's warps (pair = warp, warp + 8, ...; n8
    tile pair % tiles, K slice pair / tiles) take every (n8 tile, K slice)
    of each layer once, and the slices' 8-deep steps tile the layer's K
    (80, then 256) once in order, at every depth from one layer to the
    deepest a CTA holds: six at the flagship's np = 32, as the FFMA layout
    held (the K partials reuse the input rows' bytes), ten at np = 16."""
    tiles, splits = np_ // 8, tf32x3_splits(np_)
    assert tiles * splits == _WARPS
    deepest = _deepest(np_)
    assert deepest == {32: 6, 16: 10}[np_]
    assert deepest >= _deepest(np_, kslices=False)
    for n_layers in range(1, deepest + 1):
        for layer in range(n_layers):
            kp = (_PRENET_M if layer == 0 else _PRENET_P + 15) // 16 * 16
            kslice = (kp // splits + 7) // 8 * 8
            seen = [(pair % tiles, pair // tiles) for warp in range(_WARPS)
                    for pair in range(warp, tiles * splits, _WARPS)]
            assert sorted(seen) == [(t, s) for t in range(tiles)
                                    for s in range(splits)]
            steps = [k for s in range(splits)
                     for k in range(min(kp, s * kslice),
                                    min(kp, (s + 1) * kslice), 8)]
            assert steps == list(range(0, kp, 8))


@pytest.mark.parametrize("np_", [8, 16, 24, 32, 64])
def test_prenet_kn_fragments_are_the_tiles_and_free_of_conflicts(np_):
    """The forward prenet's "KN" B fragments at weight rows of ldw = np + 4
    words (the pitch the bf16 layout already took), k in pairs: lane (g,
    t) reads rows k0 + 2t and k0 + 2t + 1 of column n0 + g, W's fragment in
    the A tile's pair order, and each of the two reads falls in 32
    distinct banks (bank 8t + g or 24t + g plus a constant); the plain
    order (rows k0 + t and k0 + t + 4) at that pitch would be two-way
    conflicted.  The A tile's reads, in the same pair order (slot t: k0 +
    2t, slot t + 4: k0 + 2t + 1), are one 8-byte read a row, which at rows
    of lda = 8 mod 32 words fall in 32 distinct banks half-warp by
    half-warp (at 4 mod 32 they would not)."""
    ldw, kp = np_ + 4, 256
    rng = np.random.default_rng(np_)
    w = rng.standard_normal((kp, np_)).astype(np.float32)
    s_w = np.zeros(kp * ldw, np.float32)
    for k in range(kp):
        s_w[k * ldw:k * ldw + np_] = w[k]
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for k0 in range(0, kp, 8):
        for n0 in range(0, np_, 8):
            words = [(k0 + 2 * t + d) * ldw + n0 + g for d in (0, 1)]
            for lane in range(32):
                assert [float(s_w[x[lane]]) for x in words] == \
                    [float(w[k0 + 2 * t[lane] + d, n0 + g[lane]])
                     for d in (0, 1)]
            for x in words:
                assert len(set((x % 32).tolist())) == 32
            plain = (k0 + t) * ldw + n0 + g
            assert len(set((plain % 32).tolist())) < 32
    lda = (max(_PRENET_M, _PRENET_P) + 31) // 32 * 32 + 8
    assert lda % 32 == 8
    x = rng.standard_normal((_PRENET_ROWS, lda)).astype(np.float32)
    for k in range(0, kp, 8):
        ar = g * lda + 2 * t + k
        for lane in range(32):
            assert [float(x.ravel()[w_]) for w_ in
                    (ar[lane], ar[lane] + 8 * lda, ar[lane] + 1,
                     ar[lane] + 8 * lda + 1)] == _pair_fragment(x, 0, k, lane)
        for r0 in (0, 8):
            assert _half_warp_banks_distinct((r0 + g) * lda + 2 * t + k)
            assert not _half_warp_banks_distinct(
                (r0 + g) * (lda - 4) + 2 * t + k)


# ---------------------------------------------------------------------------
# the forward family's att_bwd: the dz pass's (channel pair, positions) map
# ---------------------------------------------------------------------------

_AB_THREADS, _AB_DZ_BATCH = 256, 8


def ab_fam_map(a_dim, rows):
    """``csrc/fused_train_decoder.cu::AbFamMap``: (pairs, groups, per) of
    the family's dz pass: a thread a channel pair and a group of ``per``
    positions, as many groups as the 256 threads leave."""
    pairs = (a_dim + 1) // 2
    groups = _AB_THREADS // pairs if pairs < _AB_THREADS else 1
    return pairs, groups, -(-rows // groups)


def _dz_visits(a_dim, rows):
    """Every (position, channel) the family's dz pass updates, in each
    thread's order: thread tid takes c = tid, tid + 256, ... below pairs x
    groups, channels 2 (c % pairs) and the next (past A: none), positions
    [grp per, min(rows, grp per + per)) of grp = c / pairs in batches of
    AB_DZ_BATCH; and the position groups' order of the partials' sum."""
    pairs, groups, per = ab_fam_map(a_dim, rows)
    visits, busy = [], set()
    for tid in range(_AB_THREADS):
        for c in range(tid, pairs * groups, _AB_THREADS):
            busy.add(tid)
            a, grp = 2 * (c % pairs), c // pairs
            i_lo, i_hi = grp * per, min(rows, grp * per + per)
            order = [i0 + j for i0 in range(i_lo, i_hi, _AB_DZ_BATCH)
                     for j in range(_AB_DZ_BATCH) if i0 + j < i_hi]
            assert order == list(range(i_lo, i_hi))
            visits += [(i, ch) for i in order for ch in (a, a + 1)
                       if ch < a_dim]
    return visits, busy, groups


@pytest.mark.parametrize("a_dim", [128, 127, 90])
@pytest.mark.parametrize("tile", [16, 64, 192])
def test_fwd_att_bwd_dz_map_covers_every_position_and_channel_once(tile,
                                                                   a_dim):
    """The family ``att_bwd``'s dz pass (a thread a channel pair and a
    group of positions) updates every (position, channel) of a tile once,
    at the tiles of 16 (T = 128), 64 (T = 512) and 192 (T = 1,500)
    positions and at a last tile cut short, at A = 128 (64 pairs x 4
    groups: every thread busy), at an odd A (the last pair's second channel
    past A) and at A = 90 (45 pairs x 5 groups); the groups, summed in
    group order, take the positions in ascending order."""
    for rows in (tile, tile - 5):
        visits, busy, groups = _dz_visits(a_dim, rows)
        assert len(visits) == len(set(visits)) == rows * a_dim
        assert set(visits) == {(i, ch) for i in range(rows)
                               for ch in range(a_dim)}
        _, _, per = ab_fam_map(a_dim, rows)
        starts = [grp * per for grp in range(groups)]
        assert starts == sorted(starts) and starts[0] == 0
    if a_dim == 128:
        assert busy == set(range(_AB_THREADS)) and groups == 4


@pytest.mark.parametrize("a_dim", [128, 256])
def test_swizzled_kn_fragment_is_the_lc_tile(a_dim):
    """``train_attention``'s lc B fragments: lane (g, t) of the warp whose
    channels start at n0 (16 a warp, two n8 groups) reads the swizzled
    words (k0 + t, n0 + g) and (k0 + t + 4, n0 + g) (``band_frag_kn``):
    the dense lc's (k t, n g) fragment, for every k step and channel group
    of A = 128 and 256."""
    rng = np.random.default_rng(a_dim)
    lc = rng.standard_normal((_BAND_K, a_dim)).astype(np.float32)
    s_lc = np.zeros(_BAND_K * a_dim, np.float32)
    r = np.arange(_BAND_K)[:, None]
    c = np.arange(a_dim)[None]
    s_lc[band_swz(r, c, a_dim)] = lc
    for n0 in range(0, a_dim, 8):
        for k0 in range(0, _BAND_K, 8):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                got = [float(s_lc[band_swz(k0 + t + dk, n0 + g, a_dim)])
                       for dk in (0, 4)]
                assert got == [float(lc[k0 + t, n0 + g]),
                               float(lc[k0 + t + 4, n0 + g])]


# ---------------------------------------------------------------------------
# K1's float32 location-sensitive attention step
# ---------------------------------------------------------------------------

_HIDDEN, _K1_ROWS, _K1_CLUSTER = 1024, 8, 8


def _k1_step(t_len, passes):
    """K1's float32 step for one cluster of 8 batch rows as its kernel
    runs it: each CTA's query partial over its K = 128 slice of H (rows of
    h_att [8, 1024] against Wq [1024, 128], the init scale 1/sqrt(H)) as
    ``_warp_partial`` sums a warp's K slice, the 8 partials added in rank
    order in float32; loc = band(cum) @ lc over the row's T positions
    (``tf32_product``: each 8-deep tap step's passes summed straight into
    the accumulator); then row 0's tanh((loc + q) + mtb), the v-sum, the
    mask and the softmax in float32.  -> {output: largest |emulated -
    float64| over the float64 output's largest} for the query, loc and the
    weights."""
    rng = np.random.default_rng(t_len + 11)
    h = torch.from_numpy(np.tanh(rng.standard_normal((_K1_ROWS, _HIDDEN)))
                         .astype(np.float32))
    wq = torch.from_numpy((rng.standard_normal((_HIDDEN, _ATT))
                           / np.sqrt(_HIDDEN)).astype(np.float32))
    kq = _HIDDEN // _K1_CLUSTER
    q = torch.zeros(_K1_ROWS, _ATT)
    for rank in range(_K1_CLUSTER):
        k = slice(rank * kq, (rank + 1) * kq)
        q = q + _warp_partial(h[:, k], wq[k].T.contiguous(), passes)
    cum, lc, _, mtb, v, mask = _attention_row(t_len, seed=t_len)
    half = (_TAPS - 1) // 2
    padded = torch.zeros(t_len + _BAND_K)
    padded[half:half + t_len] = cum
    band = padded[torch.arange(t_len)[:, None] + torch.arange(_BAND_K)[None]]
    loc = tf32_product(band, lc.T.contiguous(), passes)
    w = torch.softmax((v * torch.tanh((loc + q[0]) + mtb)).sum(-1) + mask, -1)
    q64 = h.double() @ wq.double()
    loc64 = band.double() @ lc.double()
    w64 = torch.softmax((v.double() * torch.tanh(loc64 + q64[0]
                                                 + mtb.double())).sum(-1)
                        + mask.double(), -1)
    return {name: float((got.double() - ref).abs().max() / ref.abs().max())
            for name, got, ref in (("query", q, q64), ("loc", loc, loc64),
                                   ("weights", w, w64))}


_K1_CASES = pytest.mark.parametrize("t_len,output", [
    (t, o) for t in (128, 600) for o in ("query", "loc", "weights")])


@_K1_CASES
def test_three_tf32_passes_hold_k1_float32_attention_step(t_len, output):
    """K1's float32 location-sensitive step with its query product (K =
    128 a CTA, the cluster's 8 partials in rank order) and its band
    product in three TF32 passes: the query, loc and the weights each
    within F32_TOL of the largest of the step in float64 (about 1e-7)."""
    assert _k1_step(t_len, passes=3)[output] <= F32_TOL


@_K1_CASES
def test_one_tf32_pass_misses_k1_float32_attention_step(t_len, output):
    """The same step with both products in one pass misses F32_TOL on each
    output (about 1e-4 to 3e-4)."""
    assert _k1_step(t_len, passes=1)[output] > F32_TOL
