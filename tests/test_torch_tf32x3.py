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
