"""Why the port's float32 products run three TF32 passes, on the CPU.

Both decoders' float32 instances compute their gate and split-K products on
the tensor cores as three TF32 passes (``csrc/tile.cuh``: ``tf32_split``,
``mma_tf32x3``): each float32 operand x is split into hi = tf32(x) and lo =
tf32(x - hi), rounded to nearest with ties away from zero (``cvt.rna``),
and each 8-deep K step of ``mma.sync.m16n8k8`` adds a_lo b_hi, a_hi b_lo
and a_hi b_hi, small terms first, into a float32 accumulator.  This file
emulates that arithmetic in torch at the flagship's shapes (B=50 rows
against the gate weights, K = 1572 and 2340 against 4H = 4096, and the
backward's K = 4H = 4096 against 2340) and holds it against a float64
product: three passes land within 1e-5 of the largest output (the bound of
``chip_smoke.py``'s float32 checks), one pass does not.  TF32 rounding is
done on the bits: add half of the 13 dropped mantissa bits, then mask them.
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
