"""The pure-Python pieces around the port's split-K kernel, on the CPU: how
``splitk_kernel``'s K is split (``ops/_splitk.py``, shared by both
decoders) and how large the one scratch of a decoder pass or serving chunk
must be.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``)."""

import pytest

from multilingual_text_to_speech_tpu_torch.ops import _splitk

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
