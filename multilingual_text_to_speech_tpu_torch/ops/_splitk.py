"""How ``splitk_kernel`` (``csrc/tile.cuh``) splits K, for both decoders.

The serving decoder's head and the training decoder's query, head and
backward products run in that one kernel.  A product with few output tiles
splits K into S slices over the grid's z dimension, so that about ``per_sm``
blocks per SM run (two unless the caller says otherwise); the float32
partials go to a scratch ``[S, M, N]`` that a second launch sums in slice
order.  The tile comes from the library that runs the product (its
``splitk_tile``), the SM count from the device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

# at most this many slices, each at least two K tiles long
_SK_MAX_SLICES = 32
# per device index: (tile, SMs); every library compiles the one tile of
# csrc/tile.cuh, so the first library asked answers for all
_GEOMETRY: Dict[int, Tuple[Tuple[int, int, int], int]] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splitk_slices(m: int, n: int, k: int, tile: Tuple[int, int, int],
                  blocks: int) -> Tuple[int, int]:
    """``(S, kslice)``: a product on ``splitk_kernel``'s ``tile`` (BM, BN,
    BK) splits K into S slices of ``kslice`` (a multiple of BK, the last
    slice possibly shorter), so that the ``M x N`` tiles times S come to
    about ``blocks``, each slice at least 2 BK long and S at most
    ``_SK_MAX_SLICES``.  S = 1 leaves K whole."""
    bm, bn, bk = tile
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    s = max(1, min(blocks // tiles, k // (2 * bk), _SK_MAX_SLICES))
    kslice = _cdiv(_cdiv(k, s), bk) * bk
    return _cdiv(k, kslice), kslice


def splitk_scratch_floats(products, tile, blocks) -> int:
    """Floats of the one scratch that holds the split-K partials [S, M, N]
    of whichever of ``products`` (``(m, n, k)`` each) runs."""
    need = 0
    for m, n, k in products:
        s, _ = splitk_slices(m, n, k, tile, blocks)
        if s > 1:
            need = max(need, s * m * n)
    return need


def geometry(lib: ctypes.CDLL, device) -> Tuple[Tuple[int, int, int], int]:
    """``splitk_kernel``'s tile as ``lib`` reports it, and the SMs of
    ``device``."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _GEOMETRY:
        tile = (ctypes.c_int * 3)()
        lib.splitk_tile.argtypes = [ctypes.c_void_p]
        lib.splitk_tile.restype = None
        lib.splitk_tile(tile)
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _GEOMETRY[idx] = (tuple(tile), sms)
    return _GEOMETRY[idx]


def splitk_scratch(lib: ctypes.CDLL, products, like: torch.Tensor,
                   per_sm: int = 2) -> Optional[torch.Tensor]:
    """One float32 scratch on ``like``'s (CUDA) device for the split-K
    launches of a decoder pass or chunk, each ``(m, n, k)`` of ``products``
    in turn (they run one after another on the stream), split for
    ``per_sm`` blocks per SM; None when none splits."""
    tile, sms = geometry(lib, like.device)
    need = splitk_scratch_floats(products, tile, per_sm * sms)
    return torch.empty(need, device=like.device) if need else None


def split(lib: ctypes.CDLL, m: int, n: int, k: int,
          scratch: Optional[torch.Tensor], device, per_sm: int = 2):
    """``(S, kslice, scratch)`` of one split-K launch aiming at ``per_sm``
    blocks per SM.  A split product without a ``scratch`` from its caller
    gets one of its own."""
    tile, sms = geometry(lib, device)
    slices, kslice = splitk_slices(m, n, k, tile, per_sm * sms)
    if slices == 1:
        return slices, kslice, None
    need = slices * m * n
    if scratch is None:
        scratch = torch.empty(need, device=device)
    elif scratch.dtype != torch.float32 or scratch.numel() < need:
        raise ValueError(f"split-K scratch: {need} float32 needed, got "
                         f"{scratch.numel()} {scratch.dtype}")
    return slices, kslice, scratch
