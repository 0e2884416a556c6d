"""A reader and writer for flax's msgpack checkpoint bytes, in pure Python.

The JAX package writes its checkpoints with ``flax.serialization.
msgpack_serialize``; the port reads and writes the same bytes without
``msgpack`` or ``flax``.  The subset is what those files hold:

- maps, arrays, str, bin, ints, float32/64, nil and bool;
- ext type 1, flax's ``ndarray``: a msgpack triple ``(shape, dtype name,
  C-order bytes)``, and ext type 3, ``npscalar``: the same triple of a 0-d
  array, decoded to its scalar;
- ``bfloat16`` arrays by name: numpy has no such type, so they decode to a
  ``torch.bfloat16`` tensor through a uint16 view, and such a tensor
  encodes back under that name;
- flax's chunked layout of an array above ``MAX_CHUNK_SIZE`` bytes (a map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``),
  which ``unpack`` joins and ``pack`` writes.

Ext type 2 (a Python complex) and every other ext type are refused.  The
writer emits each map's keys in sorted order, so a checkpoint's payload
starts with ``criterion`` (``training.checkpoint._is_checkpoint_file``).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNK_KEY = "__msgpack_chunked_array__"
# flax's limit for one array leaf (msgpack's own is 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30

_BE = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}


class MsgpackError(ValueError):
    """Bytes outside the subset this codec reads."""


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _array_from_triple(data: bytes):
    shape, name, buf = _Reader(data).read_all()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).copy().reshape(shape)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


class _Reader:
    """Recursive descent over one buffer."""

    def __init__(self, data):
        self.mv = memoryview(data)
        self.pos = 0

    def read_all(self):
        obj = self.read()
        if self.pos != len(self.mv):
            raise MsgpackError(
                f"{len(self.mv) - self.pos} trailing bytes after the object")
        return obj

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise MsgpackError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return struct.unpack(_BE[n], self._take(n))[0]

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        data = bytes(self._take(n))
        if code == EXT_NDARRAY:
            return _array_from_triple(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_triple(data)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            raise MsgpackError("ext type 2 (a Python complex) is not "
                               "supported in checkpoints")
        raise MsgpackError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self._uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):                     # bin 8/16/32
            return bytes(self._take(self._uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):                     # ext 8/16/32
            return self._ext(self._uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:                           # uint 8..64
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                           # int 8..64
            n = 1 << (b - 0xD0)
            return struct.unpack(">" + "bhiq"[b - 0xD0], self._take(n))[0]
        if 0xD4 <= b <= 0xD8:                           # fixext 1..16
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                     # str 8/16/32
            return self._str(self._uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):                           # array 16/32
            return self._array(self._uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):                           # map 16/32
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """Chunked arrays back into arrays, as flax does: a chunked map at the
    top or inside maps."""
    if isinstance(d, dict):
        if CHUNK_KEY in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def unpack(data) -> Any:
    """Bytes written by ``flax.serialization.msgpack_serialize`` (or by
    ``pack``) -> the tree: dicts, lists, str, bytes, Python numbers, numpy
    arrays and scalars, ``torch.bfloat16`` tensors."""
    return _unchunk_leaves(_Reader(data).read_all())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or
    32-bit form (``codes`` lists the codes that exist, None where not)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, width, fmt in zip(codes, (1, 2, 4), (">B", ">H", ">I")):
        if code is not None and n < (1 << (8 * width)):
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} exceeds msgpack's 2**32 - 1")


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if v < (1 << (8 * struct.calcsize(fmt))):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise MsgpackError(f"integer {v} does not fit 64 bits")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            bits = 8 * struct.calcsize(fmt)
            if v >= -(1 << (bits - 1)):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise MsgpackError(f"integer {v} does not fit 64 bits")


def _array(out: List[bytes], code: int, x) -> None:
    """flax's ext ``code`` of an array: a msgpack triple ``(shape, dtype
    name, C-order bytes)``; the bytes go to ``out`` as a view of the
    array, not a copy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        name = "bfloat16" if x.dtype == torch.bfloat16 else None
        x = x.view(torch.int16).numpy() if name else x.numpy()
    else:
        name = None
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes cannot be packed")
    data = memoryview(np.ascontiguousarray(x).reshape(-1).view(np.uint8))
    head: List[bytes] = [b"\x93"]                      # fixarray of 3
    _pack(head, [int(s) for s in x.shape])
    _pack(head, name or x.dtype.name)
    _head(head, len(data), None, -1, (0xC4, 0xC5, 0xC6))
    head = b"".join(head)
    n = len(head) + len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        out.append(bytes([fix]))
    else:
        _head(out, n, None, -1, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.append(head)
    out.append(data)


def _chunked(x):
    """flax's chunked map of an array above MAX_CHUNK_SIZE bytes, or None."""
    if isinstance(x, torch.Tensor):
        numel, itemsize = x.numel(), x.element_size()
    else:
        numel, itemsize = x.size, x.dtype.itemsize
    if numel * itemsize <= MAX_CHUNK_SIZE:
        return None
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNK_KEY: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, numel, size))}}


def _pack(out: List[bytes], x) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        big = _chunked(x)
        if big is not None:
            _pack(out, big)
            return
        _array(out, EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        _array(out, EXT_NPSCALAR, np.asarray(x))
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _head(out, len(b), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(b)
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(x):
            _pack(out, k)
            _pack(out, x[k])
    elif isinstance(x, complex):
        raise MsgpackError("a Python complex (flax's ext type 2) is not "
                           "supported in checkpoints")
    else:
        raise MsgpackError(f"cannot pack a {type(x).__name__}")


def pack_chunks(tree) -> List[bytes]:
    """``pack``'s bytes as a list of pieces (each array's data a view of
    it), for a file's ``writelines`` without joining them first."""
    out: List[bytes] = []
    _pack(out, tree)
    return out


def pack(tree) -> bytes:
    """A tree of dicts (str keys), lists, tuples, str, bytes, Python
    numbers, None, numpy arrays and scalars and CPU-copyable torch tensors
    -> msgpack bytes that ``flax.serialization.msgpack_restore`` reads.
    numpy scalars go as flax's ``npscalar``, arrays and tensors as its
    ``ndarray`` (0-d ones too), Python floats as float64."""
    return b"".join(pack_chunks(tree))
