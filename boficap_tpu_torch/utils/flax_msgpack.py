"""Reader and writer of the msgpack files that flax's
``serialization.to_bytes`` writes: the JAX package's ``model.ckpt``.

Pure Python over ``struct`` and numpy; no ``msgpack`` or ``flax`` import.
Only the subset flax writes is handled:

  * msgpack maps (fix/16/32) with string keys, arrays (fix/16/32), strings
    (fix/8/16/32), bin (8/16/32), ints, floats, bool and nil;
  * ext (fixext/8/16/32) code 1, an array: the msgpack triple
    ``(shape, dtype name, C-order bytes)``; code 3, a numpy scalar in the
    same form (flax's code 2, a Python complex, is no parameter's);
  * an array above ``MAX_CHUNK_SIZE`` bytes, which flax writes as a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
    {"0": flat array, ...}}``.

The dtype names are ``float32``, ``int32`` and ``bool`` (numpy arrays) and
``bfloat16`` (a ``torch.bfloat16`` tensor, from its uint16 bits).  Any
other dtype, ext code, format byte or a truncated buffer raises
``ValueError``.  Arrays are views of the input buffer (``np.frombuffer``
on ``memoryview`` slices), so a full-size checkpoint reads without a
per-byte Python loop.

The writer writes the same subset, byte for byte what flax writes for a
tree of dicts with those leaves, chunking above the same limit.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict, List

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 byte limit per
# object, with a margin
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
NUMPY_DTYPES = {"float32": np.dtype(np.float32), "int32": np.dtype(np.int32),
                "bool": np.dtype(np.bool_)}
BF16 = "bfloat16"

__all__ = ["msgpack_restore", "msgpack_serialize", "MAX_CHUNK_SIZE"]


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wanted {n} of {len(self.buf) - self.pos})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
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
        if b in _LEN_FMT:
            kind, fmt = _LEN_FMT[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            code = self.unpack(">b")                              # ext
            return _ext(code, self.take(n))
        if b in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT[b]))
        if b in _NUM_FMT:
            return self.unpack(_NUM_FMT[b])
        raise ValueError(f"msgpack: format byte 0x{b:02x} at {self.pos - 1} "
                         "is not in the subset flax writes")

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


# format byte -> (kind, length format) for the length-prefixed forms
_LEN_FMT = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUM_FMT = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _whole(data, what: str):
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         f"{what}")
    return out


def _ndarray(payload):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, bytes)."""
    triple = _whole(payload, "array header")
    if (not isinstance(triple, list) or len(triple) != 3
            or not isinstance(triple[0], list)
            or not isinstance(triple[1], str)
            or not isinstance(triple[2], memoryview)):
        raise ValueError("msgpack: an array is not (shape, dtype, bytes)")
    shape, name, buf = triple
    if not all(isinstance(d, int) and d >= 0 for d in shape):
        raise ValueError(f"msgpack: bad array shape {shape}")
    if name == BF16:
        dtype = np.dtype(np.uint16)
    elif name in NUMPY_DTYPES:
        dtype = NUMPY_DTYPES[name]
    else:
        raise ValueError(f"msgpack: dtype {name!r} is not one of "
                         f"{sorted(NUMPY_DTYPES) + [BF16]}")
    n = math.prod(shape)
    if len(buf) != n * dtype.itemsize:
        raise ValueError(f"msgpack: {len(buf)} bytes for a {name} array of "
                         f"shape {tuple(shape)}")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    if name == BF16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr


def _ext(code: int, payload):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    raise ValueError(f"msgpack: ext code {code} is not an array or a "
                     "numpy scalar")


def _unchunk(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if not isinstance(d, dict):
        return d
    if CHUNKED in d:
        try:
            shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        except (KeyError, TypeError) as e:
            raise ValueError(f"msgpack: malformed chunked array: {e!r}")
        if chunks and torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in d.items()}


def msgpack_restore(data) -> Any:
    """Bytes written by ``flax.serialization.to_bytes`` (or by
    ``msgpack_serialize``) -> the tree: nested dicts whose leaves are numpy
    arrays, ``torch.bfloat16`` tensors or Python scalars."""
    return _unchunk(_whole(data, "top-level object"))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes) -> None:
    """The header of a sized object: a fix form up to ``fix_max``, else the
    8/16/32-bit length forms in ``codes`` (None where the form is absent)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} above 2**32 - 1")


def _pack_int(out: bytearray, v: int) -> None:
    """msgpack's smallest encoding of an int, as the msgpack package picks
    it."""
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} above 2**64 - 1")
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} below -2**63")


def _array_triple(x):
    """(shape, dtype name, C-order bytes) of an array leaf."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return list(x.shape), BF16, x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name not in NUMPY_DTYPES:
        raise ValueError(f"msgpack: dtype {x.dtype.name!r} is not one of "
                         f"{sorted(NUMPY_DTYPES) + [BF16]}")
    return list(x.shape), x.dtype.name, x.tobytes("C")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(fix[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _pack(out: bytearray, x) -> None:
    # numpy scalars first: np.float64 is a float subclass, and flax writes
    # every numpy scalar as ext 3 (msgpack's strict_types)
    if isinstance(x, np.generic) or (torch.is_tensor(x) and x.dim() == 0):
        _pack_ext(out, EXT_NPSCALAR, _packb(list(_array_triple(x))))
    elif x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, list):
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _packb(list(_array_triple(x))))
    else:
        raise ValueError(f"msgpack: cannot write a {type(x).__name__}")


def _packb(x) -> bytes:
    out = bytearray()
    _pack(out, x)
    return bytes(out)


def _chunk(x):
    """flax's ``_chunk``: a flat array cut into MAX_CHUNK_SIZE-byte pieces."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    step = max(1, int(MAX_CHUNK_SIZE / (_nbytes(flat) // max(n, 1))))
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + step]
                       for j, i in enumerate(range(0, n, step))}}


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return x.nbytes if isinstance(x, np.ndarray) else 0


def _chunk_leaves(d):
    """flax's ``_chunk_array_leaves_in_place``, on a copy."""
    if isinstance(d, dict):
        return {k: _chunk_leaves(v) for k, v in d.items()}
    return _chunk(d) if _nbytes(d) > MAX_CHUNK_SIZE else d


def msgpack_serialize(tree) -> bytes:
    """A tree of dicts (string keys) with array leaves (numpy float32 /
    int32 / bool, torch tensors of those or bfloat16) and Python scalars ->
    the bytes ``flax.serialization.to_bytes`` writes for it."""
    return _packb(_chunk_leaves(tree))
