"""Flax's msgpack checkpoint format, read and written in pure Python.

The JAX package writes per-network checkpoints with
``flax.serialization.to_bytes`` and reads them with ``from_bytes``
(``learned_hologram_gan_tpu/train/checkpoint.py:36-44``).  Hosts without
the ``msgpack`` package (the GPU machine has none) read and write the same
files through this module.  The format, as flax writes it:

* nested maps with string keys, in the sorted key order of a JAX pytree
  (the JAX package's writer passes the tree through ``jax.device_get``,
  which rebuilds it key-sorted), empty maps included (AP2POH's
  ``"batch_stats": {}``);
* each array is ``ExtType(1, packb((shape, dtype.name, C-order bytes)))``,
  a numpy scalar ``ExtType(3, ...)`` of the same payload, a Python complex
  ``ExtType(2, packb((real, imag)))``;
* Python floats are msgpack float 64s and ints take their smallest
  encoding; every header (int, string, bytes, array, map, ext) takes the
  smallest form, as msgpack-python picks it, so re-encoding a decoded file
  gives its bytes back;
* arrays over 2**30 bytes are split into flax's chunked form
  (``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``)
  and joined again on reading.

:func:`decode` returns nested dicts of numpy arrays in the file's key
order; :func:`encode` writes a tree in its own key order, as
``flax.serialization.to_bytes`` does; :func:`to_bytes` writes what the JAX
package's checkpoint writer writes (keys sorted, oversized arrays chunked),
and :func:`read_file` / :func:`write_file` are the file-level calls.  Tuples and lists are msgpack arrays; bfloat16 arrays, which numpy
cannot hold, are refused by name.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# encoding (msgpack-python's Packer with use_bin_type=True)
# ---------------------------------------------------------------------------


def _int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out += struct.pack(">b", n)
    elif 0x80 <= n <= 0xFF:
        out += struct.pack(">BB", 0xCC, n)
    elif -0x80 <= n < 0:
        out += struct.pack(">Bb", 0xD0, n)
    elif 0xFF < n <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, n)
    elif -0x8000 <= n < -0x80:
        out += struct.pack(">Bh", 0xD1, n)
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, n)
    elif -0x80000000 <= n < -0x8000:
        out += struct.pack(">Bi", 0xD2, n)
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += struct.pack(">Bq", 0xD3, n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(out: bytearray, n: int, fix: int | None, fix_max: int, forms) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``forms`` ((code, struct format, max)) that holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, most in forms:
        if n <= most:
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext(out: bytearray, code: int, data) -> None:
    n = len(data)
    if n in _FIXEXT:
        out += struct.pack(">Bb", _FIXEXT[n], code)
    elif n <= 0xFF:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: packb((shape, dtype.name, C-order bytes))."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return encode((tuple(int(s) for s in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif isinstance(x, int):
        _int(out, int(x))
    elif isinstance(x, float):
        out += struct.pack(">Bd", 0xCB, x)
    elif isinstance(x, complex):
        _ext(out, EXT_COMPLEX, encode((x.real, x.imag)))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _sized(out, len(b), 0xA0, 0x1F, _STR)
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _sized(out, len(b), None, -1, _BIN)
        out += b
    elif isinstance(x, (list, tuple)):
        _sized(out, len(x), 0x90, 0x0F, _ARRAY)
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _sized(out, len(x), 0x80, 0x0F, _MAP)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def encode(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` (maps in their own key order, numpy arrays
    and scalars as flax's extension types)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax ``_chunk``: a flat array in pieces of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _canonical(tree: Any) -> Any:
    """The tree that writer packs: maps with their keys sorted as a JAX
    pytree sorts them, oversized arrays chunked."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """What the JAX package's checkpoint writer, ``flax.serialization.to_bytes(
    jax.device_get(tree))``, writes for a tree of dicts of numpy arrays and
    Python scalars."""
    return encode(_canonical(tree))


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def read(self, views: bool = False) -> Any:
        """The one value the buffer holds (bin values as views of it when
        ``views``, else bytes)."""
        value = _read(self, views)
        if self.pos != len(self.buf):
            raise ValueError(f"{len(self.buf) - self.pos} bytes after the msgpack value")
        return value


_FIXED = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i",
          0xD3: "q", 0xCA: "f", 0xCB: "d"}
_LEN = {0xD9: "B", 0xDA: "H", 0xDB: "I", 0xC4: "B", 0xC5: "H", 0xC6: "I", 0xDC: "H",
        0xDD: "I", 0xDE: "H", 0xDF: "I", 0xC7: "B", 0xC8: "H", 0xC9: "I"}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        raise NotImplementedError("bfloat16 arrays in flax checkpoints are not supported "
                                  "(numpy has no bfloat16)")
    return np.dtype(name)


def _from_ext(code: int, data: memoryview) -> Any:
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, name, raw = _Reader(data).read(views=True)
        arr = np.frombuffer(raw, dtype=_dtype(name)).reshape(shape, order="C")
        return arr[()] if code == EXT_NPSCALAR else arr
    if code == EXT_COMPLEX:
        re, im = _Reader(data).read()
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code} is not one of flax's")


def _read(r: _Reader, views: bool = False) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r, views) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _LEN:
        n = r.unpack(_LEN[b])
        if b in (0xD9, 0xDA, 0xDB):
            return str(r.take(n), "utf-8")
        if b in (0xC4, 0xC5, 0xC6):
            return r.take(n) if views else bytes(r.take(n))
        if b in (0xDC, 0xDD):
            return [_read(r, views) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _map(r, n)
        code = r.unpack("b")
        return _from_ext(code, r.take(n))
    if b in _FIXEXT_LEN:
        code = r.unpack("b")
        return _from_ext(code, r.take(_FIXEXT_LEN[b]))
    raise ValueError(f"invalid msgpack byte 0x{b:02x} at offset {r.pos - 1}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _unchunk(tree: Any) -> Any:
    """flax ``_unchunk_array_leaves_in_place``: chunked arrays back to arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def decode(data) -> Any:
    """The tree of a flax msgpack file's bytes, as ``msgpack_restore``
    returns it: dicts in the file's key order, numpy arrays as read-only
    views of ``data``, chunked arrays joined."""
    return _unchunk(_Reader(bytes(data)).read())


def read_file(path: str) -> Any:
    """:func:`decode` of a file."""
    with open(path, "rb") as f:
        return decode(f.read())


def write_file(path: str, tree: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(tree))
