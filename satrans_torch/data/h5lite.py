"""A small HDF5 writer and reader in numpy, for machines without ``h5py``.

``data/io.py`` uses ``h5py`` where it is installed and this module where
it is not (the card's machine has no ``h5py``), so that the raw AliCCP
and Alimama preprocessing and the CLI's loaders run there on the same
``alicpp.h5`` / ``alimama.h5`` schema.  It writes the subset of HDF5 that
schema needs, and reads back what it writes:

* superblock version 2, object headers version 2 (Jenkins lookup3
  checksums), groups as compact link messages (new-style groups);
* datasets of little-endian integers (1 to 8 bytes) and float32/float64,
  any rank, contiguous.

A file it writes is a valid HDF5 file that ``h5py`` reads (the tests
check this).  It does not read files written by the HDF5 library
(superblock 0, symbol-table groups): those need ``h5py``.  A tree is a
dict of names to arrays or to dicts (groups).  The whole file is
rewritten on every change, which suits files of tens of MB.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF
# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK, _LAYOUT, _GROUP_INFO = \
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A
_OHDR_PREFIX = 4 + 1 + 1 + 4  # "OHDR", version, flags, 4-byte chunk size


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, HDF5's metadata checksum
    (``H5_checksum_lookup3``)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    i = 0
    while n - i > 12:
        x, y, z = struct.unpack_from("<3I", data, i)
        a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4); c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6); a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8); b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16); c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19); a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4); b = (b + a) & _M32
        i += 12
    if n == i:
        return c
    x, y, z = struct.unpack("<3I", data[i:] + bytes(12 - (n - i)))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c = (c ^ b) - _rot(b, 14) & _M32
    a = (a ^ c) - _rot(c, 11) & _M32
    b = (b ^ a) - _rot(a, 25) & _M32
    c = (c ^ b) - _rot(b, 16) & _M32
    a = (a ^ c) - _rot(c, 4) & _M32
    b = (b ^ a) - _rot(a, 14) & _M32
    c = (c ^ b) - _rot(b, 24) & _M32
    return c


# ----------------------------------------------------------------- writing

def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    return struct.pack("<BHB", mtype, len(body), flags) + body


def _object_header(messages: bytes) -> bytes:
    # flags 2: the size of chunk #0 takes 4 bytes; no times, no attributes
    head = b"OHDR" + struct.pack("<BBI", 2, 2, len(messages)) + messages
    return head + struct.pack("<I", lookup3(head))


def _datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = 0x08 if dtype.kind == "i" else 0x00  # bit 3: signed
        return struct.pack("<B3BI2H", 0x10, bits, 0, 0, size, 0, 8 * size)
    # IEEE floats: implied mantissa msb (bits 4-5 = 2), the sign's bit
    exp_size, mant = {4: (8, 23), 8: (11, 52)}[size]
    return struct.pack("<B3BI2H4BI", 0x11, 0x20, 8 * size - 1, 0, size, 0,
                       8 * size, mant, exp_size, 0, mant,
                       2 ** (exp_size - 1) - 1)


def _check_dtype(arr: np.ndarray) -> np.ndarray:
    dt = arr.dtype
    if dt.kind in "iu" or (dt.kind == "f" and dt.itemsize in (4, 8)):
        return np.ascontiguousarray(arr, dtype=dt.newbyteorder("<"))
    raise TypeError(f"h5lite stores integers and float32/float64, got {dt}")


def _dataset_header(arr: np.ndarray, addr: int) -> bytes:
    space = struct.pack(f"<4B{arr.ndim}Q", 2, arr.ndim, 0, 1, *arr.shape)
    layout = struct.pack("<BBQQ", 3, 1, addr if arr.nbytes else _UNDEF,
                         arr.nbytes)
    # fill value: allocated late, written if set, no value of its own
    return _object_header(
        _message(_DATASPACE, space) + _message(_DATATYPE,
                                               _datatype(arr.dtype), 1)
        + _message(_FILL, struct.pack("<BB", 3, 0x0A), 1)
        + _message(_LAYOUT, layout))


def _group_size(names) -> int:
    links = sum(4 + 3 + len(n.encode()) + 8 for n in names)
    return _OHDR_PREFIX + (4 + 18) + (4 + 2) + links + 4


def _dataset_size(arr: np.ndarray) -> int:
    dtype = 12 if arr.dtype.kind in "iu" else 20
    return _OHDR_PREFIX + (4 + 4 + 8 * arr.ndim) + (4 + dtype) + (4 + 2) \
        + (4 + 18) + 4


def _group_header(links: dict[str, int]) -> bytes:
    msgs = _message(_LINK_INFO, struct.pack("<BBQQ", 0, 0, _UNDEF, _UNDEF))
    msgs += _message(_GROUP_INFO, struct.pack("<BB", 0, 0))
    for name, addr in links.items():
        raw = name.encode()
        if not 0 < len(raw) < 256 or "/" in name:
            raise ValueError(f"h5lite link name {name!r}")
        msgs += _message(_LINK, struct.pack("<BBB", 1, 0, len(raw)) + raw
                         + struct.pack("<Q", addr))
    return _object_header(msgs)


def write(path: str, tree: dict) -> None:
    """Write the tree ``{name: array or dict}`` as the HDF5 file ``path``
    (replaced atomically)."""
    chunks: list[tuple[int, bytes | np.ndarray]] = []
    end = 48

    def place(node) -> int:
        nonlocal end
        addr = end
        if isinstance(node, dict):
            end += _group_size(node)
            links = {name: place(child) for name, child in node.items()}
            chunks.append((addr, _group_header(links)))
            return addr
        arr = _check_dtype(np.asarray(node))
        end += _dataset_size(arr)
        data = (end + 7) // 8 * 8
        end = data + arr.nbytes
        chunks.append((addr, _dataset_header(arr, data)))
        chunks.append((data, arr))
        return addr

    root = place(tree)
    head = _SIGNATURE + struct.pack("<4B4Q", 2, 8, 8, 0, 0, _UNDEF, end,
                                    root)
    chunks.append((0, head + struct.pack("<I", lookup3(head))))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        for addr, data in sorted(chunks, key=lambda c: c[0]):
            f.seek(addr)
            f.write(data.tobytes() if isinstance(data, np.ndarray) else data)
        f.truncate(end)
    os.replace(tmp, path)


# ----------------------------------------------------------------- reading

class _Leaf:
    """A dataset's place in its file."""

    def __init__(self, dtype, shape, addr):
        self.dtype, self.shape, self.addr = dtype, shape, addr

    def read(self, f) -> np.ndarray:
        count = int(np.prod(self.shape))
        if count == 0:
            return np.zeros(self.shape, self.dtype)
        f.seek(self.addr)
        return np.fromfile(f, self.dtype, count).reshape(self.shape)


def _parse_dtype(body: bytes) -> np.dtype:
    cls, bits, size = body[0] & 0x0F, body[1], struct.unpack_from(
        "<I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8):
        return np.dtype(f"{order}f{size}")
    raise ValueError(f"h5lite reads integer and float datasets, not class "
                     f"{cls} of {size} bytes")


def _parse(f, addr: int):
    f.seek(addr)
    pre = f.read(6)
    if pre[:4] != b"OHDR" or pre[4] != 2:
        raise ValueError("h5lite reads the object headers it writes "
                         "(version 2); this file needs h5py")
    flags = pre[5]
    skip = (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    f.read(skip)
    width = 1 << (flags & 3)
    size = int.from_bytes(f.read(width), "little")
    body = f.read(size)
    links, shape, dtype, data = {}, None, None, None
    i = 0
    while i + 4 <= len(body):
        mtype, msize = struct.unpack_from("<BH", body, i)
        i += 4 + (2 if flags & 0x04 else 0)
        msg = body[i:i + msize]
        i += msize
        if mtype == _LINK:
            lflags = msg[1]
            j = 2 + (1 if lflags & 0x08 else 0) + (8 if lflags & 0x04 else 0) \
                + (1 if lflags & 0x10 else 0)
            if lflags & 0x08 and msg[2] != 0:
                raise ValueError("h5lite reads hard links only")
            nlen_w = 1 << (lflags & 3)
            nlen = int.from_bytes(msg[j:j + nlen_w], "little")
            j += nlen_w
            name = msg[j:j + nlen].decode()
            links[name] = struct.unpack_from("<Q", msg, j + nlen)[0]
        elif mtype == _DATASPACE:
            ndim = msg[1]
            shape = struct.unpack_from(f"<{ndim}Q", msg, 4 if msg[0] == 2
                                       else 8)
        elif mtype == _DATATYPE:
            dtype = _parse_dtype(msg)
        elif mtype == _LAYOUT:
            if msg[0] != 3 or msg[1] != 1:
                raise ValueError("h5lite reads contiguous datasets only")
            data = struct.unpack_from("<Q", msg, 2)[0]
        elif mtype == 0x10:
            raise ValueError("h5lite reads single-chunk object headers only")
    if data is not None:
        return _Leaf(dtype, tuple(int(s) for s in shape), data)
    return {name: _parse(f, a) for name, a in links.items()}


def index(path: str) -> dict:
    """The tree of ``path`` with a :class:`_Leaf` for each dataset."""
    with open(path, "rb") as f:
        head = f.read(48)
        if head[:8] != _SIGNATURE:
            raise ValueError(f"{path} is not an HDF5 file")
        if head[8] not in (2, 3):
            raise ValueError(f"{path} was written by the HDF5 library "
                             f"(superblock {head[8]}): reading it needs "
                             "h5py")
        return _parse(f, struct.unpack_from("<Q", head, 36)[0])


def read(path: str, tree: dict | None = None) -> dict:
    """The tree of ``path`` (or of its :func:`index` ``tree``, a sub-tree
    of it) with every dataset read."""
    tree = index(path) if tree is None else tree
    with open(path, "rb") as f:
        def load(node):
            if isinstance(node, dict):
                return {k: load(v) for k, v in node.items()}
            return node.read(f)
        return load(tree)
