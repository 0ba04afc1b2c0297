"""A reader of OCDBT databases, the key-value store in which Orbax writes a
checkpoint's arrays (``<step>/default/``): tensorstore's "optionally
cooperative distributed B+tree", read without tensorstore.

Layout, as the committed checkpoints hold it:
- ``manifest.ocdbt``: the config (uuid, manifest kind, value and node
  limits, compression) and the version list, each version naming the root
  node of a B+tree by (data file, offset, length, height);
- B+tree nodes: interior nodes (height > 0) hold per child the least key
  and the key prefix all of the child's keys share; leaves hold keys and
  values, inline or as a (data file, offset, length) reference;
- keys inside a node are prefix-compressed against the previous key, and
  a node's keys leave out the prefix its parent says they share;
- data files (``d/...``, ``ocdbt.process_0/d/...``) hold values and nodes
  back to back.

Every manifest and node is a file (or a byte range of a data file) of the
form: 4-byte magic (big-endian), u64 total length, varint version (0),
varint compression (0 none, 1 zstd), the body, and the CRC-32C of all the
bytes before it.  Each of those is checked.
"""
from __future__ import annotations

import bisect
import os
from typing import Dict, List, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_ROOT = (1 << 64) - 1            # the root offset of an empty tree


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore writes after each node."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class Cursor:
    """Reads the fields of a decoded body; ``name`` goes into errors."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def fail(self, msg: str):
        raise ValueError(f"ocdbt: {msg} at byte {self.pos} of {self.name}")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"truncated ({n} bytes wanted)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def prefixed_strings(self, n: int, extra: Optional[List[int]] = None
                         ) -> List[bytes]:
        """``n`` byte strings stored as lengths of the prefix shared with
        the previous one (n - 1 of them), suffix lengths, [``extra``
        columns read in between, when given a list to fill], suffixes."""
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        if extra is not None:
            extra.extend(self.varints(n))
        out, prev = [], b""
        for p, s in zip(prefix, suffix):
            if p > len(prev):
                self.fail("key prefix longer than the previous key")
            prev = prev[:p] + self.take(s)
            out.append(prev)
        return out


def unwrap(raw: bytes, magic: int, name: str) -> bytes:
    """Check the header and CRC-32C trailer of a manifest or node; return
    its decoded body."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {name} is {len(raw)} bytes, too short")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"ocdbt: {name} has magic {got:#010x}, expected "
                         f"{magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"ocdbt: {name} says {length} bytes, holds "
                         f"{len(raw)}")
    want = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != want:
        raise ValueError(f"ocdbt: CRC-32C mismatch in {name}")
    head = Cursor(raw[:-4], name)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        head.fail(f"format version {version}")
    body = raw[head.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        head.fail(f"compression {compression}")
    return body


def data_file_table(cur: Cursor) -> List[str]:
    """The data files a node or manifest refers to by index: paths relative
    to the database directory (base path and relative path joined)."""
    n = cur.varint()
    base: List[int] = []
    paths = cur.prefixed_strings(n, base)
    for p, b in zip(paths, base):
        if b > len(p):
            cur.fail("base path longer than its path")
    return [p.decode("utf-8") for p in paths]


class OcdbtReader:
    """Reads the newest version of the OCDBT database in ``root``.

    ``keys()`` lists every key; ``read(key)`` returns its value, reading
    only the node files on its path and the byte range it refers to."""

    def __init__(self, root: str):
        self.root = root
        name = os.path.join(root, "manifest.ocdbt")
        with open(name, "rb") as f:
            cur = Cursor(unwrap(f.read(), MANIFEST_MAGIC, name), name)
        cur.take(16)                                    # uuid
        if cur.varint() != 0:
            cur.fail("numbered manifests are not read")
        cur.varint()                                    # max inline value
        cur.varint()                                    # max decoded node
        cur.byte()                                      # version arity
        compression = cur.varint()
        if compression == 1:
            cur.take(4)                                 # zstd level
        elif compression != 0:
            cur.fail(f"compression method {compression}")
        files = data_file_table(cur)
        n = cur.varint()
        if n == 0:
            cur.fail("manifest has no version")
        gens = cur.varints(n)
        heights = list(cur.take(n))
        columns = [cur.varints(n) for _ in range(6)]    # file, offset,
        newest = max(range(n), key=gens.__getitem__)    # length, keys, ...
        fid, offset, length = (c[newest] for c in columns[:3])
        self.generation = gens[newest]
        self.root_ref = None
        if offset != NO_ROOT:
            if fid >= len(files):
                cur.fail(f"data file {fid} of {len(files)}")
            self.root_ref = (files[fid], offset, length, heights[newest])
        self._nodes: Dict[Tuple[str, int], tuple] = {}

    def _read_range(self, path: str, offset: int, length: int) -> bytes:
        name = os.path.join(self.root, path)
        with open(name, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"ocdbt: {name} ends before byte "
                             f"{offset + length}")
        return data

    def _node(self, ref) -> tuple:
        """A node as ``(height, keys, entries)``: for an interior node each
        entry is (child ref, common prefix length of its subtree), for a
        leaf (inline value) or (path, offset, length)."""
        path, offset, length, height = ref
        key = (path, offset)
        if key in self._nodes:
            return self._nodes[key]
        name = f"{path}@{offset}"
        cur = Cursor(unwrap(self._read_range(path, offset, length),
                            NODE_MAGIC, name), name)
        got = cur.byte()
        if got != height:
            cur.fail(f"node of height {got}, its parent says {height}")
        files = data_file_table(cur)
        n = cur.varint()

        def file(i: int) -> str:
            if i >= len(files):
                cur.fail(f"data file {i} of {len(files)}")
            return files[i]

        if height > 0:
            common: List[int] = []
            keys = cur.prefixed_strings(n, common)
            fids, offs, lens = (cur.varints(n) for _ in range(3))
            for _ in range(3):                          # subtree counts
                cur.varints(n)
            entries = [((file(f), o, ln, height - 1), c)
                       for f, o, ln, c in zip(fids, offs, lens, common)]
        else:
            keys = cur.prefixed_strings(n)
            lens = cur.varints(n)
            kinds = cur.varints(n)
            if any(k > 1 for k in kinds):
                cur.fail("value kind other than inline or indirect")
            indirect = [i for i in range(n) if kinds[i] == 1]
            fids = cur.varints(len(indirect))
            offs = cur.varints(len(indirect))
            entries: List[object] = [None] * n
            for i, f, o in zip(indirect, fids, offs):
                entries[i] = (file(f), o, lens[i])
            for i in range(n):
                if kinds[i] == 0:
                    entries[i] = cur.take(lens[i])
        if cur.pos != len(cur.data):
            cur.fail("bytes left after the node's entries")
        node = (height, keys, entries)
        self._nodes[key] = node
        return node

    def keys(self) -> List[str]:
        out: List[str] = []

        def walk(ref, prefix: bytes):
            height, keys, entries = self._node(ref)
            for k, e in zip(keys, entries):
                if height > 0:
                    child, common = e
                    walk(child, (prefix + k)[:len(prefix) + common])
                else:
                    out.append((prefix + k).decode("utf-8"))

        if self.root_ref is not None:
            walk(self.root_ref, b"")
        return out

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` when the database lacks it."""
        want = key.encode("utf-8")
        ref, prefix = self.root_ref, b""
        while ref is not None:
            height, keys, entries = self._node(ref)
            if not want.startswith(prefix):
                break
            rest = want[len(prefix):]
            if height == 0:
                i = bisect.bisect_left(keys, rest)
                if i == len(keys) or keys[i] != rest:
                    break
                value = entries[i]
                if isinstance(value, bytes):
                    return value
                return self._read_range(*value)
            i = bisect.bisect_right(keys, rest) - 1
            if i < 0:
                break
            ref, common = entries[i]
            prefix = (prefix + keys[i])[:len(prefix) + common]
        raise KeyError(key)
