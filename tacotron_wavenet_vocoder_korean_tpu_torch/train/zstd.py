"""A Zstandard frame decoder in Python and numpy (RFC 8878, without
dictionaries), for the checkpoint reader.

Orbax writes every OCDBT node and every zarr chunk of a checkpoint as a
zstd frame; the machines that serve the port have no zstd module, so the
port decodes the frames itself.  Covered: concatenated and skippable
frames; raw, RLE and compressed blocks; literals that are raw, RLE,
Huffman-coded (one or four streams) or treeless (the previous block's
Huffman table); Huffman weights given directly or FSE-compressed; the
sequence tables of the three codes in predefined, RLE, FSE-compressed and
repeat modes; the three repeat offsets; the single-segment flag and window
descriptor; the content checksum (XXH64, always checked when present).

Every malformed input raises ``ValueError`` naming the byte offset in the
input where the fault was found: reserved bits set, a dictionary id,
truncated input, a bitstream not ending on its padding bit or not used up
exactly, an offset reaching before the frame's start or past its window, a
decoded size that disagrees with the frame's content-size field.

A frame is decoded into one growing buffer, so the window size only bounds
offsets.  Huffman streams are decoded with a lookup table of ``max_bits``
bits, applied with numpy at every bit position of the stream; a Python
loop then follows the chain of code positions 16 codes at a time.
"""
from __future__ import annotations

import array
import functools
from typing import List, Optional, Tuple

import numpy as np

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50          # the low 4 bits are free
MAX_BLOCK = 128 * 1024

# Predefined distributions and accuracy logs of the sequence codes
# (RFC 8878, 3.1.1.3.2.2).
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
LL_MAX_LOG, ML_MAX_LOG, OF_MAX_LOG = 9, 9, 8
LL_MAX_SYMBOL, ML_MAX_SYMBOL, OF_MAX_SYMBOL = 35, 52, 31

# (baseline, extra bits) of each literal-length and match-length code.
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]


def fail(msg: str, offset: int):
    raise ValueError(f"zstd: {msg} at byte {offset}")


# ---------------------------------------------------------------------------
# XXH64, for the content checksum
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the reference algorithm, 64-bit lanes)."""
    n, i = len(data), 0
    if n >= 32:
        acc = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
               (seed - _P1) & _M64]
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).tolist()
        for j in range(0, len(lanes), 4):
            acc = [_round(a, x) for a, x in zip(acc, lanes[j:j + 4])]
        h = (_rotl(acc[0], 1) + _rotl(acc[1], 7) + _rotl(acc[2], 12)
             + _rotl(acc[3], 18)) & _M64
        for a in acc:
            h = ((h ^ _round(0, a)) * _P1 + _P4) & _M64
        i = (n // 32) * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[i:i + 8], "little")),
                   27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * _P1 & _M64),
                   23) * _P2 + _P3) & _M64
        i += 4
    for b in data[i:]:
        h = (_rotl(h ^ (b * _P5 & _M64), 11) * _P1) & _M64
    h = ((h ^ (h >> 33)) * _P2) & _M64
    h = ((h ^ (h >> 29)) * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# Bitstreams
# ---------------------------------------------------------------------------

def _stream_bits(data: bytes, where: int) -> int:
    """Bits of a backward bitstream below its padding: the highest set bit
    of the last byte marks the end."""
    if not data:
        fail("empty bitstream", where)
    last = data[-1]
    if last == 0:
        fail("bitstream does not end on its padding bit",
             where + len(data) - 1)
    return 8 * len(data) - 9 + last.bit_length()


class BackwardBits:
    """Reads a backward bitstream from its end: ``pos`` is the count of
    unread bits; bits read past the start are zeros and leave ``pos``
    negative (an overflow, which the callers check)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, where: int):
        self.data = bytes(data) + b"\0" * 8
        self.pos = _stream_bits(data, where)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p < 0:
            v = int.from_bytes(self.data[:8], "little") << -p
        else:
            v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8],
                               "little") >> (p & 7)
        return v & ((1 << n) - 1)


class ForwardBits:
    """Reads a little-endian forward bitstream (FSE table descriptions)."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.bit, self.end = data, 8 * start, end

    def peek(self, n: int) -> int:
        lo = self.bit >> 3
        v = int.from_bytes(self.data[lo:lo + 8], "little") >> (self.bit & 7)
        return v & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.bit > 8 * self.end:
            fail("FSE table description truncated", self.end)

    def byte_end(self) -> int:
        return (self.bit + 7) >> 3


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------

def read_fse_counts(data: bytes, start: int, end: int, max_log: int,
                    max_symbol: int) -> Tuple[List[int], int, int]:
    """An FSE table description at ``data[start:end]`` -> (normalized
    counts, accuracy log, offset after the description)."""
    bits = ForwardBits(data, start, end)
    if start >= end:
        fail("FSE table description truncated", start)
    log = bits.peek(4) + 5
    bits.skip(4)
    if log > max_log:
        fail(f"FSE accuracy log {log} above {max_log}", start)
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            fail("FSE table has too many symbols", bits.bit >> 3)
        peek = bits.peek(nbits)
        big = 2 * threshold - 1 - remaining
        if (peek & (threshold - 1)) < big:
            count = peek & (threshold - 1)
            bits.skip(nbits - 1)
        else:
            count = peek & (2 * threshold - 1)
            if count >= threshold:
                count -= big
            bits.skip(nbits)
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:                    # runs of zero counts follow
            while True:
                rep = bits.peek(2)
                bits.skip(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        fail("FSE table description is corrupt", bits.bit >> 3)
    return counts, log, bits.byte_end()


def build_fse_table(counts: List[int], log: int, where: int = 0
                    ) -> Tuple[List[int], List[int], List[int]]:
    """Decoding table of an FSE distribution (described at byte ``where``):
    per state (symbol, bits to read, baseline of the next state)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    for s, c in enumerate(counts):          # "less than 1" at the top
        if c == -1:
            symbols[high] = s
            high -= 1
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        fail("FSE distribution does not fill its table", where)
    nxt = [1 if c == -1 else c for c in counts]
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbols[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return symbols, nbits, base


def rle_table(symbol: int) -> Tuple[List[int], List[int], List[int]]:
    return [symbol], [0], [0]


@functools.lru_cache(maxsize=None)
def predefined_table(kind: str):
    counts, log = {"ll": LL_DEFAULT, "ml": ML_DEFAULT, "of": OF_DEFAULT}[kind]
    return build_fse_table(counts, log), log


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------

class HuffmanTable:
    """A Huffman decoding table of ``max_bits`` bits: symbol and code
    length for each ``max_bits``-bit prefix."""

    def __init__(self, weights: List[int], where: int):
        if not weights or len(weights) > 255:
            fail("bad Huffman weight count", where)
        if max(weights) > 11:
            fail("Huffman weight above 11", where)
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            fail("Huffman weights are all zero", where)
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            fail("Huffman weights do not complete a tree", where)
        if max_bits > 11:
            fail(f"Huffman code of {max_bits} bits", where)
        w = np.asarray(weights + [rest.bit_length()], np.int64)
        # Prefixes go to the lowest weight first, then the lowest symbol;
        # a symbol of weight w owns 2^(w-1) consecutive prefixes.
        order = np.lexsort((np.arange(len(w)), w))
        order = order[w[order] > 0]
        cells = 1 << (w[order] - 1)
        self.max_bits = max_bits
        self.symbols = np.repeat(order, cells).astype(np.uint8)
        self.lengths = np.repeat(max_bits + 1 - w[order], cells)

    def decode_stream(self, data: bytes, count: int, where: int) -> np.ndarray:
        """``count`` symbols of one backward Huffman stream, which must be
        used up exactly.

        Every bit position p of the stream gets the code that starts there
        (the ``max_bits`` bits below p) and the position after it; the
        chain of positions from the end is then followed in steps of
        ``_STEP`` codes by a Python loop and filled in with numpy."""
        total = _stream_bits(data, where)
        mb = self.max_bits
        d = np.frombuffer(b"\0\0" + bytes(data) + b"\0\0", np.uint8).astype(
            np.intp)
        win = d[:-2] | (d[1:-1] << 8) | (d[2:] << 16)
        # Bit p - mb of the stream is bit p - mb + 16 of ``d``.
        sp = np.arange(16 - mb, total + 17 - mb, dtype=np.intp)
        peek = (np.take(win, sp >> 3) >> (sp & 7)) & ((1 << mb) - 1)
        # Chain positions are q = p + 1; q = 0 is a dead state, where a
        # code would read past the start of the stream.
        jump = np.zeros(total + 2, np.intp)
        jump[1:] = np.maximum(sp + (mb - 15) - np.take(self.lengths, peek),
                              0)
        far = jump
        for _ in range(_STEP.bit_length() - 1):
            far = np.take(far, far)
        far = array.array("q", far.tobytes())
        rows = -(-count // _STEP)
        starts = [0] * rows
        q = total + 1
        for k in range(rows):
            starts[k] = q
            q = far[q]
        chain = np.empty((_STEP, rows), np.intp)
        chain[0] = starts
        for c in range(1, _STEP):
            np.take(jump, chain[c - 1], out=chain[c])
        chain = chain.T.reshape(-1)[:count]
        end = jump[chain[-1]] if count else total + 1
        if end != 1 or (count and not chain.all()):
            fail("Huffman stream not used up exactly", where)
        return np.take(self.symbols, np.take(peek, chain - 1))


_STEP = 16                                # a power of two


def read_huffman_table(data: bytes, start: int, end: int
                       ) -> Tuple[HuffmanTable, int]:
    """A Huffman tree description -> (table, offset after it)."""
    if start >= end:
        fail("Huffman tree description truncated", start)
    head = data[start]
    if head >= 128:                       # direct 4-bit weights
        n = head - 127
        stop = start + 1 + (n + 1) // 2
        if stop > end:
            fail("Huffman weights truncated", start)
        packed = data[start + 1:stop]
        weights = [(packed[i // 2] >> (4 if i % 2 == 0 else 0)) & 15
                   for i in range(n)]
        return HuffmanTable(weights, start), stop
    stop = start + 1 + head
    if stop > end:
        fail("Huffman weights truncated", start)
    counts, log, body = read_fse_counts(data, start + 1, stop, 6, 255)
    symbols, nbits, base = build_fse_table(counts, log, start + 1)
    bits = BackwardBits(data[body:stop], body)
    states = [bits.read(log), bits.read(log)]
    weights: List[int] = []
    turn = 0
    while True:                           # two interleaved states
        if len(weights) > 255:
            fail("too many Huffman weights", body)
        s = states[turn]
        weights.append(symbols[s])
        states[turn] = base[s] + bits.read(nbits[s])
        if bits.pos < 0:
            weights.append(symbols[states[1 - turn]])
            break
        turn = 1 - turn
    return HuffmanTable(weights, start), stop


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

class _FrameState:
    """What a frame's blocks hand on to the next: the Huffman table, the
    three sequence tables and the repeat offsets."""

    def __init__(self):
        self.huffman: Optional[HuffmanTable] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _FrameState
              ) -> Tuple[bytes, int]:
    """The literals section of a compressed block -> (literals, offset of
    the sequences section)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                    # raw or RLE
        head = {0: 1, 2: 1, 1: 2, 3: 3}[fmt]
        if pos + head > end:
            fail("literals header truncated", pos)
        v = int.from_bytes(data[pos:pos + head], "little")
        size = v >> 3 if fmt in (0, 2) else v >> 4
        pos += head
        if kind == 0:
            if pos + size > end:
                fail("raw literals truncated", pos)
            return data[pos:pos + size], pos + size
        if pos >= end:
            fail("RLE literals truncated", pos)
        return bytes([data[pos]]) * size, pos + 1
    head, bits, streams = {0: (3, 10, 1), 1: (3, 10, 4), 2: (4, 14, 4),
                           3: (5, 18, 4)}[fmt]
    if pos + head > end:
        fail("literals header truncated", pos)
    v = int.from_bytes(data[pos:pos + head], "little")
    regen = (v >> 4) & ((1 << bits) - 1)
    comp = (v >> (4 + bits)) & ((1 << bits) - 1)
    start = pos + head
    stop = start + comp
    if stop > end:
        fail("compressed literals truncated", start)
    if regen > MAX_BLOCK:
        fail("literals larger than a block", pos)
    if kind == 2:
        st.huffman, start = read_huffman_table(data, start, stop)
    elif st.huffman is None:
        fail("treeless literals with no previous Huffman table", pos)
    table = st.huffman
    if streams == 1:
        return table.decode_stream(data[start:stop], regen,
                                   start).tobytes(), stop
    if start + 6 > stop:
        fail("literal jump table truncated", start)
    s1, s2, s3 = (int.from_bytes(data[start + 2 * i:start + 2 * i + 2],
                                 "little") for i in range(3))
    bounds = [start + 6, start + 6 + s1, start + 6 + s1 + s2,
              start + 6 + s1 + s2 + s3, stop]
    if bounds[3] > stop:
        fail("literal streams overrun their section", start)
    per = (regen + 3) // 4
    counts = [per, per, per, regen - 3 * per]
    if counts[3] < 0:
        fail("too few literals for four streams", pos)
    out = [table.decode_stream(data[bounds[i]:bounds[i + 1]], counts[i],
                               bounds[i]) for i in range(4)]
    return np.concatenate(out).tobytes(), stop


def _sequence_table(data: bytes, pos: int, end: int, mode: int, kind: str,
                    st: _FrameState) -> int:
    max_log, max_sym = {"ll": (LL_MAX_LOG, LL_MAX_SYMBOL),
                        "ml": (ML_MAX_LOG, ML_MAX_SYMBOL),
                        "of": (OF_MAX_LOG, OF_MAX_SYMBOL)}[kind]
    if mode == 0:
        st.tables[kind] = predefined_table(kind)
    elif mode == 1:
        if pos >= end:
            fail("RLE sequence code truncated", pos)
        if data[pos] > max_sym:
            fail(f"RLE {kind} code {data[pos]} out of range", pos)
        st.tables[kind] = (rle_table(data[pos]), 0)
        pos += 1
    elif mode == 2:
        counts, log, after = read_fse_counts(data, pos, end, max_log,
                                             max_sym)
        st.tables[kind] = (build_fse_table(counts, log, pos), log)
        pos = after
    elif st.tables[kind] is None:
        fail(f"repeat mode with no previous {kind} table", pos)
    return pos


def _sequences(data: bytes, pos: int, end: int, lits: bytes, out: bytearray,
               frame_start: int, window: int, st: _FrameState) -> None:
    """Decode and execute the sequences section ``data[pos:end]``,
    appending to ``out``."""
    if pos >= end:
        fail("sequences section truncated", pos)
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            fail("bytes after an empty sequences section", pos + 1)
        out += lits
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            fail("sequence count truncated", pos)
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            fail("sequence count truncated", pos)
        nseq = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00
        pos += 3
    if pos >= end:
        fail("sequence modes truncated", pos)
    modes = data[pos]
    if modes & 3:
        fail("reserved bits set in the sequence modes", pos)
    pos += 1
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _sequence_table(data, pos, end, (modes >> shift) & 3, kind, st)
    bits = BackwardBits(data[pos:end], pos)
    read = bits.read
    (ll_sym, ll_nb, ll_base), ll_log = st.tables["ll"]
    (of_sym, of_nb, of_base), of_log = st.tables["of"]
    (ml_sym, ml_nb, ml_base), ml_log = st.tables["ml"]
    ll_state, of_state, ml_state = read(ll_log), read(of_log), read(ml_log)
    r1, r2, r3 = st.reps
    lit = 0
    nlits = len(lits)
    for i in range(nseq):
        of_code = of_sym[of_state]
        ll_base_v, ll_extra = LL_CODES[ll_sym[ll_state]]
        ml_base_v, ml_extra = ML_CODES[ml_sym[ml_state]]
        if of_code > 31:
            fail(f"offset code {of_code} out of range", pos)
        of_value = (1 << of_code) + read(of_code)
        ml = ml_base_v + read(ml_extra)
        ll = ll_base_v + read(ll_extra)
        if of_value > 3:
            r1, r2, r3 = of_value - 3, r1, r2
        else:
            idx = of_value - 1 + (ll == 0)
            if idx == 1:
                r1, r2 = r2, r1
            elif idx == 2:
                r1, r2, r3 = r3, r1, r2
            elif idx == 3:
                r1, r2, r3 = r1 - 1, r1, r2
        if i + 1 < nseq:
            ll_state = ll_base[ll_state] + read(ll_nb[ll_state])
            ml_state = ml_base[ml_state] + read(ml_nb[ml_state])
            of_state = of_base[of_state] + read(of_nb[of_state])
        if bits.pos < 0:
            fail("sequence bitstream overrun", pos)
        if lit + ll > nlits:
            fail("sequence takes more literals than the block has", pos)
        out += lits[lit:lit + ll]
        lit += ll
        off = r1
        have = len(out) - frame_start
        if off == 0 or off > have or off > window:
            fail(f"match offset {off} reaches outside the window", pos)
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:                             # the match overlaps its output
            reps, rest = divmod(ml, off)
            piece = out[start:]
            out += piece * reps + piece[:rest]
    if bits.pos != 0:
        fail("sequence bitstream not used up exactly", pos)
    st.reps = [r1, r2, r3]
    out += lits[lit:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame at ``data[pos:]`` into ``out``; returns the offset
    after the frame."""
    n = len(data)
    frame_start = len(out)
    at = pos + 4
    if at >= n:
        fail("frame header truncated", at)
    fhd = data[at]
    fcs_flag, single, check, did_flag = (fhd >> 6, (fhd >> 5) & 1,
                                         (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        fail("reserved bit set in the frame header", at)
    at += 1
    window = None
    if not single:
        if at >= n:
            fail("window descriptor truncated", at)
        exp, mant = data[at] >> 3, data[at] & 7
        base = 1 << (10 + exp)
        window = base + (base >> 3) * mant
        at += 1
    did_size = (0, 1, 2, 4)[did_flag]
    if at + did_size > n:
        fail("dictionary id truncated", at)
    if int.from_bytes(data[at:at + did_size], "little"):
        fail("frame needs a dictionary", at)
    at += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if at + fcs_size > n:
        fail("frame content size truncated", at)
    content = None
    if fcs_size:
        content = int.from_bytes(data[at:at + fcs_size], "little")
        if fcs_size == 2:
            content += 256
    at += fcs_size
    if window is None:
        window = content
    st = _FrameState()
    max_block = min(window, MAX_BLOCK)
    while True:
        if at + 3 > n:
            fail("block header truncated", at)
        head = int.from_bytes(data[at:at + 3], "little")
        last, btype, size = head & 1, (head >> 1) & 3, head >> 3
        at += 3
        before = len(out)
        if btype == 0:
            if at + size > n:
                fail("raw block truncated", at)
            out += data[at:at + size]
            at += size
        elif btype == 1:
            if at >= n:
                fail("RLE block truncated", at)
            out += bytes([data[at]]) * size
            at += 1
        elif btype == 2:
            if size > max_block:
                fail("compressed block larger than its limit", at)
            if at + size > n:
                fail("compressed block truncated", at)
            lits, seq = _literals(data, at, at + size, st)
            _sequences(data, seq, at + size, lits, out, frame_start, window,
                       st)
            at += size
        else:
            fail("reserved block type", at - 3)
        if len(out) - before > max_block:
            fail("block decodes to more than its limit", at)
        if last:
            break
    if content is not None and len(out) - frame_start != content:
        fail(f"frame decodes to {len(out) - frame_start} bytes, its header "
             f"says {content}", pos)
    if check:
        if at + 4 > n:
            fail("content checksum truncated", at)
        want = int.from_bytes(data[at:at + 4], "little")
        got = xxh64(bytes(out[frame_start:])) & 0xFFFFFFFF
        if got != want:
            fail("content checksum mismatch", at)
        at += 4
    return at


def decompress(data: bytes) -> bytes:
    """Decode one or more concatenated zstd frames (skippable frames are
    skipped)."""
    data = bytes(data)
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n:
        if pos + 4 > n:
            fail("frame magic truncated", pos)
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic == FRAME_MAGIC:
            pos = _frame(data, pos, out)
        elif magic & 0xFFFFFFF0 == SKIPPABLE_MAGIC:
            if pos + 8 > n:
                fail("skippable frame truncated", pos)
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos + 8 + size > n:
                fail("skippable frame truncated", pos)
            pos += 8 + size
        else:
            fail(f"bad frame magic {magic:#010x}", pos)
    return bytes(out)
