"""HPACK (RFC 7541) header compression for the external proxy's
HTTP/2 codec.

The reference rides Envoy's nghttp2 codec, so its L7 filter never sees
wire bytes (envoy/cilium_l7policy.cc works on decoded header maps); the
standalone proxy decodes the wire itself. Full decoder (indexed fields,
literals with/without/never indexing, dynamic-table size updates,
Huffman) + a minimal-but-legal encoder (literal-without-indexing, no
Huffman — peers must accept uncompressed literals).

The Huffman code table is the fixed one from RFC 7541 Appendix B.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


class HpackError(Exception):
    pass


# Ceiling on cumulative DECODED header bytes per block (names + values
# after huffman/table expansion) — the HPACK-bomb guard. Mirrors the
# reference proxy's default max header list size.
MAX_DECODED_HEADER_BYTES = 1 << 16


# RFC 7541 Appendix A: the static table (1-based).
STATIC_TABLE: List[Tuple[bytes, bytes]] = [
    (b":authority", b""),
    (b":method", b"GET"),
    (b":method", b"POST"),
    (b":path", b"/"),
    (b":path", b"/index.html"),
    (b":scheme", b"http"),
    (b":scheme", b"https"),
    (b":status", b"200"),
    (b":status", b"204"),
    (b":status", b"206"),
    (b":status", b"304"),
    (b":status", b"400"),
    (b":status", b"404"),
    (b":status", b"500"),
    (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"),
    (b"accept-language", b""),
    (b"accept-ranges", b""),
    (b"accept", b""),
    (b"access-control-allow-origin", b""),
    (b"age", b""),
    (b"allow", b""),
    (b"authorization", b""),
    (b"cache-control", b""),
    (b"content-disposition", b""),
    (b"content-encoding", b""),
    (b"content-language", b""),
    (b"content-length", b""),
    (b"content-location", b""),
    (b"content-range", b""),
    (b"content-type", b""),
    (b"cookie", b""),
    (b"date", b""),
    (b"etag", b""),
    (b"expect", b""),
    (b"expires", b""),
    (b"from", b""),
    (b"host", b""),
    (b"if-match", b""),
    (b"if-modified-since", b""),
    (b"if-none-match", b""),
    (b"if-range", b""),
    (b"if-unmodified-since", b""),
    (b"last-modified", b""),
    (b"link", b""),
    (b"location", b""),
    (b"max-forwards", b""),
    (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""),
    (b"range", b""),
    (b"referer", b""),
    (b"refresh", b""),
    (b"retry-after", b""),
    (b"server", b""),
    (b"set-cookie", b""),
    (b"strict-transport-security", b""),
    (b"transfer-encoding", b""),
    (b"user-agent", b""),
    (b"vary", b""),
    (b"via", b""),
    (b"www-authenticate", b""),
]

# RFC 7541 Appendix B: (code, bit length) for bytes 0-255 + EOS (256).
HUFFMAN: List[Tuple[int, int]] = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
]


def _build_decode_tree():
    """(left, right) binary trie; leaves hold the symbol int."""
    root: list = [None, None]
    for sym, (code, nbits) in enumerate(HUFFMAN):
        node = root
        for i in range(nbits - 1, -1, -1):
            bit = (code >> i) & 1
            if i == 0:
                node[bit] = sym
            else:
                if node[bit] is None:
                    node[bit] = [None, None]
                node = node[bit]
    return root


_DECODE_TREE = _build_decode_tree()


def huffman_decode(data: bytes) -> bytes:
    """RFC 7541 §5.2. Padding must be the EOS prefix (all 1s) and
    STRICTLY shorter than 8 bits; anything else — a 0 bit, a full EOS
    symbol, or ≥8 all-ones bits — is an error."""
    out = bytearray()
    node = _DECODE_TREE
    pad_ok = True  # only-1s since last symbol boundary
    pad_bits = 0  # bits consumed since last symbol boundary
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            if bit == 0:
                pad_ok = False
            pad_bits += 1
            nxt = node[bit]
            if nxt is None:
                raise HpackError("invalid huffman code")
            if isinstance(nxt, int):
                if nxt == 256:
                    raise HpackError("EOS in huffman data")
                out.append(nxt)
                node = _DECODE_TREE
                pad_ok = True
                pad_bits = 0
            else:
                node = nxt
    if not pad_ok:
        raise HpackError("huffman padding contains 0 bits")
    if node is not _DECODE_TREE and pad_bits >= 8:
        # ≥8 all-ones trailing bits decode as an EOS prefix too, but
        # §5.2 says padding "strictly less than 8 bits" — longer runs
        # MUST be treated as a decoding error (EOS-prefix smuggling)
        raise HpackError("huffman padding of 8 or more bits")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for byte in data:
        code, n = HUFFMAN[byte]
        acc = (acc << n) | code
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    """RFC 7541 §5.1 prefix-coded integer; ``flags`` fills the bits
    above the prefix in the first byte."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    """→ (value, next_pos)."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise HpackError("integer overflow")
        if not (b & 0x80):
            return value, pos


class HpackDecoder:
    """One per connection direction (the HPACK dynamic table is
    connection state — RFC 7541 §2.3.2)."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_table_size = max_table_size  # protocol ceiling (SETTINGS)
        self.table_size = max_table_size  # current, ≤ ceiling
        self._dynamic: List[Tuple[bytes, bytes]] = []
        self._dynsize = 0

    def _entry(self, index: int) -> Tuple[bytes, bytes]:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        di = index - len(STATIC_TABLE) - 1
        if di >= len(self._dynamic):
            raise HpackError(f"index {index} out of range")
        return self._dynamic[di]

    def _add(self, name: bytes, value: bytes) -> None:
        size = len(name) + len(value) + 32  # RFC 7541 §4.1 entry size
        self._dynamic.insert(0, (name, value))
        self._dynsize += size
        while self._dynsize > self.table_size and self._dynamic:
            n, v = self._dynamic.pop()
            self._dynsize -= len(n) + len(v) + 32

    def _read_string(self, data: bytes, pos: int) -> Tuple[bytes, int]:
        if pos >= len(data):
            raise HpackError("truncated string")
        huff = bool(data[pos] & 0x80)
        length, pos = decode_int(data, pos, 7)
        if pos + length > len(data):
            raise HpackError("truncated string data")
        raw = data[pos:pos + length]
        pos += length
        return (huffman_decode(raw) if huff else raw), pos

    def decode(self, data: bytes) -> List[Tuple[bytes, bytes]]:
        headers: List[Tuple[bytes, bytes]] = []
        decoded = 0  # cumulative DECODED bytes (HPACK-bomb guard)
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                index, pos = decode_int(data, pos, 7)
                entry = self._entry(index)
                decoded += len(entry[0]) + len(entry[1])
                headers.append(entry)
            elif b & 0x40:  # literal with incremental indexing
                index, pos = decode_int(data, pos, 6)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                self._add(name, value)
                decoded += len(name) + len(value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = decode_int(data, pos, 5)
                if size > self.max_table_size:
                    raise HpackError("table size above SETTINGS ceiling")
                self.table_size = size
                while self._dynsize > size and self._dynamic:
                    n, v = self._dynamic.pop()
                    self._dynsize -= len(n) + len(v) + 32
            else:  # literal without indexing (0x00) / never indexed (0x10)
                index, pos = decode_int(data, pos, 4)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                decoded += len(name) + len(value)
                headers.append((name, value))
            if decoded > MAX_DECODED_HEADER_BYTES:
                # the wire bytes are small; the EXPANSION is the bomb
                # (huffman + table references amplify ~100×). Checked
                # after every field so the cap bounds peak memory, not
                # just the returned list. → COMPRESSION_ERROR upstream.
                raise HpackError(
                    f"decoded header list exceeds "
                    f"{MAX_DECODED_HEADER_BYTES} bytes"
                )
        return headers


class HpackEncoder:
    """Stateless-by-choice encoder: every field goes out as a literal
    WITHOUT indexing (type 0x00), so no dynamic-table sync is needed
    with the peer's decoder. Static-table name references are used when
    available; values over ~16 bytes ride Huffman."""

    def __init__(self) -> None:
        self._name_index = {}
        for i, (n, _v) in enumerate(STATIC_TABLE):
            self._name_index.setdefault(n, i + 1)

    @staticmethod
    def _string(data: bytes) -> bytes:
        enc = huffman_encode(data)
        if len(enc) < len(data):
            return encode_int(len(enc), 7, 0x80) + enc
        return encode_int(len(data), 7, 0x00) + data

    def encode(self, headers: Iterable[Tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            idx = self._name_index.get(name)
            if idx is not None:
                out += encode_int(idx, 4, 0x00)
            else:
                out += encode_int(0, 4, 0x00)
                out += self._string(name)
            out += self._string(value)
        return bytes(out)
