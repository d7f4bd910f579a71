"""Kafka wire protocol: request parsing + reject-response synthesis.

Reference: pkg/kafka/request.go — ReadRequest (:30) decodes the
request header (api_key, api_version, correlation_id, client_id) and
extracts topics per api key (GetTopics :186); CreateResponse (:158)
synthesizes a correctly-framed error response that preserves the
correlation id so the client sees a protocol-legal authorization
failure instead of a dead connection; correlation_cache.go matches
in-flight requests to responses when the proxy renumbers correlation
ids.

Scope mirrors the reference's 0.11-era coverage: Produce, Fetch,
ListOffsets, Metadata, OffsetCommit, OffsetFetch get full topic
extraction + typed reject bodies; other api keys parse the header and
reject with a header-only frame.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
from typing import Dict, List, Optional, Tuple

# api keys (kafka protocol)
API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9

ERR_TOPIC_AUTHORIZATION_FAILED = 29


class KafkaParseError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise KafkaParseError("truncated request")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8", "replace")

    def skip(self, n: int) -> None:
        self._take(n)


@dataclasses.dataclass(frozen=True)
class ParsedRequest:
    """Decoded request header + the topic/partition view the ACL and
    the reject builder need. ``raw`` is the full frame (size prefix
    included) for pass-through forwarding."""

    api_key: int
    api_version: int
    correlation_id: int
    client_id: str
    topics: Tuple[str, ...]
    partitions: Dict[str, Tuple[int, ...]]
    raw: bytes
    # False only for Produce with acks=0: the client expects NO
    # response frame (pkg/kafka/request.go tracks the same bit so the
    # proxy neither waits on the broker nor synthesizes a reject)
    expect_response: bool = True


def _parse_topic_partitions(r: _Reader, with_partition_body) -> Dict[str, Tuple[int, ...]]:
    """array of [topic string, array of partition entries]."""
    out: Dict[str, Tuple[int, ...]] = {}
    n = r.i32()
    if n < 0:
        return out
    if n > 1_000_000:
        raise KafkaParseError("implausible topic count")
    for _ in range(n):
        topic = r.string() or ""
        parts = []
        pn = r.i32()
        if pn < 0:
            pn = 0
        if pn > 1_000_000:
            raise KafkaParseError("implausible partition count")
        for _ in range(pn):
            parts.append(r.i32())
            with_partition_body(r)
        out[topic] = tuple(parts)
    return out


def parse_request(data: bytes) -> ParsedRequest:
    """Decode one length-prefixed request frame (ReadRequest,
    request.go:30)."""
    if len(data) < 4:
        raise KafkaParseError("short frame")
    (size,) = struct.unpack(">i", data[:4])
    if size < 8 or 4 + size > len(data):
        raise KafkaParseError(f"bad frame size {size}")
    r = _Reader(data[4:4 + size])
    api_key = r.i16()
    api_version = r.i16()
    correlation_id = r.i32()
    client_id = r.string() or ""
    topics: Dict[str, Tuple[int, ...]] = {}
    try:
        expect_response = True
        if api_key == API_PRODUCE:
            if api_version >= 3:
                r.string()  # transactional_id
            acks = r.i16()
            expect_response = acks != 0
            r.i32()  # timeout
            # partition body: message set size + bytes
            topics = _parse_topic_partitions(
                r, lambda rr: rr.skip(max(0, rr.i32()))
            )
        elif api_key == API_FETCH:
            r.i32()  # replica_id
            r.i32()  # max_wait
            r.i32()  # min_bytes
            if api_version >= 3:
                r.i32()  # max_bytes
            if api_version >= 4:
                r.i8()  # isolation_level
            # partition body: fetch_offset i64 (+v5 log_start i64) + max_bytes i32
            def fetch_part(rr):
                rr.i64()
                if api_version >= 5:
                    rr.i64()
                rr.i32()

            topics = _parse_topic_partitions(r, fetch_part)
        elif api_key == API_LIST_OFFSETS:
            r.i32()  # replica_id
            if api_version >= 2:
                r.i8()  # isolation_level
            def lo_part(rr):
                rr.i64()  # timestamp
                if api_version == 0:
                    rr.i32()  # max_num_offsets
            topics = _parse_topic_partitions(r, lo_part)
        elif api_key == API_METADATA:
            n = r.i32()
            if n > 1_000_000:
                raise KafkaParseError("implausible topic count")
            for _ in range(max(0, n)):
                topics[r.string() or ""] = ()
        elif api_key == API_OFFSET_COMMIT:
            r.string()  # group id
            if api_version >= 1:
                r.i32()  # generation
                r.string()  # member id
            if api_version >= 2:
                r.i64()  # retention
            def oc_part(rr):
                rr.i64()  # offset
                if api_version == 1:
                    rr.i64()  # timestamp
                rr.string()  # metadata
            topics = _parse_topic_partitions(r, oc_part)
        elif api_key == API_OFFSET_FETCH:
            r.string()  # group id
            topics = _parse_topic_partitions(r, lambda rr: None)
    except KafkaParseError:
        raise
    return ParsedRequest(
        api_key=api_key,
        api_version=api_version,
        correlation_id=correlation_id,
        client_id=client_id,
        topics=tuple(topics),
        partitions=topics,
        raw=bytes(data[:4 + size]),
        expect_response=expect_response,
    )


# ---------------------------------------------------------------------
# reject synthesis (CreateResponse, request.go:158)

def _w_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _frame(correlation_id: int, body: bytes) -> bytes:
    payload = struct.pack(">i", correlation_id) + body
    return struct.pack(">i", len(payload)) + payload


def reject_response(
    req: ParsedRequest, error_code: int = ERR_TOPIC_AUTHORIZATION_FAILED
) -> bytes:
    """Protocol-legal error response preserving the correlation id —
    the client's library surfaces 'authorization failed' instead of
    hanging on a silently-dropped request."""
    k, v = req.api_key, req.api_version
    parts = lambda t: req.partitions.get(t) or (0,)
    body = b""
    if k == API_PRODUCE:
        body += struct.pack(">i", len(req.topics))
        for t in req.topics:
            body += _w_str(t) + struct.pack(">i", len(parts(t)))
            for p in parts(t):
                body += struct.pack(">ihq", p, error_code, -1)
                if v >= 2:
                    body += struct.pack(">q", -1)  # log_append_time
        if v >= 1:
            body += struct.pack(">i", 0)  # throttle_time
    elif k == API_FETCH:
        if v >= 1:
            body += struct.pack(">i", 0)  # throttle_time
        body += struct.pack(">i", len(req.topics))
        for t in req.topics:
            body += _w_str(t) + struct.pack(">i", len(parts(t)))
            for p in parts(t):
                body += struct.pack(">ihq", p, error_code, -1)  # high watermark
                if v >= 4:
                    body += struct.pack(">q", -1)  # last_stable_offset
                    if v >= 5:
                        body += struct.pack(">q", -1)  # log_start_offset
                    # aborted_transactions is a NULLABLE array: null
                    # encodes as count -1 (not an empty array)
                    body += struct.pack(">i", -1)
                body += struct.pack(">i", 0)  # message set size
    elif k == API_METADATA:
        if v >= 3:
            body += struct.pack(">i", 0)  # throttle_time
        body += struct.pack(">i", 0)  # brokers: empty
        if v >= 2:
            body += _w_str("")  # cluster id (nullable → empty)
        if v >= 1:
            body += struct.pack(">i", -1)  # controller id
        body += struct.pack(">i", len(req.topics))
        for t in req.topics:
            body += struct.pack(">h", error_code) + _w_str(t)
            if v >= 1:
                body += struct.pack(">b", 0)  # is_internal
            body += struct.pack(">i", 0)  # partitions: empty
    elif k == API_LIST_OFFSETS:
        body += struct.pack(">i", len(req.topics))
        for t in req.topics:
            body += _w_str(t) + struct.pack(">i", len(parts(t)))
            for p in parts(t):
                if v == 0:
                    body += struct.pack(">ihi", p, error_code, 0)  # offsets []
                else:
                    body += struct.pack(">ihqq", p, error_code, -1, -1)
    elif k == API_OFFSET_COMMIT:
        body += struct.pack(">i", len(req.topics))
        for t in req.topics:
            body += _w_str(t) + struct.pack(">i", len(parts(t)))
            for p in parts(t):
                body += struct.pack(">ih", p, error_code)
    elif k == API_OFFSET_FETCH:
        if v >= 3:
            body += struct.pack(">i", 0)  # throttle_time
        body += struct.pack(">i", len(req.topics))
        for t in req.topics:
            body += _w_str(t) + struct.pack(">i", len(parts(t)))
            for p in parts(t):
                body += struct.pack(">iq", p, -1) + _w_str("") + struct.pack(
                    ">h", error_code
                )
        if v >= 2:
            # v2+ carries a top-level error code after the topic array
            body += struct.pack(">h", error_code)
    # other api keys: header-only frame (still unblocks the client)
    return _frame(req.correlation_id, body)


# ---------------------------------------------------------------------
class CorrelationCache:
    """Proxy-side correlation-id renumbering (correlation_cache.go):
    requests forwarded upstream get a fresh id (distinct streams can
    reuse client ids); responses are matched back and rewritten to the
    client's original id."""

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._next = 1
        self._inflight: Dict[int, int] = {}  # proxy cid → client cid
        self.capacity = capacity

    def forward(self, req: ParsedRequest) -> bytes:
        """Rewrite the request frame with a proxy correlation id;
        remembers the mapping. Raises if too many in flight."""
        with self._lock:
            if len(self._inflight) >= self.capacity:
                raise KafkaParseError("correlation cache full")
            cid = self._next
            self._next = (self._next + 1) & 0x7FFFFFFF or 1
            self._inflight[cid] = req.correlation_id
        # correlation id sits at bytes 8..12 of the frame
        return req.raw[:8] + struct.pack(">i", cid) + req.raw[12:]

    def correlate(self, response: bytes) -> Optional[bytes]:
        """Match a response frame to its request; returns the frame
        rewritten to the client's correlation id, or None for an
        unknown id (response dropped, request.go behavior)."""
        if len(response) < 8:
            return None
        (cid,) = struct.unpack(">i", response[4:8])
        with self._lock:
            orig = self._inflight.pop(cid, None)
        if orig is None:
            return None
        return response[:4] + struct.pack(">i", orig) + response[8:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._inflight)
