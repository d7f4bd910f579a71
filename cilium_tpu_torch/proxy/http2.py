"""HTTP/2 (RFC 7540) codec for the external proxy.

The reference gets H2 — and with it gRPC — for free from Envoy's
codec-agnostic HTTP stream path (envoy/cilium_l7policy.cc:1-193 runs on
decoded headers regardless of wire codec). The standalone proxy grows
the same property here: a server-side connection codec that decodes
HEADERS/DATA into the proxy's HTTPRequest model, and a client-side
codec for relaying allowed streams upstream.

Scope (what L7 policy needs, nothing more):
- full frame layer: DATA, HEADERS(+CONTINUATION), RST_STREAM,
  SETTINGS, PING, GOAWAY, WINDOW_UPDATE; PRIORITY ignored; padding
  handled; PUSH_PROMISE rejected (we never enable it)
- HPACK via proxy/hpack.py (dynamic table + Huffman)
- flow control: we grant the peer a large fixed window and replenish
  eagerly (the proxy never wants to stall a request body it is about
  to drop or forward); sends respect the peer's windows
- gRPC: content-type application/grpc* marks a stream whose deny
  response must be 200 + grpc-status in trailers (gRPC carries status
  out of band; a 403 would surface as a transport error, not
  PERMISSION_DENIED — same mapping Envoy's filter uses)
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.framing import recv_exact
from .hpack import HpackDecoder, HpackEncoder, HpackError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_PRIORITY = 0x2
FRAME_RST_STREAM = 0x3
FRAME_SETTINGS = 0x4
FRAME_PUSH_PROMISE = 0x5
FRAME_PING = 0x6
FRAME_GOAWAY = 0x7
FRAME_WINDOW_UPDATE = 0x8
FRAME_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

ERR_NO_ERROR = 0x0
ERR_PROTOCOL = 0x1
ERR_FLOW_CONTROL = 0x3
ERR_REFUSED_STREAM = 0x7

DEFAULT_WINDOW = 65535
# what we advertise: big enough that request bodies never stall
OUR_WINDOW = 1 << 24
GRPC_PERMISSION_DENIED = 7


class H2Error(Exception):
    def __init__(self, msg: str, code: int = ERR_PROTOCOL) -> None:
        super().__init__(msg)
        self.code = code


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    if len(payload) > (1 << 24) - 1:
        raise H2Error("frame too large")
    return (
        struct.pack(">I", len(payload))[1:]
        + bytes([ftype, flags])
        + struct.pack(">I", stream_id & 0x7FFFFFFF)
        + payload
    )


# what we advertise (and therefore must enforce): RFC 7540 §4.2 — a
# frame above SETTINGS_MAX_FRAME_SIZE is a FRAME_SIZE_ERROR, and
# accepting 16MB frames from an unauthenticated peer is a memory DoS
MAX_FRAME_SIZE = 16384
# header blocks (HEADERS + CONTINUATIONs) are capped too — the 2024
# CONTINUATION-flood pattern grows the block forever otherwise
MAX_HEADER_BLOCK = 1 << 17
# the SETTINGS_MAX_CONCURRENT_STREAMS value we advertise — and, since
# the advertisement alone is advisory, also ENFORCE: stream N+1 gets
# RST_STREAM(REFUSED_STREAM) instead of an unbounded streams dict
MAX_CONCURRENT_STREAMS = 256


def read_frame(
    sock: socket.socket, max_frame: int = MAX_FRAME_SIZE
) -> Optional[Tuple[int, int, int, bytes]]:
    """→ (type, flags, stream_id, payload) or None on EOF."""
    hdr = recv_exact(sock, 9)
    if hdr is None:
        return None
    length = struct.unpack(">I", b"\x00" + hdr[:3])[0]
    ftype, flags = hdr[3], hdr[4]
    (stream_id,) = struct.unpack(">I", hdr[5:9])
    stream_id &= 0x7FFFFFFF
    if length > max_frame:
        raise H2Error("frame exceeds max size", code=0x6)  # FRAME_SIZE
    payload = b"" if length == 0 else recv_exact(sock, length)
    if length and payload is None:
        return None
    return ftype, flags, stream_id, payload


def _expect_len(payload: bytes, n: int) -> None:
    """Fixed-size frame payloads (PING/RST_STREAM/WINDOW_UPDATE) must
    be exactly n bytes — RFC 7540 FRAME_SIZE_ERROR otherwise (and a
    malformed length must never surface as struct.error)."""
    if len(payload) != n:
        raise H2Error("bad frame length", code=0x6)


def _strip_padding(flags: int, payload: bytes) -> bytes:
    if flags & FLAG_PADDED:
        if not payload:
            raise H2Error("padded frame without pad length")
        pad = payload[0]
        body = payload[1:]
        if pad > len(body):
            raise H2Error("pad length exceeds frame")
        return body[: len(body) - pad]
    return payload


def settings_payload(pairs: Dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in pairs.items())


def parse_settings(payload: bytes) -> Dict[int, int]:
    if len(payload) % 6:
        raise H2Error("SETTINGS length not multiple of 6", code=0x6)
    out = {}
    for i in range(0, len(payload), 6):
        k, v = struct.unpack(">HI", payload[i:i + 6])
        out[k] = v
    return out


class H2Stream:
    """One request stream as the policy layer sees it."""

    def __init__(self, stream_id: int) -> None:
        self.id = stream_id
        self.headers: List[Tuple[bytes, bytes]] = []
        self.trailers: List[Tuple[bytes, bytes]] = []
        self.body = bytearray()
        self.headers_done = False
        self.closed_remote = False  # END_STREAM seen
        self.reset = False

    def pseudo(self, name: bytes) -> str:
        for k, v in self.headers:
            if k == name:
                return v.decode("latin1")
        return ""

    @property
    def method(self) -> str:
        return self.pseudo(b":method")

    @property
    def path(self) -> str:
        return self.pseudo(b":path")

    @property
    def authority(self) -> str:
        return self.pseudo(b":authority")

    @property
    def is_grpc(self) -> bool:
        for k, v in self.headers:
            if k == b"content-type":
                return v.startswith(b"application/grpc")
        return False

    def plain_headers(self) -> List[Tuple[str, str]]:
        return [
            (k.decode("latin1"), v.decode("latin1"))
            for k, v in self.headers
            if not k.startswith(b":")
        ]


class _ConnBase:
    """Shared send path + windows for the server and client halves."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._wlock = threading.Lock()
        self.encoder = HpackEncoder()
        self.decoder = HpackDecoder()
        self.send_window = DEFAULT_WINDOW  # connection-level, theirs
        self.stream_send_windows: Dict[int, int] = {}
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = 16384
        self._window_cv = threading.Condition()
        self.closed = False

    def send(self, data: bytes) -> None:
        with self._wlock:
            # the write lock EXISTS to serialize whole frames onto one
            # socket — h2 frames from concurrent streams must not
            # interleave mid-frame; holding it across sendall is the
            # design, not a convoy bug
            self.sock.sendall(data)  # policyd-lint: disable=LOCK002

    def send_frame(self, ftype: int, flags: int, sid: int, payload: bytes = b"") -> None:
        self.send(pack_frame(ftype, flags, sid, payload))

    def send_headers(
        self, sid: int, fields: List[Tuple[bytes, bytes]], end_stream: bool
    ) -> None:
        """Raw HEADERS frame (relay path — no synthesized fields)."""
        self.send_frame(
            FRAME_HEADERS,
            FLAG_END_HEADERS | (FLAG_END_STREAM if end_stream else 0),
            sid, self.encoder.encode(fields),
        )
        if end_stream:
            self._local_end(sid)

    def _local_end(self, sid: int) -> None:
        """Hook: we sent END_STREAM on sid. Subclasses prune their
        stream maps on top; the base drops the send-window entry (we
        will never send on this stream again)."""
        with self._window_cv:
            self.stream_send_windows.pop(sid, None)

    def _stream_known(self, sid: int) -> bool:
        """Whether sid is a live stream — credits for unknown ids are
        dropped so a peer can't grow stream_send_windows unboundedly
        with WINDOW_UPDATEs for streams that never existed."""
        return True

    # -- flow-controlled DATA send -------------------------------------
    def send_data(self, sid: int, data: bytes, end_stream: bool) -> None:
        """Respects both windows; blocks for WINDOW_UPDATE when dry."""
        view = memoryview(data)
        while True:
            with self._window_cv:
                if self.closed:
                    raise OSError("connection closed")
                sw = self.stream_send_windows.get(sid, self.peer_initial_window)
                room = min(self.send_window, sw, self.peer_max_frame)
                if len(view) and room <= 0:
                    if not self._window_cv.wait(timeout=30.0):
                        raise H2Error("flow-control stall", ERR_FLOW_CONTROL)
                    continue
                n = min(len(view), max(room, 0))
                self.send_window -= n
                self.stream_send_windows[sid] = sw - n
            chunk = bytes(view[:n])
            view = view[n:]
            last = not len(view)
            self.send_frame(
                FRAME_DATA, FLAG_END_STREAM if (end_stream and last) else 0,
                sid, chunk,
            )
            if last:
                if end_stream:
                    self._local_end(sid)
                return

    def _credit(self, sid: int, amount: int) -> None:
        with self._window_cv:
            if sid == 0:
                self.send_window += amount
            elif self._stream_known(sid):
                self.stream_send_windows[sid] = (
                    self.stream_send_windows.get(sid, self.peer_initial_window)
                    + amount
                )
            self._window_cv.notify_all()

    def _apply_settings(self, pairs: Dict[int, int]) -> None:
        if SETTINGS_INITIAL_WINDOW_SIZE in pairs:
            new = pairs[SETTINGS_INITIAL_WINDOW_SIZE]
            if new > 0x7FFFFFFF:
                raise H2Error("window size too large", ERR_FLOW_CONTROL)
            with self._window_cv:
                delta = new - self.peer_initial_window
                self.peer_initial_window = new
                for k in self.stream_send_windows:
                    self.stream_send_windows[k] += delta
                self._window_cv.notify_all()
        if SETTINGS_MAX_FRAME_SIZE in pairs:
            self.peer_max_frame = max(16384, pairs[SETTINGS_MAX_FRAME_SIZE])
        if SETTINGS_HEADER_TABLE_SIZE in pairs:
            # ceiling for OUR encoder's table — we never index, so ack
            # and move on
            pass

    def close(self) -> None:
        with self._window_cv:
            self.closed = True
            self._window_cv.notify_all()


class H2ServerConnection(_ConnBase):
    """Server half: owns the read loop of one accepted connection.

    ``on_request(stream)`` fires when a stream's request HEADERS are
    complete (END_HEADERS) — the policy decision point, matching
    decodeHeaders() in the reference's filter. The callback decides and
    responds via respond()/send_data()/reset(); request DATA keeps
    accumulating into stream.body (callers that forward consume it via
    ``on_data``)."""

    def __init__(
        self,
        sock: socket.socket,
        on_request: Callable[["H2ServerConnection", H2Stream], None],
        on_data: Optional[Callable] = None,  # (conn, stream, chunk, end)
        on_reset: Optional[Callable] = None,  # (conn, stream)
        max_body: int = 1 << 20,
    ) -> None:
        super().__init__(sock)
        self.on_request = on_request
        self.on_data = on_data
        self.on_reset = on_reset
        self.max_body = max_body
        self.streams: Dict[int, H2Stream] = {}
        self._headers_sid = 0  # stream collecting CONTINUATIONs
        self._headers_buf = b""
        self._headers_end_stream = False
        self.recv_window = OUR_WINDOW
        self._last_sid = 0
        # completed streams are PRUNED (a long-lived gRPC channel can
        # carry millions of unary calls over one connection); late
        # frames for already-pruned ids ≤ _last_sid are dropped
        self._local_done: set = set()

    def _local_end(self, sid: int) -> None:
        super()._local_end(sid)
        st = self.streams.get(sid)
        if st is not None and st.closed_remote:
            self.streams.pop(sid, None)
        else:
            self._local_done.add(sid)

    def _remote_end(self, sid: int) -> None:
        if sid in self._local_done:
            self._local_done.discard(sid)
            self.streams.pop(sid, None)

    def _stream_known(self, sid: int) -> bool:
        return sid in self.streams or sid in self._local_done

    # -- handshake ------------------------------------------------------
    def handshake(self, consumed: bytes = b"") -> bool:
        """Consume the client preface (minus the ``consumed`` bytes the
        caller already read while codec-sniffing), then send SETTINGS."""
        want = PREFACE[len(consumed):]
        if want:
            got = recv_exact(self.sock, len(want))
            if got != want:
                return False
        self.send_frame(
            FRAME_SETTINGS, 0, 0,
            settings_payload({
                SETTINGS_ENABLE_PUSH: 0,
                SETTINGS_INITIAL_WINDOW_SIZE: OUR_WINDOW,
                SETTINGS_MAX_CONCURRENT_STREAMS: MAX_CONCURRENT_STREAMS,
            }),
        )
        # grow the connection window beyond the 64KB default
        self.send_frame(
            FRAME_WINDOW_UPDATE, 0, 0,
            struct.pack(">I", OUR_WINDOW - DEFAULT_WINDOW),
        )
        return True

    # -- responses ------------------------------------------------------
    def respond(
        self,
        sid: int,
        status: int,
        headers: Optional[List[Tuple[bytes, bytes]]] = None,
        body: bytes = b"",
        trailers: Optional[List[Tuple[bytes, bytes]]] = None,
    ) -> None:
        hdrs = [(b":status", str(status).encode())]
        hdrs += headers or []
        if trailers is None:
            hdrs.append((b"content-length", str(len(body)).encode()))
        block = self.encoder.encode(hdrs)
        ends_now = not body and trailers is None
        end = FLAG_END_HEADERS | (FLAG_END_STREAM if ends_now else 0)
        self.send_frame(FRAME_HEADERS, end, sid, block)
        if ends_now:
            self._local_end(sid)
        if body:
            self.send_data(sid, body, end_stream=trailers is None)
        if trailers is not None:
            self.send_frame(
                FRAME_HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM, sid,
                self.encoder.encode(trailers),
            )
            self._local_end(sid)

    def respond_grpc_status(self, sid: int, code: int, message: str) -> None:
        """gRPC deny: HTTP 200 + grpc-status trailers-only response."""
        self.respond(
            sid, 200,
            headers=[(b"content-type", b"application/grpc")],
            trailers=[
                (b"grpc-status", str(code).encode()),
                (b"grpc-message", message.encode()),
            ],
        )

    def reset(self, sid: int, code: int = ERR_REFUSED_STREAM) -> None:
        self.send_frame(FRAME_RST_STREAM, 0, sid, struct.pack(">I", code))
        self.streams.pop(sid, None)
        self._local_done.discard(sid)

    def goaway(self, code: int = ERR_NO_ERROR) -> None:
        self.send_frame(
            FRAME_GOAWAY, 0, 0, struct.pack(">II", self._last_sid, code)
        )

    # -- read loop ------------------------------------------------------
    def serve(self) -> None:
        """Read frames until EOF/GOAWAY/protocol error."""
        try:
            while True:
                fr = read_frame(self.sock)
                if fr is None:
                    return
                if not self._handle(fr):
                    return
        except H2Error as e:
            try:
                self.goaway(e.code)
            except OSError:
                pass
        except (OSError, struct.error):
            pass
        finally:
            self.close()

    def _headers_complete(self, sid: int, end_stream: bool) -> None:
        try:
            fields = self.decoder.decode(self._headers_buf)
        except HpackError as e:
            raise H2Error(f"hpack: {e}", code=0x9)  # COMPRESSION_ERROR
        self._headers_buf = b""
        self._headers_sid = 0
        st = self.streams.get(sid)
        if st is None:
            return  # closed/pruned stream: decoded for HPACK continuity
        if st.headers_done:
            st.trailers = fields  # request trailers (gRPC)
        else:
            st.headers = fields
            st.headers_done = True
        if end_stream:
            st.closed_remote = True
        if st.headers_done and fields is st.headers:
            self.on_request(self, st)
        elif st.closed_remote and self.on_data is not None:
            self.on_data(self, st, b"", True)
        if end_stream:
            self._remote_end(sid)

    def _handle(self, fr: Tuple[int, int, int, bytes]) -> bool:
        ftype, flags, sid, payload = fr
        if self._headers_sid and ftype != FRAME_CONTINUATION:
            raise H2Error("expected CONTINUATION")
        if ftype == FRAME_SETTINGS:
            if flags & FLAG_ACK:
                return True
            self._apply_settings(parse_settings(payload))
            self.send_frame(FRAME_SETTINGS, FLAG_ACK, 0)
            return True
        if ftype == FRAME_PING:
            _expect_len(payload, 8)
            if not flags & FLAG_ACK:
                self.send_frame(FRAME_PING, FLAG_ACK, 0, payload)
            return True
        if ftype == FRAME_GOAWAY:
            return False
        if ftype == FRAME_WINDOW_UPDATE:
            _expect_len(payload, 4)
            (inc,) = struct.unpack(">I", payload)
            self._credit(sid, inc & 0x7FFFFFFF)
            return True
        if ftype == FRAME_PRIORITY:
            return True
        if ftype == FRAME_PUSH_PROMISE:
            raise H2Error("PUSH_PROMISE from client")
        if ftype == FRAME_HEADERS:
            if sid == 0 or sid % 2 == 0:
                raise H2Error("bad stream id")
            body = _strip_padding(flags, payload)
            if flags & FLAG_PRIORITY:
                if len(body) < 5:
                    raise H2Error("short priority block")
                body = body[5:]
            if sid not in self.streams:
                if sid > self._last_sid:  # genuinely new stream
                    self._last_sid = sid
                    if len(self.streams) >= MAX_CONCURRENT_STREAMS:
                        # we advertised this ceiling in SETTINGS; a
                        # peer exceeding it gets RST_STREAM(REFUSED_
                        # STREAM) per RFC 9113 §5.1.2 — but the block
                        # is still DECODED below (HPACK state is
                        # connection-wide; skipping it desyncs the
                        # dynamic table for every later stream)
                        self.reset(sid, ERR_REFUSED_STREAM)
                    else:
                        self.streams[sid] = H2Stream(sid)
                # else: frames for a closed/pruned id — still DECODE
                # the block (HPACK state is connection-wide) but the
                # fields are discarded in _headers_complete
            self._headers_buf = body
            self._headers_end_stream = bool(flags & FLAG_END_STREAM)
            if flags & FLAG_END_HEADERS:
                self._headers_complete(sid, self._headers_end_stream)
            else:
                self._headers_sid = sid
            return True
        if ftype == FRAME_CONTINUATION:
            if sid != self._headers_sid:
                raise H2Error("CONTINUATION on wrong stream")
            self._headers_buf += payload
            if len(self._headers_buf) > MAX_HEADER_BLOCK:
                # CONTINUATION flood: the block must not grow forever
                raise H2Error("header block too large", code=0xB)
            if flags & FLAG_END_HEADERS:
                self._headers_complete(sid, self._headers_end_stream)
            return True
        if ftype == FRAME_DATA:
            st = self.streams.get(sid)
            if st is None:
                if sid > self._last_sid:
                    raise H2Error("DATA before HEADERS")
                # closed/pruned stream: drop, but give the connection
                # window its bytes back
                if payload:
                    self.send_frame(
                        FRAME_WINDOW_UPDATE, 0, 0,
                        struct.pack(">I", len(payload)),
                    )
                return True
            if not st.headers_done:
                raise H2Error("DATA before HEADERS")
            chunk = _strip_padding(flags, payload)
            end = bool(flags & FLAG_END_STREAM)
            if end:
                st.closed_remote = True
            if self.on_data is not None:
                self.on_data(self, st, chunk, end)
            else:
                st.body += chunk
                if len(st.body) > self.max_body:
                    raise H2Error("request body too large", ERR_FLOW_CONTROL)
            # eager replenish: we took `len(payload)` from both windows
            if payload:
                self.send_frame(
                    FRAME_WINDOW_UPDATE, 0, 0,
                    struct.pack(">I", len(payload)),
                )
                if not end:
                    self.send_frame(
                        FRAME_WINDOW_UPDATE, 0, sid,
                        struct.pack(">I", len(payload)),
                    )
            if end:
                self._remote_end(sid)
            return True
        if ftype == FRAME_RST_STREAM:
            _expect_len(payload, 4)
            st = self.streams.pop(sid, None)
            self._local_done.discard(sid)
            if st is not None:
                st.reset = True
                if self.on_reset is not None:
                    self.on_reset(self, st)
            return True
        return True  # unknown frame types are ignored (RFC 7540 §4.1)


class H2ClientConnection(_ConnBase):
    """Client half for the upstream leg of forwarded streams. One per
    downstream connection; downstream stream ids are reused upstream
    (both are client-initiated odd ids in arrival order, so ids stay
    monotonic as RFC 7540 requires)."""

    def __init__(self, sock: socket.socket) -> None:
        super().__init__(sock)
        self.responses: Dict[int, H2Stream] = {}
        self._headers_sid = 0
        self._headers_buf = b""
        self._headers_end_stream = False
        # relay callbacks:
        #   on_response_headers(sid, headers|None, trailers|None, end)
        #   on_response_data(sid, chunk, end)
        #   on_response_reset(sid)
        self.on_response_headers: Optional[Callable] = None
        self.on_response_data: Optional[Callable] = None
        self.on_response_reset: Optional[Callable] = None
        self._local_done: set = set()

    def _local_end(self, sid: int) -> None:
        super()._local_end(sid)
        st = self.responses.get(sid)
        if st is not None and st.closed_remote:
            self.responses.pop(sid, None)
        else:
            self._local_done.add(sid)

    def _remote_end(self, sid: int) -> None:
        if sid in self._local_done:
            self._local_done.discard(sid)
            self.responses.pop(sid, None)

    def _stream_known(self, sid: int) -> bool:
        return sid in self.responses or sid in self._local_done

    def handshake(self) -> None:
        self.send(
            PREFACE
            + pack_frame(
                FRAME_SETTINGS, 0, 0,
                settings_payload({
                    SETTINGS_ENABLE_PUSH: 0,
                    SETTINGS_INITIAL_WINDOW_SIZE: OUR_WINDOW,
                }),
            )
            + pack_frame(
                FRAME_WINDOW_UPDATE, 0, 0,
                struct.pack(">I", OUR_WINDOW - DEFAULT_WINDOW),
            )
        )

    def request_headers(
        self, sid: int, fields: List[Tuple[bytes, bytes]], end_stream: bool
    ) -> None:
        self.responses[sid] = H2Stream(sid)
        self.send_frame(
            FRAME_HEADERS,
            FLAG_END_HEADERS | (FLAG_END_STREAM if end_stream else 0),
            sid, self.encoder.encode(fields),
        )
        if end_stream:
            self._local_end(sid)

    def serve(self) -> None:
        """Response pump — run on its own thread."""
        try:
            while True:
                fr = read_frame(self.sock)
                if fr is None:
                    return
                if not self._handle(fr):
                    return
        except (H2Error, HpackError, OSError, struct.error):
            pass
        finally:
            self.close()

    def _headers_complete(self, sid: int, end_stream: bool) -> None:
        fields = self.decoder.decode(self._headers_buf)
        self._headers_buf = b""
        self._headers_sid = 0
        st = self.responses.get(sid)
        if st is None:
            return
        if end_stream:
            st.closed_remote = True
        if st.headers_done:
            st.trailers = fields
            if self.on_response_headers is not None:
                self.on_response_headers(sid, None, fields, True)
        else:
            interim = False  # 1xx informational HEADERS precede the
            if not end_stream:  # real response (RFC 7540 §8.1)
                for k, v in fields:
                    if k == b":status":
                        interim = v.startswith(b"1") and v != b"101"
                        break
            if interim:
                if self.on_response_headers is not None:
                    self.on_response_headers(sid, fields, None, False)
                return  # headers_done stays False for the final block
            st.headers = fields
            st.headers_done = True
            if self.on_response_headers is not None:
                self.on_response_headers(sid, fields, None, end_stream)
        if end_stream:
            self._remote_end(sid)

    def _handle(self, fr) -> bool:
        ftype, flags, sid, payload = fr
        if self._headers_sid and ftype != FRAME_CONTINUATION:
            raise H2Error("expected CONTINUATION")
        if ftype == FRAME_SETTINGS:
            if not flags & FLAG_ACK:
                self._apply_settings(parse_settings(payload))
                self.send_frame(FRAME_SETTINGS, FLAG_ACK, 0)
            return True
        if ftype == FRAME_PING:
            _expect_len(payload, 8)
            if not flags & FLAG_ACK:
                self.send_frame(FRAME_PING, FLAG_ACK, 0, payload)
            return True
        if ftype == FRAME_GOAWAY:
            return False
        if ftype == FRAME_WINDOW_UPDATE:
            _expect_len(payload, 4)
            (inc,) = struct.unpack(">I", payload)
            self._credit(sid, inc & 0x7FFFFFFF)
            return True
        if ftype in (FRAME_PRIORITY, FRAME_PUSH_PROMISE):
            return True
        if ftype == FRAME_HEADERS:
            body = _strip_padding(flags, payload)
            if flags & FLAG_PRIORITY:
                if len(body) < 5:
                    # a short frame here would silently decode an
                    # EMPTY header block instead of erroring
                    raise H2Error("short priority block")
                body = body[5:]
            self._headers_buf = body
            self._headers_end_stream = bool(flags & FLAG_END_STREAM)
            if flags & FLAG_END_HEADERS:
                self._headers_complete(sid, self._headers_end_stream)
            else:
                self._headers_sid = sid
            return True
        if ftype == FRAME_CONTINUATION:
            self._headers_buf += payload
            if len(self._headers_buf) > MAX_HEADER_BLOCK:
                raise H2Error("header block too large", code=0xB)
            if flags & FLAG_END_HEADERS:
                self._headers_complete(sid, self._headers_end_stream)
            return True
        if ftype == FRAME_DATA:
            st = self.responses.get(sid)
            chunk = _strip_padding(flags, payload)
            end = bool(flags & FLAG_END_STREAM)
            if payload:
                self.send_frame(
                    FRAME_WINDOW_UPDATE, 0, 0, struct.pack(">I", len(payload))
                )
                if not end:
                    self.send_frame(
                        FRAME_WINDOW_UPDATE, 0, sid,
                        struct.pack(">I", len(payload)),
                    )
            if st is not None:
                if end:
                    st.closed_remote = True
                if self.on_response_data is not None:
                    self.on_response_data(sid, chunk, end)
                else:
                    st.body += chunk
                if end:
                    self._remote_end(sid)
            return True
        if ftype == FRAME_RST_STREAM:
            _expect_len(payload, 4)
            st = self.responses.pop(sid, None)
            self._local_done.discard(sid)
            if st is not None:
                st.reset = True
                if self.on_response_reset is not None:
                    self.on_response_reset(sid)
            return True
        return True
