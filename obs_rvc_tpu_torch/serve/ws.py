"""WebSocket front door for the duplex PCM protocol (counterpart of
``obs_rvc_tpu/serve/ws.py``; the same bytes on the wire).

One tag-framed protocol message of :mod:`stream_server` per binary WebSocket
message, so browser clients can stream without a raw TCP socket. RFC 6455 on
the standard library: the HTTP/1.1 Upgrade handshake, client-masked frames,
fragment reassembly, ping/pong and close.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import sys
import threading
from typing import BinaryIO, Callable, Optional

import numpy as np

from obs_rvc_tpu_torch.serve.stream_server import (
    TAG_AUDIO,
    TAG_CONTROL,
    _read_exact,
    encode_audio_message,
    handle_message,
    session_for,
)

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def ws_accept_key(client_key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``: SHA-1 of
    the key and the RFC's GUID, base64 (RFC 6455 section 4.2.2)."""
    return base64.b64encode(hashlib.sha1((client_key + _WS_GUID).encode()).digest()).decode()


def _read_http_headers(rin: BinaryIO) -> tuple[str, dict]:
    """The request or status line and the headers, up to the blank line."""
    data = b""
    while not data.endswith(b"\r\n\r\n"):
        b1 = rin.read(1)
        if not b1:
            raise EOFError("connection closed during handshake")
        data += b1
        if len(data) > 65536:
            raise ValueError("oversized handshake")
    lines = data.decode("latin-1").split("\r\n")
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers


def server_handshake(rin: BinaryIO, rout: BinaryIO) -> None:
    request_line, headers = _read_http_headers(rin)
    if "websocket" not in headers.get("upgrade", "").lower():
        rout.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        rout.flush()
        raise ValueError(f"not a websocket upgrade: {request_line!r}")
    key = headers.get("sec-websocket-key")
    if not key:
        rout.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        rout.flush()
        raise ValueError("missing Sec-WebSocket-Key")
    rout.write((
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {ws_accept_key(key)}\r\n\r\n"
    ).encode())
    rout.flush()


def client_handshake(rin: BinaryIO, rout: BinaryIO, host: str, path: str = "/") -> None:
    key = base64.b64encode(os.urandom(16)).decode()
    rout.write((
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    ).encode())
    rout.flush()
    status_line, headers = _read_http_headers(rin)
    if " 101 " not in status_line + " ":
        raise ValueError(f"handshake rejected: {status_line!r}")
    if headers.get("sec-websocket-accept") != ws_accept_key(key):
        raise ValueError("bad Sec-WebSocket-Accept")


def _apply_mask(data: bytes, mkey: bytes) -> bytes:
    mask = np.frombuffer((mkey * (len(data) // 4 + 1))[: len(data)], dtype=np.uint8)
    return (np.frombuffer(data, dtype=np.uint8) ^ mask).tobytes()


def write_frame(rout: BinaryIO, opcode: int, payload: bytes, mask: bool = False) -> None:
    """One unfragmented frame (FIN set). Clients must mask (RFC 6455 5.3)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < 1 << 16:
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        mkey = os.urandom(4)
        rout.write(head + mkey + _apply_mask(payload, mkey))
    else:
        rout.write(head + payload)
    rout.flush()


def read_frame(rin: BinaryIO) -> tuple[int, bytes]:
    """One message, continuation fragments reassembled: ``(opcode, payload)``.
    Control frames are returned as they come; the caller answers them."""
    opcode = None
    payload = b""
    while True:
        b0, b1 = _read_exact(rin, 2)
        fin, op = b0 & 0x80, b0 & 0x0F
        masked, n = b1 & 0x80, b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", _read_exact(rin, 2))
        elif n == 127:
            (n,) = struct.unpack(">Q", _read_exact(rin, 8))
        mkey = _read_exact(rin, 4) if masked else None
        data = _read_exact(rin, n)
        if mkey:
            data = _apply_mask(data, mkey)
        if op & 0x8:  # control frames are never fragmented
            return op, data
        if op != 0:
            opcode = op
        payload += data
        if fin:
            return opcode, payload


def serve_ws_connection(session, rin: BinaryIO, rout: BinaryIO) -> None:
    """After the handshake: each binary message is one duplex protocol
    message, each reply goes back as a binary message."""
    session.start()
    try:
        while True:
            try:
                op, payload = read_frame(rin)
            except EOFError:
                return
            if op == OP_PING:
                write_frame(rout, OP_PONG, payload)
                continue
            if op == OP_CLOSE:
                write_frame(rout, OP_CLOSE, payload[:2])
                return
            if op not in (OP_BINARY, OP_TEXT) or not payload:
                continue
            reply, closed = handle_message(session, payload)
            if reply is not None:
                write_frame(rout, OP_BINARY, reply)
            if closed:
                write_frame(rout, OP_CLOSE, struct.pack(">H", 1000))
                return
    finally:
        session.stop()


def serve_ws_tcp(make_session: Callable, host: str, port: int,
                 ready: Optional[Callable[[int], None]] = None,
                 stop_event: Optional[threading.Event] = None, pool=None) -> None:
    """WebSocket accept loop, a session (with ``pool``: a slot of it; a
    connection past its capacity is closed) and a thread per connection, with
    ``ready``/``stop_event`` as in :func:`stream_server.serve_tcp`."""
    from obs_rvc_tpu_torch.stream.pool import PoolFullError

    def handle(conn, addr):
        print(f"ws client {addr}", file=sys.stderr)
        with conn, conn.makefile("rb") as rin, conn.makefile("wb") as rout:
            try:
                server_handshake(rin, rout)
                serve_ws_connection(session_for(make_session, pool), rin, rout)
            except (EOFError, ConnectionError, ValueError):
                pass
            except PoolFullError as e:
                print(f"rejecting {addr}: {e}", file=sys.stderr)

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        bound = srv.getsockname()[1]
        print(f"ws stream server on {host}:{bound}", file=sys.stderr)
        if ready is not None:
            ready(bound)
        if stop_event is not None:
            srv.settimeout(0.2)
        while stop_event is None or not stop_event.is_set():
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            threading.Thread(target=handle, args=(conn, addr), daemon=True).start()


class WsStreamClient:
    """Client over WebSocket with the API of ``StreamClient``."""

    def __init__(self, rin: BinaryIO, rout: BinaryIO):
        self._rin = rin
        self._rout = rout

    @staticmethod
    def connect(host: str, port: int, timeout: Optional[float] = None) -> "WsStreamClient":
        sock = socket.create_connection((host, port), timeout=timeout)
        rin, rout = sock.makefile("rb"), sock.makefile("wb")
        client_handshake(rin, rout, f"{host}:{port}")
        return WsStreamClient(rin, rout)

    def send_audio(self, frame: np.ndarray) -> np.ndarray:
        write_frame(self._rout, OP_BINARY, encode_audio_message(frame), mask=True)
        while True:
            op, payload = read_frame(self._rin)
            if op == OP_BINARY and payload and payload[0] == TAG_AUDIO:
                (n,) = struct.unpack("<I", payload[1:5])
                return np.frombuffer(payload[5 : 5 + 4 * n], dtype="<f4").copy()
            if op == OP_CLOSE:
                raise EOFError("server closed")

    def update_controls(self, **updates) -> None:
        payload = json.dumps(updates).encode()
        write_frame(self._rout, OP_BINARY, bytes([TAG_CONTROL]) + struct.pack("<I", len(payload)) + payload,
                    mask=True)

    def close(self) -> None:
        try:
            write_frame(self._rout, OP_CLOSE, struct.pack(">H", 1000), mask=True)
        except (OSError, ValueError):
            pass
