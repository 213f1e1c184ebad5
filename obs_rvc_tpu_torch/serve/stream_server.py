"""Duplex PCM streaming over TCP (counterpart of
``obs_rvc_tpu/serve/stream_server.py``; the same bytes on the wire).

The client streams device-rate mono frames of any size and gets converted
audio back; rings, resampling, SOLA and envelope mixing all run in the
server's :class:`~obs_rvc_tpu_torch.stream.scheduler.StreamSession`, one per
connection, whose worker thread keeps the socket loop off the device. With a
:class:`~obs_rvc_tpu_torch.stream.pool.StreamPool`, each connection claims
one of its slots instead, every voice batched through one step a tick; a
connection past the pool's capacity is closed.

Wire protocol (little-endian, tag-framed)::

    client -> server:
        0x01 [u32 n][n x f32]    audio frame (device-rate mono)
        0x02 [u32 len][JSON]     live control update
                                 {"pitch_shift": 12, "rms_mix_rate": .5, "index_rate": 0, "sid": 0}
        0x03                     flush/close
    server -> client (after each audio frame):
        0x01 [u32 n][n x f32]    converted audio available so far (n may be 0 while the pipeline fills)
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import threading
from typing import BinaryIO, Callable, Optional

import numpy as np

TAG_AUDIO = 1
TAG_CONTROL = 2
TAG_CLOSE = 3


def _read_exact(f: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = f.read(n - len(buf))
        if not got:
            raise EOFError
        buf += got
    return buf


def encode_audio_message(frame: np.ndarray) -> bytes:
    frame = np.ascontiguousarray(frame, dtype="<f4")
    return bytes([TAG_AUDIO]) + struct.pack("<I", frame.size) + frame.tobytes()


def handle_message(session, payload: bytes) -> tuple[Optional[bytes], bool]:
    """Apply one protocol message to a session: ``(reply or None, closed)``.
    Shared by the TCP loop and the WebSocket front door, which differ only in
    framing."""
    tag = payload[0]
    if tag == TAG_AUDIO:
        (n,) = struct.unpack("<I", payload[1:5])
        session.push_audio(np.frombuffer(payload[5 : 5 + 4 * n], dtype="<f4"))
        return encode_audio_message(session.pull_audio(n)), False
    if tag == TAG_CONTROL:
        (ln,) = struct.unpack("<I", payload[1:5])
        session.update_controls(**json.loads(payload[5 : 5 + ln]))
        return None, False
    if tag == TAG_CLOSE:
        return None, True
    raise ValueError(f"unknown tag {tag}")


def read_message(rin: BinaryIO) -> bytes:
    """One tag-framed message off a byte stream (raises EOFError)."""
    head = _read_exact(rin, 1)
    tag = head[0]
    if tag == TAG_CLOSE:
        return head
    if tag in (TAG_AUDIO, TAG_CONTROL):
        ln_raw = _read_exact(rin, 4)
        (n,) = struct.unpack("<I", ln_raw)
        return head + ln_raw + _read_exact(rin, 4 * n if tag == TAG_AUDIO else n)
    raise ValueError(f"unknown tag {tag}")


def serve_connection(session, rin: BinaryIO, rout: BinaryIO) -> None:
    """Serve one connection with its session, started here and stopped when
    the peer closes."""
    session.start()
    try:
        while True:
            try:
                msg = read_message(rin)
            except EOFError:
                return
            reply, closed = handle_message(session, msg)
            if reply is not None:
                rout.write(reply)
                rout.flush()
            if closed:
                return
    finally:
        session.stop()


class StreamClient:
    """Client side of the duplex protocol."""

    def __init__(self, rin: BinaryIO, rout: BinaryIO):
        self._rin = rin
        self._rout = rout

    @staticmethod
    def connect_tcp(host: str, port: int, timeout: Optional[float] = None) -> "StreamClient":
        sock = socket.create_connection((host, port), timeout=timeout)
        return StreamClient(sock.makefile("rb"), sock.makefile("wb"))

    def send_audio(self, frame: np.ndarray) -> np.ndarray:
        """Send one frame; returns the converted audio the server had ready."""
        self._rout.write(encode_audio_message(frame))
        self._rout.flush()
        tag = _read_exact(self._rin, 1)[0]
        if tag != TAG_AUDIO:
            raise ValueError(f"unexpected reply tag {tag}")
        (n,) = struct.unpack("<I", _read_exact(self._rin, 4))
        return np.frombuffer(_read_exact(self._rin, 4 * n), dtype="<f4").copy()

    def update_controls(self, **updates) -> None:
        payload = json.dumps(updates).encode()
        self._rout.write(bytes([TAG_CONTROL]) + struct.pack("<I", len(payload)) + payload)
        self._rout.flush()

    def close(self) -> None:
        try:
            self._rout.write(bytes([TAG_CLOSE]))
            self._rout.flush()
        except (OSError, ValueError):
            pass


class _PoolSlotAdapter:
    """One :class:`~obs_rvc_tpu_torch.stream.pool.StreamPool` slot with the
    session interface the connection loops use (start, stop, push, pull,
    update); stopping it detaches the slot."""

    def __init__(self, pool, slot: int):
        self._pool = pool
        self._slot = slot

    def start(self) -> None:
        pass  # the pool's worker serves every slot

    def stop(self) -> None:
        self._pool.detach(self._slot)

    def push_audio(self, frame: np.ndarray) -> int:
        return self._pool.push_audio(self._slot, frame)

    def pull_audio(self, n: int) -> np.ndarray:
        return self._pool.pull_audio(self._slot, n)

    def update_controls(self, **kw) -> None:
        self._pool.update_controls(self._slot, **kw)


def session_for(make_session: Callable, pool):
    """The connection's session: a slot of ``pool`` (raises
    :class:`~obs_rvc_tpu_torch.stream.pool.PoolFullError` when every slot is
    taken), or ``make_session()`` without one."""
    return _PoolSlotAdapter(pool, pool.attach()) if pool is not None else make_session()


def serve_tcp(make_session: Callable, host: str, port: int,
              ready: Optional[Callable[[int], None]] = None,
              stop_event: Optional[threading.Event] = None, pool=None) -> None:
    """Accept loop: each connection gets ``make_session()`` (with ``pool``, a
    started pool: a slot of it) and a thread. ``ready(port)`` fires once the
    socket listens (bind port 0 for a free port); ``stop_event`` ends the
    accept loop, and connections in flight finish on their threads."""
    from obs_rvc_tpu_torch.stream.pool import PoolFullError

    def handle(conn, addr):
        print(f"stream client {addr}", file=sys.stderr)
        with conn, conn.makefile("rb") as rin, conn.makefile("wb") as rout:
            try:
                serve_connection(session_for(make_session, pool), rin, rout)
            except (EOFError, ConnectionError):
                pass
            except PoolFullError as e:
                print(f"rejecting {addr}: {e}", file=sys.stderr)

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        bound = srv.getsockname()[1]
        print(f"stream server on {host}:{bound}", file=sys.stderr)
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
