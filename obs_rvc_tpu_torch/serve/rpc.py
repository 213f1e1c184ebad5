"""The plugin's reference RPC protocol (counterpart of
``obs_rvc_tpu/serve/rpc.py``; the same bytes on the wire), little-endian::

    request:  [num_samples: u32][num_samples x f32]
              [sample_frame_16k_size: u32][pitch_shift: i32]
              [skip_head: u32][return_length: u32]
    response: [num_samples: u32][num_samples x f32]

Served over stdin/stdout (a drop-in for the plugin's ``rvc-rpc`` child) or
TCP. On an engine error the reply is a zero-length payload: the plugin treats
it as an I/O error and respawns its child.

    python -m obs_rvc_tpu_torch.serve.rpc --port 17895          # the card
    python -m obs_rvc_tpu_torch.serve.rpc --stdio --device cpu

This standalone server computes in float32, as the JAX package's does;
``serve.server``'s RPC door computes in the server's ``--dtype``.
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys
import threading
from typing import BinaryIO, Callable, Optional

import numpy as np

from obs_rvc_tpu_torch.serve.stream_server import _read_exact
from obs_rvc_tpu_torch.stream.engine import EngineError, RvcEngine


def serve_stream(engine: RvcEngine, rin: BinaryIO, rout: BinaryIO) -> None:
    """Answer requests until the peer closes."""
    while True:
        try:
            (n,) = struct.unpack("<I", _read_exact(rin, 4))
        except EOFError:
            return
        samples = np.frombuffer(_read_exact(rin, 4 * n), dtype="<f4").copy()
        n16k, pitch, skip, ret = struct.unpack("<IiII", _read_exact(rin, 16))
        try:
            out = engine.infer(samples, n16k, pitch, skip, ret)
        except EngineError as e:
            print(f"engine error: {e}", file=sys.stderr)
            rout.write(struct.pack("<I", 0))
            rout.flush()
            continue
        out = np.ascontiguousarray(out, dtype="<f4")
        rout.write(struct.pack("<I", out.size))
        rout.write(out.tobytes())
        rout.flush()


def serve_tcp(engine: RvcEngine, host: str, port: int, ready: Optional[Callable[[int], None]] = None,
              stop_event: Optional[threading.Event] = None) -> None:
    """One connection at a time, as the plugin holds one. ``ready(port)``
    fires once the socket listens (bind port 0 for a free port);
    ``stop_event`` ends the accept loop."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        bound = srv.getsockname()[1]
        print(f"rvc-rpc listening on {host}:{bound}", file=sys.stderr)
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
            print(f"client {addr}", file=sys.stderr)
            with conn, conn.makefile("rb") as rin, conn.makefile("wb") as rout:
                try:
                    serve_stream(engine, rin, rout)
                except (EOFError, ConnectionError):
                    pass


class RpcClient:
    """The plugin's side of the protocol."""

    def __init__(self, rin: BinaryIO, rout: BinaryIO):
        self._rin = rin
        self._rout = rout

    @staticmethod
    def connect_tcp(host: str, port: int, timeout: Optional[float] = None) -> "RpcClient":
        sock = socket.create_connection((host, port), timeout=timeout)
        return RpcClient(sock.makefile("rb"), sock.makefile("wb"))

    def infer(self, samples: np.ndarray, sample_frame_16k_size: int, pitch_shift: int, skip_head: int,
              return_length: int) -> np.ndarray:
        samples = np.ascontiguousarray(samples, dtype="<f4")
        self._rout.write(struct.pack("<I", samples.size))
        self._rout.write(samples.tobytes())
        self._rout.write(struct.pack("<IiII", sample_frame_16k_size, pitch_shift, skip_head, return_length))
        self._rout.flush()
        (n,) = struct.unpack("<I", _read_exact(self._rin, 4))
        if n == 0:
            raise EngineError("server reported engine error")
        return np.frombuffer(_read_exact(self._rin, 4 * n), dtype="<f4").copy()

    def close(self) -> None:
        self._rout.close()
        self._rin.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rvc-rpc server on the PyTorch port")
    p.add_argument("--stdio", action="store_true", help="serve on stdin/stdout")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=17895)
    p.add_argument("--model-version", default="v2", choices=["v1", "v2"])
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--dest-sample-rate", type=int, default=40000)
    p.add_argument("--checkpoint", help="RVC .pth checkpoint (random weights from seed 0 if omitted)")
    p.add_argument("--exec-cache", action="store_true", help="not ported (ROADMAP.md queue 1 item 14)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.exec_cache:
        raise SystemExit("--exec-cache is not ported (ROADMAP.md queue 1 item 14)")

    from obs_rvc_tpu_torch.config import RvcModelVersion, StreamSettings
    from obs_rvc_tpu_torch.models.checkpoints import load_pipeline_params
    from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline

    settings = StreamSettings(model_version=RvcModelVersion.from_str(args.model_version),
                              dest_sample_rate=args.dest_sample_rate)
    pipe = RvcPipeline(settings.chunk_config(args.sample_rate), settings.model_version, device=args.device)
    load_pipeline_params(pipe, synthesizer_path=args.checkpoint)
    engine = RvcEngine(pipe)
    if args.stdio:
        serve_stream(engine, sys.stdin.buffer, sys.stdout.buffer)
    else:
        serve_tcp(engine, args.host, args.port)


if __name__ == "__main__":
    main()
