"""Wire identity of the port's front doors with the JAX package's, and the
server and CLI entry points, on the CPU.

- RPC: the same request and reply bytes from both packages' clients and
  servers, the zero-length reply on an engine error included; the JAX
  ``RpcClient`` against the port's TCP server.
- Duplex stream and WebSocket: the JAX clients, unchanged, against the
  port's servers in the passthrough geometry (``skip_inference``); a 440 Hz
  tone comes back (FFT peak within 7 Hz).
- WebSocket framing: the RFC 6455 accept-key vector and frames of every
  length class, each package reading the other's.
- ``serve.server``: the pipeline from flags, flags of unported modules exit
  naming their ROADMAP.md item, and ``main`` serves all four doors.
- ``serve.cli``: ``--skip-inference`` writes the samples the JAX CLI writes.

Every socket binds port 0 (or a free port found that way), every read has a
timeout and every thread is joined with one.
"""

import io
import json
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.serve import rpc as jrpc
from obs_rvc_tpu.serve import ws as jws
from obs_rvc_tpu.serve.stream_server import StreamClient as JStreamClient
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.utils import write_wav as j_write_wav

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.serve import rpc, server, ws
from obs_rvc_tpu_torch.serve import cli
from obs_rvc_tpu_torch.serve.stream_server import StreamClient, serve_tcp
from obs_rvc_tpu_torch.stream import EngineError, RvcPipeline, StepControls, StreamSession
from obs_rvc_tpu_torch.utils import read_wav, write_wav

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

SMALL = ["--sample-length", "0.10", "--extra-inference-time", "0.5"]
TIMEOUT = 30.0


class FakeEngine:
    """Doubles the first 100 samples; a request with pitch 99 fails."""

    def __init__(self, error):
        self.error = error

    def infer(self, samples, n16k, pitch, skip, ret):
        assert samples.dtype == np.float32
        if pitch == 99:
            raise self.error("refused")
        return samples[:100] * 2.0 + n16k + pitch + skip + ret


def _request_bytes(client_cls, samples, *args):
    out = io.BytesIO()
    client = client_cls(io.BytesIO(struct.pack("<I", 0)), out)
    with pytest.raises(Exception):  # the empty reply ends the call
        client.infer(samples, *args)
    return out.getvalue()


def test_rpc_bytes_are_identical_in_both_directions():
    samples = np.random.default_rng(0).standard_normal(3200).astype(np.float32)
    req = _request_bytes(rpc.RpcClient, samples, 1600, -12, 50, 15)
    assert req == _request_bytes(jrpc.RpcClient, samples, 1600, -12, 50, 15)
    req_err = _request_bytes(rpc.RpcClient, samples, 1600, 99, 50, 15)
    replies = []
    for serve, err in ((rpc.serve_stream, EngineError), (jrpc.serve_stream, jrpc.EngineError)):
        out = io.BytesIO()
        serve(FakeEngine(err), io.BytesIO(req + req_err + req), out)
        replies.append(out.getvalue())
    assert replies[0] == replies[1]
    assert replies[0][4 + 400 : 4 + 400 + 4] == b"\x00\x00\x00\x00"  # the zero-length error reply
    client = rpc.RpcClient(io.BytesIO(replies[0]), io.BytesIO())
    np.testing.assert_array_equal(client.infer(samples, 1600, -12, 50, 15), samples[:100] * 2.0 + 1653)
    with pytest.raises(EngineError):
        client.infer(samples, 1600, 99, 50, 15)


def _serve_in_thread(target, *args):
    """Run an accept loop on a thread; returns (bound port, stop event, thread)."""
    stop, bound = threading.Event(), []
    listening = threading.Event()

    def ready(p):
        bound.append(p)
        listening.set()

    t = threading.Thread(target=target, args=args, kwargs=dict(ready=ready, stop_event=stop), daemon=True)
    t.start()
    assert listening.wait(TIMEOUT)
    return bound[0], stop, t


def test_jax_rpc_client_against_the_port_tcp_server():
    port, stop, t = _serve_in_thread(rpc.serve_tcp, FakeEngine(EngineError), "127.0.0.1", 0)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        with sock, sock.makefile("rb") as rin, sock.makefile("wb") as rout:
            client = jrpc.RpcClient(rin, rout)
            x = np.arange(500, dtype=np.float32)
            np.testing.assert_array_equal(client.infer(x, 1600, 3, 50, 15), x[:100] * 2.0 + 1668)
            with pytest.raises(jrpc.EngineError):
                client.infer(x, 1600, 99, 50, 15)
            np.testing.assert_array_equal(client.infer(x, 3200, 0, 1, 2), x[:100] * 2.0 + 3203)
    finally:
        stop.set()
        t.join(TIMEOUT)
    assert not t.is_alive()


def _tone_through(send_audio, cfg, frames=8):
    sr, f = 48000, 440.0
    n = frames * cfg.sample_frame_size
    wav = np.sin(2 * np.pi * f * np.arange(n) / sr).astype(np.float32)
    out, total = [], 0
    for i in range(0, n, 2400):
        got = send_audio(wav[i : i + 2400])
        out.append(got)
        total += got.size
        time.sleep(0.002)
    deadline = time.monotonic() + 60
    while total < 5 * cfg.sample_frame_size and time.monotonic() < deadline:
        got = send_audio(np.zeros(2400, np.float32))
        out.append(got)
        total += got.size
        time.sleep(0.01)
    got = np.concatenate(out)
    assert got.size >= 5 * cfg.sample_frame_size
    tail = got[2 * cfg.sample_frame_size : 5 * cfg.sample_frame_size]
    spec = np.abs(np.fft.rfft(tail * np.hanning(tail.size)))
    assert abs(np.argmax(spec) * sr / tail.size - f) < 7.0


@pytest.fixture(scope="module")
def passthrough():
    return RvcPipeline(ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50, skip_inference=True),
                       device="cpu")


def test_jax_stream_client_against_the_port_duplex_server(passthrough):
    sessions = []

    def make_session():
        sessions.append(StreamSession(passthrough))
        return sessions[-1]

    port, stop, t = _serve_in_thread(serve_tcp, make_session, "127.0.0.1", 0)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        with sock, sock.makefile("rb") as rin, sock.makefile("wb") as rout:
            client = JStreamClient(rin, rout)
            client.update_controls(pitch_shift=3.0, rms_mix_rate=1.0)
            _tone_through(client.send_audio, passthrough.cfg)
            client.close()
    finally:
        stop.set()
        t.join(TIMEOUT)
    assert not t.is_alive()
    assert sessions[0].controls.pitch_shift == 3.0
    assert sessions[0].metrics.snapshot().chunks >= 5


def test_jax_ws_client_against_the_port_ws_server(passthrough):
    sessions = []

    def make_session():
        sessions.append(StreamSession(passthrough))
        return sessions[-1]

    port, stop, t = _serve_in_thread(ws.serve_ws_tcp, make_session, "127.0.0.1", 0)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        with sock, sock.makefile("rb") as rin, sock.makefile("wb") as rout:
            jws.client_handshake(rin, rout, f"127.0.0.1:{port}")
            client = jws.WsStreamClient(rin, rout)
            client.update_controls(pitch_shift=2.0)
            _tone_through(client.send_audio, passthrough.cfg, frames=6)
            client.close()
    finally:
        stop.set()
        t.join(TIMEOUT)
    assert not t.is_alive()
    assert sessions[0].controls.pitch_shift == 2.0


def test_ws_accept_key_rfc_vector():
    # RFC 6455 section 1.3's worked example
    assert ws.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("size", [0, 1, 125, 126, 65535, 65536])
@pytest.mark.parametrize("mask", [False, True])
def test_ws_frames_cross_read(size, mask):
    payload = bytes(i % 251 for i in range(size))
    for write, read in ((ws.write_frame, ws.read_frame), (ws.write_frame, jws.read_frame),
                        (jws.write_frame, ws.read_frame)):
        buf = io.BytesIO()
        write(buf, ws.OP_BINARY, payload, mask=mask)
        head = buf.getvalue()[: 2 + (2 if 126 <= size < 65536 else 8 if size >= 65536 else 0)]
        buf.seek(0)
        assert read(buf) == (ws.OP_BINARY, payload)
        ref = io.BytesIO()
        jws.write_frame(ref, ws.OP_BINARY, payload, mask=mask)
        assert ref.getvalue().startswith(head)  # the same header bytes
    if not mask:
        a, b = io.BytesIO(), io.BytesIO()
        ws.write_frame(a, ws.OP_BINARY, payload)
        jws.write_frame(b, ws.OP_BINARY, payload)
        assert a.getvalue() == b.getvalue()


def test_ws_fragments_and_refusals():
    buf = io.BytesIO(bytes([0x02, 3]) + b"abc" + bytes([0x80, 3]) + b"def")  # FIN=0 binary, FIN=1 continuation
    assert ws.read_frame(buf) == (ws.OP_BINARY, b"abcdef")
    rout = io.BytesIO()
    with pytest.raises(ValueError):
        ws.server_handshake(io.BytesIO(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"), rout)
    assert rout.getvalue().startswith(b"HTTP/1.1 400")


def test_server_builds_the_pipeline_from_flags():
    args = server.build_parser().parse_args(
        ["--skip-inference", "--pitch-shift", "4", "--loudness-factor", "0.7", "--speaker-id", "2",
         "--device", "cpu", *SMALL])
    pipe, controls = server.build_pipeline(args)
    assert pipe.cfg.skip_inference and pipe.device.type == "cpu"
    assert pipe.cfg.sample_frame_size == 4800 and pipe.modules() == {}
    assert controls == StepControls.default(pitch_shift=4.0, rms_mix_rate=0.7, sid=2)
    assert args.dtype == "bfloat16" and pipe.compute_dtype == torch.bfloat16  # the JAX server's default


@pytest.mark.parametrize("flags,item", [
    (["--pool", "4"], "item 10"),
    (["--pool-pipelined"], "item 10"),
    (["--pool-io-dtype", "int16"], "item 10"),
    (["--mesh", "data=4"], "item 13"),
    (["--index", "v.index"], "item 12"),
    (["--index-mode", "ivf"], "item 12"),
    (["--pitch-algorithm", "crepe"], "item 11"),
    (["--pitch-algorithm", "fcpe"], "item 11"),
    (["--no-pallas-resblocks"], "refused"),
])
def test_unported_server_flags_exit_naming_their_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        server.main(["--device", "cpu", "--skip-inference", *flags])


def test_server_defaults_to_bf16_and_the_cli_to_float32():
    """The JAX entry points' defaults: ``serve.server --dtype bfloat16``,
    ``serve.cli --dtype float32``."""
    assert server.build_parser().parse_args([]).dtype == "bfloat16"
    assert cli.build_parser().parse_args(["in.wav", "out.wav"]).dtype == "float32"
    pipe, _ = cli.pipeline_from_args(cli.build_parser().parse_args(
        ["in.wav", "out.wav", "--skip-inference", "--device", "cpu", *SMALL]), 48000)
    assert pipe.compute_dtype == torch.float32


@pytest.mark.parametrize("entry", ["server", "cli"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_points_accept_either_dtype(entry, dtype):
    argv = ["--skip-inference", "--device", "cpu", "--dtype", dtype, *SMALL]
    if entry == "server":
        pipe, _ = server.build_pipeline(server.build_parser().parse_args(argv))
    else:
        pipe, _ = cli.pipeline_from_args(cli.build_parser().parse_args(["in.wav", "out.wav", *argv]), 48000)
    assert pipe.compute_dtype == getattr(torch, dtype)


def test_cli_converts_with_v1_in_bf16_at_reduced_widths(tmp_path, monkeypatch):
    """``serve.cli --model-version v1 --dtype bfloat16`` end to end, with the
    networks' default configs swapped for reduced ones (v1: ContentVec's final
    projection to 32 features, the synthesizer taking 32)."""
    from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
    from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
    from obs_rvc_tpu_torch.stream import pipeline as pipeline_mod

    from test_torch_port_pipeline import CV, RM, SY

    monkeypatch.setattr(ContentVecConfig, "v1", staticmethod(lambda: ContentVecConfig(**dict(CV, out_dim=32,
                                                                                            final_proj=True))))
    monkeypatch.setattr(pipeline_mod, "RMVPEConfig", lambda: RMVPEConfig(**RM))
    monkeypatch.setattr(SynthesizerConfig, "for_sample_rate",
                        staticmethod(lambda sr, feature_dim=768: SynthesizerConfig(**dict(SY, feature_dim=feature_dim))))
    made = []
    real = cli.pipeline_from_args
    monkeypatch.setattr(cli, "pipeline_from_args", lambda *a: made.append(real(*a)) or made[-1])
    sr = 48000
    t = np.arange(int(0.45 * sr)) / sr
    write_wav(tmp_path / "in.wav", (0.3 * np.sin(2 * np.pi * 180 * t))[None].astype(np.float32), sr)
    cli.main([str(tmp_path / "in.wav"), str(tmp_path / "out.wav"), "--model-version", "v1", "--dtype", "bfloat16",
              "--device", "cpu", *SMALL])
    pipe = made[0][0]
    assert pipe.compute_dtype == torch.bfloat16 and pipe.contentvec.final_proj.out_features == 32
    assert all(p.dtype == torch.bfloat16 for m in pipe.modules().values() for p in m.parameters())
    got, got_sr = read_wav(tmp_path / "out.wav")
    assert got_sr == sr and got.shape == (1, 4 * 4800) and np.isfinite(got).all() and np.abs(got).max() > 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", [[], ["--step-mode", "fused", "--exec-cache"]])
def test_server_main_serves_every_front_door(passthrough, mode):
    ports = {name: _free_port() for name in ("duplex", "ws", "rpc", "health")}
    stop, got = threading.Event(), {}
    listening = threading.Event()

    def ready(bound):
        got.update(bound)
        listening.set()

    argv = ["--skip-inference", "--device", "cpu", *SMALL, "--port", str(ports["duplex"]),
            "--ws-port", str(ports["ws"]), "--rpc-port", str(ports["rpc"]),
            "--health-port", str(ports["health"]), *mode]
    t = threading.Thread(target=server.main, args=(argv,), kwargs=dict(ready=ready, stop_event=stop),
                         daemon=True)
    t.start()
    try:
        assert listening.wait(TIMEOUT) and got == ports
        client = StreamClient.connect_tcp("127.0.0.1", ports["duplex"], timeout=TIMEOUT)
        _tone_through(client.send_audio, passthrough.cfg)
        client.close()
        wsc = ws.WsStreamClient.connect("127.0.0.1", ports["ws"], timeout=TIMEOUT)
        assert wsc.send_audio(np.zeros(2400, np.float32)).dtype == np.float32
        wsc.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['health']}/metrics", timeout=TIMEOUT) as r:
            metrics = json.loads(r.read())
        assert metrics["chunks"] >= 5 and metrics["errors"] == 0
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['health']}/healthz", timeout=TIMEOUT) as r:
            assert r.read() == b"ok"
        # the RPC door answers (a passthrough pipeline has no networks: an engine error reply)
        rc = rpc.RpcClient.connect_tcp("127.0.0.1", ports["rpc"], timeout=TIMEOUT)
        with pytest.raises(EngineError):
            rc.infer(np.zeros(17, np.float32), 1600, 0, 50, 15)
        rc.close()
    finally:
        stop.set()
        t.join(TIMEOUT)
    assert not t.is_alive()


def test_rpc_request_to_a_passthrough_server_leaves_the_other_doors_serving(passthrough):
    """A passthrough server's pipeline has no networks: an RPC request at
    its own geometry gets the zero-length error reply, on a connection that
    stays open, and the duplex door goes on converting."""
    ports = {name: _free_port() for name in ("duplex", "rpc")}
    stop, listening = threading.Event(), threading.Event()
    argv = ["--skip-inference", "--device", "cpu", *SMALL, "--port", str(ports["duplex"]),
            "--rpc-port", str(ports["rpc"])]
    t = threading.Thread(target=server.main, args=(argv,),
                         kwargs=dict(ready=lambda b: listening.set(), stop_event=stop), daemon=True)
    t.start()
    try:
        assert listening.wait(TIMEOUT)
        cfg = passthrough.cfg
        x = np.zeros(cfg.input_buffer_16k_size, np.float32)
        rc = rpc.RpcClient.connect_tcp("127.0.0.1", ports["rpc"], timeout=TIMEOUT)
        for _ in range(2):
            with pytest.raises(EngineError):
                rc.infer(x, cfg.sample_frame_16k_size, 0, cfg.skip_head, cfg.return_length)
        rc.close()
        assert not stop.is_set()
        client = StreamClient.connect_tcp("127.0.0.1", ports["duplex"], timeout=TIMEOUT)
        _tone_through(client.send_audio, cfg)
        client.close()
    finally:
        stop.set()
        t.join(TIMEOUT)
    assert not t.is_alive()


def test_cli_skip_inference_writes_the_jax_cli_samples(tmp_path):
    rng = np.random.default_rng(0)
    sr = 48000
    t = np.arange(int(0.75 * sr)) / sr
    audio = np.stack([0.4 * np.sin(2 * np.pi * 330 * t), 0.1 * rng.standard_normal(t.size)]).astype(np.float32)
    write_wav(tmp_path / "in.wav", audio, sr)
    cli.main([str(tmp_path / "in.wav"), str(tmp_path / "out.wav"), "--skip-inference", "--device", "cpu",
              "--metrics-json", *SMALL])
    got, got_sr = read_wav(tmp_path / "out.wav")
    # what the JAX CLI computes for these flags: read, downmix, convert_offline, upmix, write
    mono, _ = read_wav(tmp_path / "in.wav")
    jcfg = JChunkConfig.build(sample_rate=sr, sample_length=0.10, extra_inference_time=0.5, skip_inference=True)
    controls = JControls.default(rms_mix_rate=0.5)  # the CLI's default --loudness-factor
    want = np.asarray(JPipeline(jcfg).convert_offline({}, jnp.asarray(mono.mean(axis=0).astype(np.float32)),
                                                      controls))
    j_write_wav(tmp_path / "want.wav", np.broadcast_to(want, (2, want.size)).copy(), sr)
    ref, _ = read_wav(tmp_path / "want.wav")
    assert got_sr == sr and got.shape == ref.shape == (2, 7 * 4800)
    # the two packages' float32 resampling and envelope sums differ by ~1e-6,
    # which moves the PCM16 rounding of a few samples by one step
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.5 / 32768)
    assert np.mean(got != ref) < 1e-3
    with pytest.raises(SystemExit, match="item 12"):
        cli.main([str(tmp_path / "in.wav"), str(tmp_path / "o.wav"), "--index", "v.index", "--device", "cpu"])
    with pytest.raises(SystemExit, match="item 13"):
        cli.main([str(tmp_path / "in.wav"), str(tmp_path / "o.wav"), "--mesh", "model=2", "--device", "cpu"])


def test_rpc_main_serves_stdio_at_reduced_widths(monkeypatch):
    """``python -m obs_rvc_tpu_torch.serve.rpc --stdio`` end to end, with the
    networks' default configs swapped for the reduced ones."""
    import sys
    import types

    from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
    from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
    from obs_rvc_tpu_torch.stream import pipeline as pipeline_mod

    from test_torch_port_pipeline import CV, RM, SY

    monkeypatch.setattr(ContentVecConfig, "v2", staticmethod(lambda: ContentVecConfig(**CV)))
    monkeypatch.setattr(pipeline_mod, "RMVPEConfig", lambda: RMVPEConfig(**RM))
    monkeypatch.setattr(SynthesizerConfig, "for_sample_rate",
                        staticmethod(lambda sr, feature_dim=768: SynthesizerConfig(**SY)))
    cfg = ChunkConfig.build()
    x = np.random.default_rng(1).standard_normal(cfg.input_buffer_16k_size).astype(np.float32) * 0.1
    req = _request_bytes(rpc.RpcClient, x, cfg.sample_frame_16k_size, 2, cfg.skip_head, cfg.return_length)
    stdout = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=io.BytesIO(req + req)))
    monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(buffer=stdout))
    rpc.main(["--stdio", "--device", "cpu"])
    client = rpc.RpcClient(io.BytesIO(stdout.getvalue()), io.BytesIO())
    for _ in range(2):
        y = client.infer(x, cfg.sample_frame_16k_size, 2, cfg.skip_head, cfg.return_length)
        assert y.shape == (cfg.return_length * 400,) and np.isfinite(y).all()
    # --exec-cache: the engine's graphs through cached_capture; the same replies
    stdout2 = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=io.BytesIO(req + req)))
    monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(buffer=stdout2))
    rpc.main(["--stdio", "--device", "cpu", "--exec-cache"])
    assert stdout2.getvalue() == stdout.getvalue()
