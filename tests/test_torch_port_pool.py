"""The port's ``StreamPool`` (``stream/pool.py``) on the CPU: the counterparts
of the JAX pool tests (``tests/test_serving.py``, ``tests/test_coverage_extras.py``),
one pool run held slot by slot against the JAX ``StreamPool``, and the JAX
clients against the port's server with ``--pool``.

The passthrough geometry (no networks) at the JAX tests' small geometry
(0.10 s chunks, 0.5 s context): the batched step, the frozen-slot merge,
the epochs, the int16 wire and the pipelined ticks are the same code the
card runs, eagerly here (the graphs' copies and controls included).
"""

import dataclasses
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from obs_rvc_tpu.serve.stream_server import StreamClient as JStreamClient
from obs_rvc_tpu.serve.ws import WsStreamClient as JWsStreamClient
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StreamPool as JStreamPool

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.parallel.mesh import Mesh
from obs_rvc_tpu_torch.serve import server
from obs_rvc_tpu_torch.serve.stream_server import StreamClient, _PoolSlotAdapter, serve_connection
from obs_rvc_tpu_torch.stream import PoolFullError, RvcPipeline, StepControls, StreamPool, StreamState

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

SR = 48000
SMALL = ["--sample-length", "0.10", "--extra-inference-time", "0.5"]


def small_cfg(**kw):
    return ChunkConfig.build(sample_rate=SR, sample_length=0.10, extra_inference_time=0.50, **kw)


@pytest.fixture(scope="module")
def pipe():
    return RvcPipeline(small_cfg(skip_inference=True), device="cpu")


def rows(pool):
    return [getattr(pool._states, f.name) for f in dataclasses.fields(StreamState)]


def peak_hz(x, chunk):
    tail = x[2 * chunk :]
    spec = np.abs(np.fft.rfft(tail * np.hanning(tail.size)))
    return np.argmax(spec) * SR / tail.size


def test_pool_multi_voice_no_bleed(pipe):
    pool = StreamPool(pipe, capacity=3)
    s0, s1 = pool.attach(StepControls.default()), pool.attach(StepControls.default())
    assert {s0, s1} == {0, 1}
    chunk = pipe.cfg.sample_frame_size
    n = 6 * chunk
    t = np.arange(n) / SR
    wav0, wav1 = (np.sin(2 * np.pi * f * t).astype(np.float32) for f in (330.0, 550.0))
    for i in range(0, n, chunk):
        pool.push_audio(s0, wav0[i : i + chunk])
        pool.push_audio(s1, wav1[i : i + chunk])
        pool.process_pending()
    out0, out1 = pool.pull_audio(s0, n), pool.pull_audio(s1, n)
    assert out0.size >= 4 * chunk and out1.size >= 4 * chunk
    # each stream keeps its own tone
    assert abs(peak_hz(out0, chunk) - 330.0) < 6.0
    assert abs(peak_hz(out1, chunk) - 550.0) < 6.0
    # detach + reattach clears the slot
    pool.detach(s0)
    s2 = pool.attach()
    assert s2 == s0 and pool.pull_audio(s2, 100).size == 0
    assert all(not r[s0].any() for r in rows(pool))


def test_pool_full(pipe):
    pool = StreamPool(pipe, capacity=1)
    pool.attach()
    with pytest.raises(PoolFullError):
        pool.attach()
    with pytest.raises(ValueError, match="axes"):  # JAX's mesh check: a pool mesh has data and model axes
        StreamPool(pipe, capacity=2, mesh=Mesh(["cpu", "cpu"], ("rows",)))
    with pytest.raises(ValueError):
        StreamPool(pipe, capacity=1, mode="bogus")


def _run_one_slot(pipe, wav, n_chunks, starve_after=None, starve_ticks=0, **pool_kw):
    """Slot ``s`` streams ``wav`` while a second slot keeps the pool
    ticking; ``s`` gets no input for ``starve_ticks`` ticks after chunk
    ``starve_after``."""
    chunk = pipe.cfg.sample_frame_size
    pool = StreamPool(pipe, capacity=2, **pool_kw)
    s, other = pool.attach(), pool.attach()
    fed = ticks = 0
    while fed < n_chunks:
        starving = starve_after is not None and fed == starve_after and ticks < starve_ticks
        if not starving:
            pool.push_audio(s, wav[fed * chunk : (fed + 1) * chunk])
            fed += 1
        pool.push_audio(other, np.zeros(chunk, np.float32))
        ticks += 1
        pool.process_pending()
    pool.stop()
    assert pool.metrics.snapshot().errors == 0
    return pool.pull_audio(s, n_chunks * chunk)


def test_pool_starved_slot_freezes(pipe):
    """A starved active slot's state freezes: after stalling for several
    ticks its output is identical to an uninterrupted run."""
    n = 6
    wav = np.random.default_rng(0).standard_normal(n * pipe.cfg.sample_frame_size).astype(np.float32) * 0.1
    uninterrupted = _run_one_slot(pipe, wav, n)
    starved = _run_one_slot(pipe, wav, n, starve_after=3, starve_ticks=4)
    assert uninterrupted.size == n * pipe.cfg.sample_frame_size
    np.testing.assert_array_equal(starved, uninterrupted)


def test_pool_fused_matches_staged(pipe):
    """Fused mode (one graph a tick with the merge inside, shared through the
    exec cache) gives the staged pool's outputs, across a starved tick."""
    n = 4
    wav = np.random.default_rng(7).standard_normal(n * pipe.cfg.sample_frame_size).astype(np.float32) * 0.1
    staged = _run_one_slot(pipe, wav, n, starve_after=2, starve_ticks=3)
    fused = _run_one_slot(pipe, wav, n, starve_after=2, starve_ticks=3, mode="fused", exec_cache=True)
    np.testing.assert_allclose(fused, staged, atol=1e-6)
    a, b = StreamPool(pipe, capacity=2, mode="fused", exec_cache=True), StreamPool(pipe, capacity=2, mode="fused",
                                                                                   exec_cache=True)
    assert a._fused() is b._fused()  # one graph by key
    assert StreamPool(pipe, capacity=3, mode="fused", exec_cache=True)._fused() is not a._fused()


def test_pool_int16_wire_matches_float32(pipe):
    """``io_dtype="int16"``: within 1 LSB of int16 (both casts) of the float32 wire."""
    n = 3
    chunk = pipe.cfg.sample_frame_size
    wav = np.random.default_rng(11).standard_normal(n * chunk).astype(np.float32) * 0.1

    def run(io_dtype):
        pool = StreamPool(pipe, capacity=1, mode="fused", io_dtype=io_dtype)
        s = pool.attach()
        for i in range(n):
            pool.push_audio(s, wav[i * chunk : (i + 1) * chunk])
            pool.process_pending()
        assert pool.metrics.snapshot().errors == 0
        return pool.pull_audio(s, n * chunk)

    f32, i16 = run("float32"), run("int16")
    assert i16.size == f32.size > 0
    np.testing.assert_allclose(i16, f32, atol=1e-4)
    with pytest.raises(ValueError):
        StreamPool(pipe, capacity=1, mode="staged", io_dtype="int16")


def test_pool_pipelined_matches_sync(pipe):
    """Pipelined ticks deliver identical audio one tick late; covers a starved
    tick and the flush on stop."""
    n = 4
    chunk = pipe.cfg.sample_frame_size
    rng = np.random.default_rng(13)
    wavs = [rng.standard_normal(n * chunk).astype(np.float32) * 0.1 for _ in range(2)]

    def run(pipelined):
        pool = StreamPool(pipe, capacity=2, mode="fused", pipelined=pipelined)
        slots = [pool.attach() for _ in wavs]
        fed, ticks, lagged = [0, 0], 0, False
        while min(fed) < n:
            for k, s in enumerate(slots):
                starving = k == 0 and fed[0] == 2 and ticks == 2
                if not starving and fed[k] < n:
                    pool.push_audio(s, wavs[k][fed[k] * chunk : (fed[k] + 1) * chunk])
                    fed[k] += 1
            ticks += 1
            pool.process_pending()
            if pipelined and ticks == 1:
                lagged = pool.pull_audio(slots[0], chunk).size == 0
        assert lagged == pipelined
        pool.stop()  # flushes the stashed tick
        assert pool.metrics.snapshot().errors == 0
        return [pool.pull_audio(s, n * chunk) for s in slots]

    for a, b in zip(run(True), run(False)):
        assert a.size == b.size == n * chunk
        np.testing.assert_allclose(a, b, atol=1e-6)
    with pytest.raises(ValueError):
        StreamPool(pipe, capacity=1, mode="staged", pipelined=True)


def test_pool_pristine_attach_skips_state_write(pipe):
    """Attaching to never-stepped slots writes nothing to the resident state;
    a slot that carried state is zeroed on detach, the others untouched."""
    pool = StreamPool(pipe, capacity=3)
    before = [t._version for t in rows(pool)]
    a, b = pool.attach(), pool.attach()
    assert [t._version for t in rows(pool)] == before
    rng = np.random.default_rng(3)
    for s in (a, b):
        pool.push_audio(s, rng.standard_normal(pipe.cfg.sample_frame_size).astype(np.float32))
    pool.process_pending()
    assert any(r[a].any() for r in rows(pool))
    pool.detach(a)
    assert all(not r[a].any() for r in rows(pool))
    assert any(r[b].any() for r in rows(pool))


def _failing(pool, cfg):
    def boom(*a, **k):
        raise RuntimeError("injected failure")

    pool.pipeline = type("P", (), {"cfg": cfg, "staged_step": staticmethod(boom)})()


def test_pool_failure_is_observable_and_resets_fed_slots(pipe):
    """A failing batched step counts an error, emits silence for the fed
    slots and zeroes their state; a frozen slot keeps its context."""
    cfg = pipe.cfg
    pool = StreamPool(pipe, capacity=2)
    fed, frozen = pool.attach(), pool.attach()
    rng = np.random.default_rng(4)
    for s in (fed, frozen):
        pool.push_audio(s, rng.standard_normal(cfg.sample_frame_size).astype(np.float32))
    pool.process_pending()
    pool.pull_audio(fed, cfg.sample_frame_size)
    kept = [r[frozen].clone() for r in rows(pool)]
    _failing(pool, cfg)
    pool.push_audio(fed, np.ones(cfg.sample_frame_size, np.float32))
    assert pool.process_pending() == 1
    assert pool.metrics.errors == 1
    np.testing.assert_array_equal(pool.pull_audio(fed, cfg.sample_frame_size), 0.0)
    assert all(not r[fed].any() for r in rows(pool))
    for r, k in zip(rows(pool), kept):
        torch.testing.assert_close(r[frozen], k, rtol=0, atol=0)


def test_pool_failure_resets_the_only_slot(pipe):
    cfg = pipe.cfg
    pool = StreamPool(pipe, capacity=2)
    s0 = pool.attach()
    _failing(pool, cfg)
    pool.push_audio(s0, np.ones(cfg.sample_frame_size, np.float32))
    assert pool.process_pending() == 1
    np.testing.assert_array_equal(pool.pull_audio(s0, cfg.sample_frame_size), 0.0)


def test_pool_attach_detach_hammer(pipe):
    """Attach/detach churn on another thread while the worker ticks keeps the
    bookkeeping whole (the per-slot epochs)."""
    cfg = pipe.cfg
    pool = StreamPool(pipe, capacity=4, mode="fused")
    anchor = pool.attach()
    stop = threading.Event()
    errors = []

    def churn():
        try:
            while not stop.is_set():
                slot = pool.attach()
                pool.push_audio(slot, np.zeros(cfg.sample_frame_size, np.float32))
                pool.detach(slot)
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=churn)
    t.start()
    delivered = 0
    try:
        for _ in range(30):
            pool.push_audio(anchor, np.zeros(cfg.sample_frame_size, np.float32))
            pool.process_pending()
            delivered += pool.pull_audio(anchor, cfg.sample_frame_size).size
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and not errors
    assert pool.metrics.errors == 0
    assert delivered == 30 * cfg.sample_frame_size
    assert all(not r[1:].any() for r in rows(pool))  # every churned slot ends detached and zeroed


def test_pool_stale_epoch_fixup_deterministic(pipe):
    """A slot detached while the batched step computes comes out of the tick
    with zero state and no output; the other slot advances."""
    cfg = pipe.cfg
    pool = StreamPool(pipe)
    a, b = pool.attach(), pool.attach()
    rng = np.random.default_rng(7)
    for s in (a, b):
        pool.push_audio(s, rng.standard_normal(cfg.sample_frame_size).astype(np.float32))
    orig = pipe.staged_step

    def racing(*args, **kwargs):
        out = orig(*args, **kwargs)
        pool.detach(b)  # the epoch moves mid-tick, after the snapshot
        return out

    pipe.staged_step = racing
    try:
        assert pool.process_pending() == 2
    finally:
        del pipe.staged_step
    assert all(not r[b].any() for r in rows(pool))
    assert pool.pull_audio(b, cfg.sample_frame_size).size == 0
    assert any(r[a].any() for r in rows(pool))
    assert pool.pull_audio(a, cfg.sample_frame_size).size == cfg.sample_frame_size


def test_pool_batching_gate(pipe):
    """should_step waits for batch_min ready slots, or for batch_deadline_ms."""
    cfg = pipe.cfg
    pool = StreamPool(pipe, capacity=4, batch_min=2, batch_deadline_ms=50.0)
    a, b = pool.attach(), pool.attach()
    assert not pool.should_step(now=0.0)
    pool.push_audio(a, np.zeros(cfg.sample_frame_size, np.float32))
    assert not pool.should_step(now=0.0)
    assert not pool.should_step(now=0.040)
    assert pool.should_step(now=0.060)
    pool.push_audio(b, np.zeros(cfg.sample_frame_size, np.float32))
    assert pool.should_step(now=0.061)
    assert pool.process_pending() == 2
    assert not pool.should_step(now=0.062)


def test_pool_batch_min_capped_by_active(pipe):
    pool = StreamPool(pipe, capacity=4, batch_min=8)
    s = pool.attach()
    pool.push_audio(s, np.zeros(pipe.cfg.sample_frame_size, np.float32))
    assert pool.should_step(now=0.0)


def test_pool_default_controls_applied(pipe):
    ctl = StepControls.default(pitch_shift=4.0, rms_mix_rate=0.7, sid=2)
    pool = StreamPool(pipe, capacity=2, default_controls=ctl)
    s = pool.attach()
    assert pool._controls[s] == ctl
    s2 = pool.attach(StepControls.default(pitch_shift=-2.0))
    assert pool._controls[s2].pitch_shift == -2.0
    pool.update_controls(s2, rms_mix_rate=0.25, sid=1)
    assert pool._controls[s2] == StepControls.default(pitch_shift=-2.0, rms_mix_rate=0.25, sid=1)
    with pytest.raises(ValueError, match="unknown"):
        pool.update_controls(s2, volume=1.0)
    stacked = pool._controls_device(pool._controls, pool._controls_version)
    assert stacked.pitch_shift.tolist() == [4.0, -2.0] and stacked.sid.tolist() == [2, 1]


def test_pool_matches_the_jax_pool_slot_by_slot():
    """The same two streams, one starved for a tick, through the port's pool
    and the JAX ``StreamPool`` (both staged, passthrough, capacity 2)."""
    cfg = small_cfg(skip_inference=True)
    chunk, n = cfg.sample_frame_size, 5
    rng = np.random.default_rng(21)
    wavs = [rng.standard_normal(n * chunk).astype(np.float32) * 0.1 for _ in range(2)]
    pools = [StreamPool(RvcPipeline(cfg, device="cpu"), capacity=2), JStreamPool(JPipeline(cfg), params={}, capacity=2)]
    outs = []
    for pool in pools:
        slots = [pool.attach(), pool.attach()]
        fed, ticks = [0, 0], 0
        while min(fed) < n:
            for k, s in enumerate(slots):
                if not (k == 1 and fed[1] == 2 and ticks == 2) and fed[k] < n:
                    pool.push_audio(s, wavs[k][fed[k] * chunk : (fed[k] + 1) * chunk])
                    fed[k] += 1
            ticks += 1
            pool.process_pending()
        outs.append([pool.pull_audio(s, n * chunk) for s in slots])
    for got, want in zip(*outs):
        assert got.size == want.size == n * chunk
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_stream_connections_on_a_pool(pipe):
    """Two duplex connections batched through one started pool."""
    pool = StreamPool(pipe, capacity=2)
    pool.start()
    try:
        clients = []
        for _ in range(2):
            ssock, csock = socket.socketpair()
            adapter = _PoolSlotAdapter(pool, pool.attach())
            threading.Thread(target=serve_connection, args=(adapter, ssock.makefile("rb"), ssock.makefile("wb")),
                             daemon=True).start()
            clients.append(StreamClient(csock.makefile("rb"), csock.makefile("wb")))
        chunk = pipe.cfg.sample_frame_size
        n = 6 * chunk
        t = np.arange(n) / SR
        wavs = [np.sin(2 * np.pi * f * t).astype(np.float32) for f in (330.0, 550.0)]
        outs = [[], []]
        for i in range(0, n, chunk):
            for c, client in enumerate(clients):
                outs[c].append(client.send_audio(wavs[c][i : i + chunk]))
            time.sleep(0.02)
        deadline = time.monotonic() + 30
        while min(sum(o.size for o in out) for out in outs) < 5 * chunk and time.monotonic() < deadline:
            for c, client in enumerate(clients):
                outs[c].append(client.send_audio(np.zeros(chunk, np.float32)))
            time.sleep(0.02)
        for client in clients:
            client.close()
        for out, f in zip(outs, (330.0, 550.0)):
            got = np.concatenate(out)
            assert got.size >= 5 * chunk
            assert abs(peak_hz(got[: 5 * chunk], chunk) - f) < 12.0
    finally:
        pool.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_pool_serves_jax_clients_and_rejects_past_capacity():
    """``serve.server --pool 2``: the JAX duplex and WebSocket clients stream
    at once through the pool, a third connection is closed, and /metrics
    shows the pool's occupancy and no error."""
    ports = [_free_port() for _ in range(3)]
    argv = ["--device", "cpu", "--skip-inference", *SMALL, "--port", str(ports[0]), "--ws-port", str(ports[1]),
            "--health-port", str(ports[2]), "--pool", "2", "--step-mode", "fused", "--pool-io-dtype", "int16",
            "--pool-pipelined"]
    bound, listening, stop = {}, threading.Event(), threading.Event()

    def ready(b):
        bound.update(b)
        listening.set()

    t = threading.Thread(target=server.main, args=(argv,), kwargs=dict(ready=ready, stop_event=stop), daemon=True)
    t.start()
    try:
        assert listening.wait(60)
        clients = [JStreamClient.connect_tcp("127.0.0.1", bound["duplex"]),
                   JWsStreamClient.connect("127.0.0.1", bound["ws"])]
        frame, n = 2400, 12 * 2400
        tone = np.sin(2 * np.pi * 440.0 * np.arange(n) / SR).astype(np.float32)
        outs = [[], []]
        for i in range(0, n, frame):
            for c, client in enumerate(clients):
                outs[c].append(client.send_audio(tone[i : i + frame]))
            time.sleep(0.05)
        deadline = time.monotonic() + 30
        while min(sum(o.size for o in out) for out in outs) < 8 * frame and time.monotonic() < deadline:
            for c, client in enumerate(clients):
                outs[c].append(client.send_audio(np.zeros(frame, np.float32)))
            time.sleep(0.05)
        metrics = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{bound['health']}/metrics").read())
        third = JStreamClient.connect_tcp("127.0.0.1", bound["duplex"])
        with pytest.raises((EOFError, ConnectionError)):
            third.send_audio(np.zeros(frame, np.float32))
        for client in clients:
            client.close()
        for out in outs:
            got = np.concatenate(out)
            assert got.size >= 8 * frame
            assert abs(peak_hz(got[: 8 * frame], 2 * frame) - 440.0) < 12.0
        assert metrics["pool_capacity"] == 2 and metrics["pool_active"] == 2
        assert metrics["errors"] == 0 and metrics["chunks"] > 0
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()

