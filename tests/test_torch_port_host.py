"""The port's host-side pieces against the JAX package's: the stream state's
snapshot bytes (exact, in both directions), the ring buffers, the metrics
collector, the request geometry and the settings; and the WAV helpers."""

import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.config import PitchAlgorithm as JPitchAlgorithm
from obs_rvc_tpu.config import RvcModelVersion as JVersion
from obs_rvc_tpu.config import StreamSettings as JSettings
from obs_rvc_tpu.serve.metrics import ChunkMetrics as JMetrics
from obs_rvc_tpu.stream import StreamState as JState
from obs_rvc_tpu.utils import read_wav as j_read_wav

from obs_rvc_tpu_torch.config import ChunkConfig, PitchAlgorithm, RvcModelVersion, StreamSettings
from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics
from obs_rvc_tpu_torch.stream import StreamState
from obs_rvc_tpu_torch.stream.ringbuf import NativeRingBuffer, PyRingBuffer, make_ring_buffer, native_library
from obs_rvc_tpu_torch.utils import downmix_to_mono, read_wav, upmix_from_mono, write_wav

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

FIELDS = ("input_buffer", "input_buffer_16k", "sola_buffer", "cache_pitchf")


def _arrays(cfg, seed):
    rng = np.random.default_rng(seed)
    sizes = (cfg.input_buffer_size, cfg.input_buffer_16k_size, cfg.sola_buffer_frame_size, cfg.pitch_cache_len)
    return {k: rng.standard_normal(n).astype(np.float32) for k, n in zip(FIELDS, sizes)}


@pytest.mark.parametrize("geometry", [dict(), dict(sample_length=0.10, extra_inference_time=0.50)])
def test_state_bytes_are_the_jax_package_bytes(geometry):
    cfg = ChunkConfig.build(**geometry)
    arrs = _arrays(cfg, 11)
    port = StreamState(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    jax_state = JState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    assert port.to_bytes() == jax_state.to_bytes()
    # port bytes -> JAX, JAX bytes -> port
    back_j = JState.from_bytes(port.to_bytes())
    back_t = StreamState.from_bytes(jax_state.to_bytes(), device="cpu")
    for name, a in arrs.items():
        np.testing.assert_array_equal(np.asarray(getattr(back_j, name)), a)
        got = getattr(back_t, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), a)


def test_state_bytes_small_and_empty_arrays_roundtrip():
    """Arrays whose payloads take msgpack's fixed-size ext forms."""
    state = StreamState(*(torch.arange(n, dtype=torch.float32) for n in (1, 2, 3, 0)))
    back = JState.from_bytes(state.to_bytes())
    for name, n in zip(FIELDS, (1, 2, 3, 0)):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), np.arange(n, dtype=np.float32))
    again = StreamState.from_bytes(back.to_bytes(), device="cpu")
    assert [getattr(again, f).numel() for f in FIELDS] == [1, 2, 3, 0]


def test_state_from_bytes_rejects_other_data():
    with pytest.raises(ValueError):
        StreamState.from_bytes(b"\x91\x01", device="cpu")
    cfg = ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50)
    blob = StreamState.init(cfg, device="cpu").to_bytes()
    with pytest.raises(ValueError, match="truncated"):
        StreamState.from_bytes(blob[:-7], device="cpu")


@pytest.mark.parametrize("cls", [PyRingBuffer, NativeRingBuffer])
def test_ringbuffer_contract(cls):
    if cls is NativeRingBuffer and native_library() is None:
        pytest.skip("native/librvc_ringbuf.so is not built (make -C native)")
    rb = cls(1000)
    assert rb.capacity >= 1000 and (rb.capacity & (rb.capacity - 1)) == 0
    x = np.arange(300, dtype=np.float32)
    assert rb.push(x) == 300
    assert rb.available() == 300
    assert rb.pop_exact(400) is None  # not enough: nothing consumed
    np.testing.assert_array_equal(rb.pop_exact(200), x[:200])
    assert rb.available() == 100
    np.testing.assert_array_equal(rb.pop(500), x[200:300])  # partial pop
    assert rb.push(np.zeros(rb.capacity + 5, np.float32)) == rb.capacity  # full: the rest is refused
    assert rb.discard(10) == 10 and rb.available() == rb.capacity - 10


@pytest.mark.parametrize("cls", [PyRingBuffer, NativeRingBuffer])
def test_ringbuffer_wraparound_across_threads(cls):
    if cls is NativeRingBuffer and native_library() is None:
        pytest.skip("native/librvc_ringbuf.so is not built (make -C native)")
    rb = cls(1 << 12)
    total, chunk = 100_000, 997  # a prime size walks the wrap point around the ring

    def producer():
        sent = 0
        while sent < total:
            n = min(chunk, total - sent)
            sent += rb.push(np.arange(sent, sent + n, dtype=np.float32))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    received, got = [], 0
    deadline = threading.Event()
    timer = threading.Timer(60.0, deadline.set)
    timer.start()
    try:
        while got < total and not deadline.is_set():
            out = rb.pop(4096)
            if out.size:
                received.append(out)
                got += out.size
    finally:
        timer.cancel()
    t.join(timeout=10)
    assert not t.is_alive() and got == total
    np.testing.assert_array_equal(np.concatenate(received), np.arange(total, dtype=np.float32))


def test_make_ring_buffer_prefers_the_native_library():
    rb = make_ring_buffer(64)
    assert isinstance(rb, NativeRingBuffer if native_library() is not None else PyRingBuffer)


def test_metrics_match_the_jax_collector():
    port, ref = ChunkMetrics(chunk_seconds=0.3), JMetrics(chunk_seconds=0.3)
    for m in (port, ref):
        for v in [10.0, 20.0, 30.0, 40.0, 50.0, 7.5]:
            m.record(v)
        m.record_underrun()
        m.record_dropped(17)
        m.record_error()
        m.record_stages({"pre": 1.0, "post": 3.0})
        m.record_stages({"pre": 2.0, "post": 5.0})
    for got, want in ((port.snapshot().as_dict(), ref.snapshot().as_dict()),
                      (ChunkMetrics(0.3).snapshot().as_dict(), JMetrics(0.3).snapshot().as_dict())):
        # every field of the JAX snapshot, and besides them the port's spans and counters
        assert {k: got[k] for k in want} == want
        assert set(got) - set(want) == {"spans", "counters"}
    with port.time_chunk():
        pass
    assert port.snapshot().chunks == 7


@pytest.mark.parametrize("args", [
    (40960, 4800, 200, 35),
    (16000, 1600, 50, 15, 48000, 256, 44100),
])
def test_request_geometry_matches(args):
    assert ChunkConfig.for_request(*args).__dict__ == JChunkConfig.for_request(*args).__dict__
    with pytest.raises(ValueError, match="multiple of 160"):
        ChunkConfig.for_request(40960, 4801, 200, 35)


def test_settings_and_enums_match():
    for kw in (dict(), dict(dest_sample_rate=48000, sample_length=0.5, extra_inference_time=1.0,
                             model_version=RvcModelVersion.V1, skip_inference=True)):
        jkw = {**kw, "model_version": JVersion.V1} if "model_version" in kw else kw
        got, want = StreamSettings(**kw).chunk_config(44100), JSettings(**jkw).chunk_config(44100)
        assert got.__dict__ == want.__dict__
        assert got.latency_seconds == want.latency_seconds
    for s in ("v1", "V2", "v3"):
        assert RvcModelVersion.from_str(s).value == JVersion.from_str(s).value
    for s in ("rmvpe", "crepe", "FCPE", "other"):
        assert PitchAlgorithm.from_str(s).value == JPitchAlgorithm.from_str(s).value
        assert str(PitchAlgorithm.from_str(s)) == str(JPitchAlgorithm.from_str(s))
    for i in (1, 2, 3, 9):
        assert PitchAlgorithm.from_int(i).value == JPitchAlgorithm.from_int(i).value
    with pytest.raises(ValueError, match="feature frames"):
        ChunkConfig.for_request(16000, 1600, 90, 20).validate()


def test_wav_roundtrip_and_mixing(tmp_path):
    rng = np.random.default_rng(0)
    audio = np.clip(rng.standard_normal((2, 4800)) * 0.3, -0.99, 0.99).astype(np.float32)
    write_wav(tmp_path / "t.wav", audio, 48000)
    back, sr = read_wav(tmp_path / "t.wav")
    want, wsr = j_read_wav(tmp_path / "t.wav")
    assert sr == wsr == 48000 and back.shape == (2, 4800)
    np.testing.assert_array_equal(back, want)
    np.testing.assert_allclose(back, audio, atol=1.5 / 32768)
    mono = downmix_to_mono(audio)
    np.testing.assert_allclose(mono, audio.mean(axis=0), atol=1e-6)
    up = upmix_from_mono(mono, 2)
    assert up.shape == (2, 4800)
    np.testing.assert_array_equal(up[0], up[1])
