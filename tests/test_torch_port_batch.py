"""The port's batched step (``RvcPipeline.step(..., batched=True)``,
``jit_step_batch``, ``staged_step(..., batched=True)``) against the JAX
``jit_step_batch`` and against the port's own single-stream step; the
log-mel's stream axis, ``PolyphaseResampler`` and ``jit_convert_scan``.

Reduced widths as ``test_torch_port_pipeline.py``'s (the synthesizer with
``spk_embed_dim=4``), three streams with different voiced inputs and
different controls each (pitch shift, rms mix, speaker id). Bounds: the
step's, f0 relative 1e-4 and emitted audio 2e-3 absolute, against JAX and
against three single-stream port steps; the passthrough geometry (no
networks) 1e-5 against the single-stream steps; the log-mel the repo's
log-mel bound (2e-4 absolute, 1e-4 relative) against the JAX Pallas
kernel in interpret mode, stream by stream. CREPE and FCPE through the
batched step are in ``test_torch_port_pitch_step.py``, beside the JAX step
those tests compile.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.dsp.f0 import get_f0_post as j_get_f0_post
from obs_rvc_tpu.dsp.resample import PolyphaseResampler as JResampler
from obs_rvc_tpu.ops import log_mel_pallas
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamState as JState

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.dsp import MelSpectrogram, PolyphaseResampler, get_f0_post
from obs_rvc_tpu_torch.ops import stft_mel
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import _codes_distance, _make_pipes

#: per stream: (tone Hz, pitch shift, rms mix rate, speaker id)
STREAMS = [(150.0, 0.0, 1.0, 0), (180.0, 7.0, 0.3, 2), (230.0, -4.5, 0.6, 3)]


def voiced(n, sr, f0, seed):
    """A harmonic tone at ``f0`` with vibrato and a little noise."""
    t = np.arange(n) / sr
    f = f0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def stream_inputs(cfg, streams, n_chunks):
    """``[n_chunks, B, chunk]`` float32 and the per-stream control kwargs."""
    n = cfg.sample_frame_size
    wavs = np.stack([voiced(n_chunks * n, cfg.sample_rate, f, k) for k, (f, *_) in enumerate(streams)])
    chunks = wavs.reshape(len(streams), n_chunks, n).transpose(1, 0, 2)
    controls = [dict(pitch_shift=ps, rms_mix_rate=mix, sid=sid) for _, ps, mix, sid in streams]
    return np.ascontiguousarray(chunks), controls


def jax_batch_controls(controls):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[JControls.default(**c) for c in controls])


def pitch_track(tpipe, cache):
    """The chunk's f0 track as the step slices it from the new f0 cache (the
    synthesizer's ``pitchf``): ``cache[..., start : start + return_length]``."""
    cfg = tpipe.cfg
    start = cfg.pitch_cache_len - tpipe.hubert_length + cfg.skip_head
    return cache[..., start : start + cfg.return_length]


def run_jax_batch(jpipe, tpipe, params, chunks, controls):
    """The JAX ``jit_step_batch`` over the chunks: per chunk (emitted [B, n],
    f0 [B, T], codes [B, T]), the f0 track read off the new f0 cache."""
    B = chunks.shape[1]
    jc = jax_batch_controls(controls)
    state = jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * B), JState.init(jpipe.cfg))
    rows = []
    for chunk in chunks:
        state, out = jpipe.jit_step_batch(params, state, jnp.asarray(chunk), jc)
        f0 = pitch_track(tpipe, np.asarray(state.cache_pitchf))
        rows.append((np.asarray(out), f0, np.asarray(j_get_f0_post(jnp.asarray(f0))[0])))
    return rows


def _row(tpipe, state, out):
    if tpipe.cfg.skip_inference:
        return (out.numpy(),)
    f0 = pitch_track(tpipe, state.cache_pitchf)
    return out.numpy(), f0.numpy(), get_f0_post(f0)[0].numpy()


def run_port_batch(tpipe, chunks, controls, step=None):
    """The port's batched step over the chunks, as ``run_jax_batch``."""
    B = chunks.shape[1]
    tc = StepControls.stack([StepControls.default(**c) for c in controls], "cpu")
    step = step or (lambda s, c, k: tpipe.step(s, c, k, batched=True))
    state = StreamState.init_batch(tpipe.cfg, B, device="cpu")
    rows = []
    with torch.no_grad():
        for chunk in chunks:
            state, out = step(state, torch.from_numpy(chunk), tc)
            rows.append(_row(tpipe, state, out))
    return rows


def run_port_single(tpipe, chunks, controls):
    """Each stream through the single-stream step on its own, as ``run_port_batch``."""
    per_stream = []
    for k, c in enumerate(controls):
        tc = StepControls.default(**c)
        state, rows = tpipe.new_state(), []
        with torch.no_grad():
            for chunk in chunks[:, k]:
                state, out = tpipe.step(state, torch.from_numpy(chunk), tc)
                rows.append(_row(tpipe, state, out))
        per_stream.append(rows)
    return by_chunk(per_stream)


def run_jax_streams(jpipe, jstep, tpipe, params, chunks, controls):
    """The JAX step (jitted as ``jstep``) on each stream alone: the function
    ``jit_step_batch`` maps over the stream axis. As ``run_jax_batch``."""
    per_stream = []
    for k, c in enumerate(controls):
        state, jc, rows = jax.tree.map(jnp.asarray, JState.init(jpipe.cfg)), JControls.default(**c), []
        for chunk in chunks[:, k]:
            state, out = jstep(params, state, jnp.asarray(chunk), jc)
            f0 = pitch_track(tpipe, np.asarray(state.cache_pitchf))
            rows.append((np.asarray(out), f0, np.asarray(j_get_f0_post(jnp.asarray(f0))[0])))
        per_stream.append(rows)
    return by_chunk(per_stream)


def by_chunk(per_stream):
    """Rows ``[stream][chunk][field]`` as ``[chunk][field]`` stacked over streams."""
    return [tuple(np.stack([rows[i][j] for rows in per_stream]) for j in range(len(per_stream[0][i])))
            for i in range(len(per_stream[0]))]


def assert_rows_match(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        out, f0, codes = g
        wout, wf0, wcodes = w
        assert out.shape == wout.shape
        np.testing.assert_allclose(f0, wf0, rtol=1e-4, err_msg=f"{what}: f0, chunk {i}")
        clear = _codes_distance(wf0) > 1e-3
        np.testing.assert_array_equal(codes[clear], wcodes[clear], err_msg=f"{what}: codes, chunk {i}")
        assert np.abs(codes.astype(np.int64) - wcodes).max() <= 1
        np.testing.assert_allclose(out, wout, atol=2e-3, err_msg=f"{what}: emitted audio, chunk {i}")
        assert (np.abs(wout).max(axis=1) > 1e-3).all()  # no stream's comparison is of silence


@pytest.fixture(scope="module")
def batch_run():
    """The JAX batched step, the port's batched step and its single-stream
    steps over the same three streams, three chunks."""
    jpipe, params, _, _, tpipe = _make_pipes()
    chunks, controls = stream_inputs(tpipe.cfg, STREAMS, 3)
    return dict(tpipe=tpipe, chunks=chunks, controls=controls,
                jax=run_jax_batch(jpipe, tpipe, params, chunks, controls),
                port=run_port_batch(tpipe, chunks, controls))


def test_batched_step_matches_jax_stream_by_stream(batch_run):
    assert len({c["sid"] for c in batch_run["controls"]}) == 3
    assert_rows_match(batch_run["port"], batch_run["jax"], "port batch vs JAX jit_step_batch")


def test_batched_step_matches_single_stream_steps(batch_run):
    single = run_port_single(batch_run["tpipe"], batch_run["chunks"], batch_run["controls"])
    assert_rows_match(batch_run["port"], single, "port batch vs single-stream port steps")


def test_batched_passthrough_matches_single_stream_steps():
    tpipe = RvcPipeline(ChunkConfig.build(skip_inference=True), device="cpu")
    chunks, controls = stream_inputs(tpipe.cfg, STREAMS, 3)
    batch, single = run_port_batch(tpipe, chunks, controls), run_port_single(tpipe, chunks, controls)
    for (b,), (s,) in zip(batch, single):
        assert b.shape == (3, tpipe.cfg.sample_frame_size)
        np.testing.assert_allclose(b, s, atol=1e-5)


def test_staged_batched_step_matches_the_fused_one(batch_run):
    tpipe, chunks, controls = batch_run["tpipe"], batch_run["chunks"][:2], batch_run["controls"]
    fused = run_port_batch(tpipe, chunks, controls, step=tpipe.jit_step_batch)
    staged = run_port_batch(tpipe, chunks, controls,
                            step=lambda s, c, k: tpipe.staged_step(s, c, k, batched=True))
    # the same operations on other buffers: equal up to the CPU kernels' alignment-dependent summation order
    for f, s, e in zip(fused, staged, batch_run["port"]):
        for a, b, c in zip(f, s, e):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)
    assert set(tpipe._graphs) >= {"jit_step_batch/3", "staged/3"}


def test_log_mel_plain_takes_a_stream_axis():
    mel = MelSpectrogram(device="cpu")
    rng = np.random.default_rng(3)
    x = np.stack([voiced(10080, 16000, 170.0, 1), rng.standard_normal(10080).astype(np.float32) * 0.1,
                  np.zeros(10080, np.float32)])
    got = stft_mel.log_mel_plain(torch.from_numpy(x), mel.mel_basis, mel.window).numpy()
    assert got.shape == (3, 128, 64)
    for b in range(3):
        # the bound of tests/test_torch_port_mel.py, the JAX package's own for its kernel: the plain
        # version's DFT products sum in another order than the Pallas kernel's (1.1e-4 on a voiced row)
        want = np.asarray(log_mel_pallas(jnp.asarray(x[b]), interpret=True))
        np.testing.assert_allclose(got[b], want, atol=2e-4, rtol=1e-4, err_msg=f"stream {b}")
        # each row is the one-stream frontend's result up to the order of its products' sums
        np.testing.assert_allclose(got[b], mel(torch.from_numpy(x[b])).numpy(), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(mel(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("sr_in,sr_out,chunk", [(48000, 16000, 14400 + 960), (40000, 48000, 14000)])
def test_polyphase_resampler_matches_jax(sr_in, sr_out, chunk):
    x = np.random.default_rng(5).standard_normal((2, chunk)).astype(np.float32)
    j, t = JResampler(sr_in, sr_out, chunk), PolyphaseResampler(sr_in, sr_out, chunk)
    assert (t.up, t.down, t.chunk_size_out) == (j.up, j.down, j.chunk_size_out)
    np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(), np.asarray(j(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(t(torch.from_numpy(x[0])).numpy(), np.asarray(j(jnp.asarray(x[0]))), atol=1e-5)
    with pytest.raises(ValueError):
        t(torch.zeros(chunk + 1))
    with pytest.raises(ValueError):
        PolyphaseResampler(48000, 16000, 1000)


def test_convert_scan_matches_convert_offline(batch_run):
    tpipe = batch_run["tpipe"]
    cfg = tpipe.cfg
    wav = voiced(3 * cfg.sample_frame_size, cfg.sample_rate, 200.0, 9)
    controls = StepControls.default(pitch_shift=3.0, rms_mix_rate=0.5)
    want = tpipe.convert_offline(torch.from_numpy(wav), controls)
    got = tpipe.jit_convert_scan(torch.from_numpy(wav).reshape(3, -1), controls)
    assert got.shape == want.shape == (3 * cfg.sample_frame_size,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert list(tpipe._graphs["jit_convert_scan"]) == [3]


def test_convert_scan_matches_jax_passthrough():
    tpipe = RvcPipeline(ChunkConfig.build(skip_inference=True), device="cpu")
    jpipe = JPipeline(JChunkConfig.build(skip_inference=True))
    wav = voiced(4 * tpipe.cfg.sample_frame_size, 48000, 200.0, 4)
    want = np.asarray(jpipe.jit_convert_scan({}, jnp.asarray(wav).reshape(4, -1), JControls.default()))
    got = tpipe.jit_convert_scan(torch.from_numpy(wav).reshape(4, -1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
