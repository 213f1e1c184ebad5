"""The port's ``StreamSession`` against the JAX package's, at reduced widths
(the ``CV``/``RM``/``SY`` of ``test_torch_port_pipeline.py``) and a small
geometry (0.10 s chunks, 0.5 s context), weights carried across by
``load_jax_params``. Both sessions take the same voiced signal in odd frame
sizes, driven through ``process_pending`` with no worker thread; the emitted
audio agrees to atol 2e-3, the synthesizer's bound. Also: a failing step
emits silence and counts an error, a snapshot resumes identically (in the
port, and from a JAX snapshot), and live controls reach the step.
"""

import numpy as np
import pytest
import jax
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamSession as JSession

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models.weights import load_jax_params
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamSession

from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, RM, SY, voiced_signal

GEOMETRY = dict(sample_length=0.10, extra_inference_time=0.50)
CONTROLS = dict(pitch_shift=2.0, rms_mix_rate=0.5)


def make_pipes(geometry=GEOMETRY):
    jpipe = JPipeline(JChunkConfig.build(**geometry), contentvec_cfg=JContentVecConfig(**CV),
                      rmvpe_cfg=JRMVPEConfig(**RM), synth_cfg=JSynthesizerConfig(**SY))
    params = jpipe.init_params_fast(0)
    params = {k: randomize(v, seed=i) for i, (k, v) in enumerate(sorted(params.items()))}
    tpipe = RvcPipeline(ChunkConfig.build(**geometry), contentvec_cfg=ContentVecConfig(**CV),
                        rmvpe_cfg=RMVPEConfig(**RM), synth_cfg=SynthesizerConfig(**SY), device="cpu")
    load_jax_params(tpipe, params)
    return jpipe, params, tpipe


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _feed(session, wav, frame, n_out):
    """Push ``wav`` in ``frame``-sized pieces, stepping after each, and pull
    what is ready; then drain to ``n_out`` samples."""
    out = []
    for i in range(0, wav.size, frame):
        session.push_audio(wav[i : i + frame])
        session.process_pending()
        out.append(session.pull_audio(frame))
    session.process_pending()
    got = np.concatenate(out)
    return np.concatenate([got, session.pull_audio(n_out - got.size)])


def test_session_matches_jax_session(pipes):
    jpipe, params, tpipe = pipes
    cfg = tpipe.cfg
    n_chunks = 7
    wav = voiced_signal(n_chunks, cfg)
    jsess = JSession(jpipe, params, JControls.default(**CONTROLS), mode="staged")
    tsess = StreamSession(tpipe, StepControls.default(**CONTROLS), mode="staged", stage_timing=True)
    half = 4 * cfg.sample_frame_size
    with torch.no_grad():
        a = [_feed(jsess, wav[:half], 1001, half), _feed(tsess, wav[:half], 1001, half)]
        # a live control update lands in both from the next chunk on
        jsess.update_controls(pitch_shift=-3.0, rms_mix_rate=1.0)
        tsess.update_controls(pitch_shift=-3.0, rms_mix_rate=1.0)
        assert tsess.controls == StepControls.default(pitch_shift=-3.0, rms_mix_rate=1.0)
        rest = wav.size - half
        b = [_feed(jsess, wav[half:], 777, rest), _feed(tsess, wav[half:], 777, rest)]
    want, got = np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])
    assert got.shape == want.shape == (n_chunks * cfg.sample_frame_size,)
    assert np.abs(want).max() > 1e-3  # the comparison is not of silence
    np.testing.assert_allclose(got, want, atol=2e-3)
    snap = tsess.metrics.snapshot()
    assert snap.chunks == n_chunks and snap.errors == 0
    assert set(snap.stage_p50_ms) == {"pre", "features", "mel", "salience", "pitch_post", "synth", "post"}
    with pytest.raises(ValueError, match="unknown controls"):
        tsess.update_controls(pitch=1.0)


def test_fused_mode_matches_staged_mode(pipes):
    _, _, tpipe = pipes
    cfg = tpipe.cfg
    wav = voiced_signal(3, cfg, seed=3)
    outs = []
    for mode in ("staged", "fused"):
        sess = StreamSession(tpipe, StepControls.default(**CONTROLS), mode=mode)
        with torch.no_grad():
            outs.append(_feed(sess, wav, cfg.sample_frame_size, wav.size))
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="mode"):
        StreamSession(tpipe, mode="jit")


def test_failing_step_emits_silence_and_counts_an_error(pipes, monkeypatch):
    _, _, tpipe = pipes
    cfg = tpipe.cfg
    sess = StreamSession(tpipe)
    sess.push_audio(np.full(cfg.sample_frame_size, 0.5, np.float32))
    assert sess.process_pending() == 1
    assert np.abs(sess.state.input_buffer.numpy()).max() > 0

    def boom(*args, **kwargs):
        raise RuntimeError("injected failure")

    monkeypatch.setattr(tpipe, "staged_step", boom)  # the session's default mode
    sess.push_audio(np.ones(cfg.sample_frame_size, np.float32))
    assert sess.process_pending() == 1
    sess.pull_audio(cfg.sample_frame_size)
    np.testing.assert_array_equal(sess.pull_audio(cfg.sample_frame_size), 0.0)
    assert sess.metrics.snapshot().errors == 1
    assert all(float(t.abs().max()) == 0.0 for t in vars(sess.state).values())  # the state was reset


def test_snapshot_resume_continues_identically(pipes):
    jpipe, params, tpipe = pipes
    cfg = tpipe.cfg
    controls = StepControls.default(**CONTROLS)
    wav = voiced_signal(6, cfg, seed=4)
    chunk = cfg.sample_frame_size

    def run(split):
        sess, out = StreamSession(tpipe, controls), []
        for i in range(6):
            if i == split:
                blob = sess.snapshot()
                # a new session over a new pipeline object (sharing the networks)
                sess = StreamSession(tpipe.with_config(cfg), controls)
                sess.restore(blob)
            sess.push_audio(wav[i * chunk : (i + 1) * chunk])
            assert sess.process_pending() == 1
            out.append(sess.pull_audio(chunk))
        return np.concatenate(out)

    with torch.no_grad():
        np.testing.assert_array_equal(run(None), run(3))

    # a JAX session's snapshot resumes in a port session
    jsess = JSession(jpipe, params, JControls.default(**CONTROLS), mode="staged")
    for i in range(3):
        jsess.push_audio(wav[i * chunk : (i + 1) * chunk])
        jsess.process_pending()
        jsess.pull_audio(chunk)
    tsess = StreamSession(tpipe, controls)
    tsess.restore(jsess.snapshot())
    for i in range(3, 6):
        for s in (jsess, tsess):
            s.push_audio(wav[i * chunk : (i + 1) * chunk])
            with torch.no_grad():
                s.process_pending()
        np.testing.assert_allclose(tsess.pull_audio(chunk), jsess.pull_audio(chunk), atol=2e-3)

    # a snapshot of another geometry is refused up front
    other = StreamSession(RvcPipeline(ChunkConfig.build(sample_length=0.20, extra_inference_time=0.30,
                                                        skip_inference=True), device="cpu"))
    with pytest.raises(ValueError, match="geometry mismatch"):
        other.restore(StreamSession(tpipe).snapshot())


def test_worker_thread_streams_and_stops(pipes):
    _, _, tpipe = pipes
    cfg = tpipe.cfg
    sess = StreamSession(tpipe, StepControls.default(**CONTROLS))
    sess.start()
    try:
        wav = voiced_signal(3, cfg, seed=5)
        sess.push_audio(wav)
        deadline, got = 60.0, 0
        import time

        t0 = time.monotonic()
        while got < wav.size and time.monotonic() - t0 < deadline:
            got += sess.pull_audio(wav.size - got).size
            time.sleep(0.01)
        assert got == wav.size
    finally:
        thread = sess._thread
        sess.stop(timeout=10)
    assert thread is not None and not thread.is_alive()
    assert sess.metrics.snapshot().errors == 0
