"""The port's ``RvcEngine`` (the reference RPC protocol's engine) against the
JAX package's, at reduced widths with the same weights: three requests at
the launch geometry and three at another, interleaved, so the shared f0
history carries across geometries in both. Audio agrees to atol 2e-3 (the
synthesizer's bound), the f0 histories to rtol 1e-4. Bad geometries raise
``EngineError``; a per-geometry pipeline reuses the launch pipeline's
networks instead of building its own.
"""

import numpy as np
import pytest

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.stream import RvcEngine as JEngine

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.stream import EngineError, RvcEngine, RvcPipeline

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_session import make_pipes

LAUNCH = dict(sample_length=0.10, extra_inference_time=0.50)
OTHER = dict(sample_length=0.20, extra_inference_time=0.30)


def _request(cfg, rng):
    t = np.arange(cfg.input_buffer_16k_size) / 16000
    f = 150.0 + 60.0 * rng.random()
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(4 * np.pi * f * t) + 0.01 * rng.standard_normal(t.size)
    return x.astype(np.float32), cfg.sample_frame_16k_size, cfg.skip_head, cfg.return_length


@pytest.fixture(scope="module")
def engines():
    jpipe, params, tpipe = make_pipes(LAUNCH)
    return JEngine(jpipe, params), RvcEngine(tpipe)


def test_engine_matches_jax_engine_across_geometries(engines):
    jeng, teng = engines
    rng = np.random.default_rng(0)
    launch, other = JChunkConfig.build(**LAUNCH), JChunkConfig.build(**OTHER)
    for i, cfg in enumerate([launch, other] * 3):
        x, n16k, skip, ret = _request(cfg, rng)
        pitch = (-2, 0, 5)[i // 2]
        want = jeng.infer(x, n16k, pitch, skip, ret)
        got = teng.infer(x, n16k, pitch, skip, ret)
        assert got.shape == want.shape == (ret * 400,)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=f"request {i}")
        np.testing.assert_allclose(teng.cache_pitchf, jeng.cache_pitchf, rtol=1e-4, err_msg=f"request {i}")
    assert len(teng._pipelines) == 1  # the launch geometry needs no pipeline of its own


def test_per_geometry_pipelines_share_the_launch_networks(engines):
    _, teng = engines
    cfg = ChunkConfig.build(**OTHER)
    key = (cfg.input_buffer_16k_size, cfg.sample_frame_16k_size, cfg.skip_head, cfg.return_length)
    pipe = teng._pipeline_for(key)
    launch = teng.pipeline
    assert pipe is not launch and pipe.cfg.input_buffer_16k_size == cfg.input_buffer_16k_size
    for name, module in pipe.modules().items():
        assert module is launch.modules()[name]
    assert pipe.mel is launch.mel and launch.cfg.input_buffer_16k_size != cfg.input_buffer_16k_size
    assert teng._pipeline_for(key) is pipe  # cached


def test_engine_rejects_bad_geometries(engines):
    _, teng = engines
    cfg = ChunkConfig.build(**LAUNCH)
    x = np.zeros(cfg.input_buffer_16k_size, np.float32)
    with pytest.raises(EngineError, match="exceeds"):
        teng.infer(np.zeros(17, np.float32), cfg.sample_frame_16k_size, 0, cfg.skip_head, cfg.return_length)
    with pytest.raises(EngineError, match="multiple of 160"):
        teng.infer(x, 123, 0, cfg.skip_head, cfg.return_length)
    teng.unload_model()
    try:
        with pytest.raises(EngineError, match="not loaded"):
            teng.infer(x, cfg.sample_frame_16k_size, 0, cfg.skip_head, cfg.return_length)
    finally:
        teng.load_model()
    with pytest.raises(NotImplementedError, match="item 14"):
        RvcEngine(teng.pipeline, exec_cache=True)
    # a passthrough pipeline has no networks to answer with, at any geometry
    passthrough = RvcEngine(RvcPipeline(ChunkConfig.build(**LAUNCH, skip_inference=True), device="cpu"))
    for n16k in (cfg.sample_frame_16k_size, 3200):
        with pytest.raises(EngineError, match="no networks"):
            passthrough.infer(x, n16k, 0, cfg.skip_head, cfg.return_length)


def test_engine_geometry_cache_is_bounded(engines):
    _, teng = engines
    eng = RvcEngine(teng.pipeline, max_geometries=2)
    keys = []
    for n16k in (1600, 3200, 4800):
        cfg = ChunkConfig.build(sample_length=n16k / 16000, extra_inference_time=0.5)
        keys.append((cfg.input_buffer_16k_size, cfg.sample_frame_16k_size, cfg.skip_head, cfg.return_length))
        eng._pipeline_for(keys[-1])
    assert list(eng._pipelines) == keys[1:]
