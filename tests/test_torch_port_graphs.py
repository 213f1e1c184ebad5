"""The port's compiled step on the CPU: ``utils/flops.py`` against the JAX
package's, ``utils/exec_cache.cached_capture``'s keys, the graphed session
and engine against the JAX package's jitted ones, the controls as tensors,
and the weights a graph reads.

On the CPU a graphed callable runs its function eagerly on its static
copies, so these tests hold what the graphs' callers do (copy in, the
controls as 0-d float32 tensors, the donated state, the keys); that the
replays equal the eager step on a card is held by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``. Reduced widths
(``CV``/``RM``/``SY``) and the small geometry of the session tests; audio
agrees with JAX to atol 2e-3, the synthesizer's bound.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.dsp import envelope as jenvelope
from obs_rvc_tpu.dsp import f0 as jf0
from obs_rvc_tpu.stream import RvcEngine as JEngine
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamSession as JSession
from obs_rvc_tpu.utils import flops as jflops

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.dsp import envelope as tenvelope
from obs_rvc_tpu_torch.dsp import f0 as tf0
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.stream import RvcEngine, RvcPipeline, StepControls, StreamSession
from obs_rvc_tpu_torch.stream.graphs import GraphedFunction, WeightsVersion
from obs_rvc_tpu_torch.utils import exec_cache
from obs_rvc_tpu_torch.utils import flops as tflops

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, RM, SY, voiced_signal
from test_torch_port_session import GEOMETRY, _feed, make_pipes

#: (first chunk, semitones, rms_mix_rate): the live controls changed mid-stream
SCHEDULE = [(0, 0.0, 1.0), (2, 12.0, 1.0), (3, 12.0, 0.5), (4, -5.0, 0.5)]
N_CHUNKS = 6


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


@pytest.mark.parametrize("geometry", [{}, dict(sample_length=0.50), dict(sample_length=0.10, extra_inference_time=0.50)])
def test_flops_match_jax(geometry):
    jcfg, tcfg = JChunkConfig.build(**geometry), ChunkConfig.build(**geometry)
    assert tflops.pipeline_gflops_per_chunk(tcfg) == jflops.pipeline_gflops_per_chunk(jcfg)
    assert tflops.pipeline_gflops_per_chunk(tcfg, 256) == jflops.pipeline_gflops_per_chunk(jcfg, 256)
    assert tflops.contentvec_gflops(tcfg.input_buffer_16k_size) == jflops.contentvec_gflops(jcfg.input_buffer_16k_size)
    assert tflops.rmvpe_gflops(tcfg.rmvpe_n_frames) == jflops.rmvpe_gflops(jcfg.rmvpe_n_frames)
    assert tflops.synth_gflops(tcfg.return_length, (10, 6, 2, 2, 2), (16, 16, 4, 4, 4)) == \
        jflops.synth_gflops(jcfg.return_length, (10, 6, 2, 2, 2), (16, 16, 4, 4, 4))


def _small_pipe(dtype=torch.float32, **geometry):
    return RvcPipeline(ChunkConfig.build(**(geometry or GEOMETRY)), contentvec_cfg=ContentVecConfig(**CV),
                       rmvpe_cfg=RMVPEConfig(**RM), synth_cfg=SynthesizerConfig(**SY), device="cpu",
                       compute_dtype=dtype)


def test_cached_capture_hits_and_misses_by_key():
    pipe = _small_pipe()

    def capture(p, label="|jit_step"):
        step = p.jit_step
        return exec_cache.cached_capture(step, step.graph.static_args, semantic_key=p.fingerprint() + label)

    first, status = capture(pipe)
    assert status == "miss" and first is pipe.jit_step
    again, status = capture(pipe)
    assert status == "hit" and again is first
    # a pipeline at the same geometry over the same networks shares the graph
    assert capture(pipe.with_config(pipe.cfg)) == (first, "hit")
    other = pipe.with_config(ChunkConfig.build(sample_length=0.20, extra_inference_time=0.30))
    assert capture(other)[1] == "miss"  # geometry
    assert capture(pipe, "|other")[1] == "miss"  # call-site label
    bf16 = _small_pipe(torch.bfloat16)
    assert bf16.fingerprint() != pipe.fingerprint()
    assert capture(bf16)[1] == "miss"  # dtype
    twin = _small_pipe()  # the same config, its own networks: another graph
    assert twin.fingerprint() == pipe.fingerprint() and capture(twin)[1] == "miss"

    # a plain function is wrapped in a GraphedFunction over copies of its examples
    fn, status = exec_cache.cached_capture(lambda x, k: x * k, (torch.ones(3), 2.0), semantic_key="scale")
    assert status == "miss" and isinstance(fn, GraphedFunction)
    np.testing.assert_array_equal(fn(torch.arange(3.0), 3.0).numpy(), [0.0, 3.0, 6.0])
    with pytest.raises(ValueError, match="shape"):
        fn(torch.ones(4), 3.0)
    assert exec_cache.cached_capture(lambda x, k: x, (torch.ones(3), 2.0), semantic_key="scale")[1] == "hit"
    assert exec_cache.cached_capture(lambda x, k: x, (torch.ones(4), 2.0), semantic_key="scale")[1] == "miss"


def _controls_at(i):
    _, st, mix = [s for s in SCHEDULE if s[0] <= i][-1]
    return st, mix


def _feed_scheduled(session, wav, chunk):
    """One chunk at a time, the controls of :data:`SCHEDULE` set before each."""
    out = []
    for i in range(wav.size // chunk):
        st, mix = _controls_at(i)
        session.update_controls(pitch_shift=st, rms_mix_rate=mix)
        out.append(_feed(session, wav[i * chunk : (i + 1) * chunk], 1001, chunk))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def jax_fused_stream(pipes):
    jpipe, params, tpipe = pipes
    wav = voiced_signal(N_CHUNKS, tpipe.cfg, seed=7)
    jsess = JSession(jpipe, params, JControls.default(), mode="fused")
    return wav, _feed_scheduled(jsess, wav, tpipe.cfg.sample_frame_size)


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_graphed_session_matches_jax_fused_session(pipes, jax_fused_stream, mode):
    _, _, tpipe = pipes
    wav, want = jax_fused_stream
    sess = StreamSession(tpipe, StepControls.default(), mode=mode, exec_cache=True)
    sess.prepare()
    state = sess.state
    with torch.no_grad():
        got = _feed_scheduled(sess, wav, tpipe.cfg.sample_frame_size)
    assert sess.state is state  # the steps wrote into the session's own state tensors
    assert got.shape == want.shape == (N_CHUNKS * tpipe.cfg.sample_frame_size,)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert sess.metrics.snapshot().errors == 0


def test_graphed_steps_match_the_eager_step(pipes):
    """``jit_step`` and ``staged_step`` donate the state and return what the
    eager step returns, bit for bit on the CPU (the same functions run)."""
    _, _, tpipe = pipes
    cfg = tpipe.cfg
    wav = torch.from_numpy(voiced_signal(3, cfg, seed=8))
    states = {name: tpipe.new_state() for name in ("eager", "fused", "staged")}
    steps = {"eager": tpipe.step, "fused": tpipe.jit_step, "staged": tpipe.staged_step}
    with torch.no_grad():
        for i in range(3):
            chunk = wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size]
            controls = StepControls.default(pitch_shift=3.0 * i, rms_mix_rate=1.0 - 0.25 * i)
            outs = {}
            for name, step in steps.items():
                new, outs[name] = step(states[name], chunk, controls)
                if name != "eager":
                    assert new is states[name]
                states[name] = new
            for name in ("fused", "staged"):
                torch.testing.assert_close(outs[name], outs["eager"], rtol=0, atol=0)
                for f in dataclasses.fields(new):
                    torch.testing.assert_close(getattr(states[name], f.name), getattr(states["eager"], f.name),
                                               rtol=0, atol=0)


def test_graphed_engine_matches_jax_engine(pipes):
    jpipe, params, tpipe = pipes
    jeng, teng = JEngine(jpipe, params), RvcEngine(tpipe, exec_cache=True)
    teng.prepare()
    launch, other = JChunkConfig.build(**GEOMETRY), JChunkConfig.build(sample_length=0.20, extra_inference_time=0.30)
    rng = np.random.default_rng(0)
    for i, cfg in enumerate([launch, other, other, launch]):
        t = np.arange(cfg.input_buffer_16k_size) / 16000
        x = (0.3 * np.sin(2 * np.pi * (150 + 60 * rng.random()) * t)
             + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
        args = (x, cfg.sample_frame_16k_size, (-2, 4, 0, 7)[i], cfg.skip_head, cfg.return_length)
        want, got = jeng.infer(*args), teng.infer(*args)
        assert got.shape == want.shape == (cfg.return_length * 400,) and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=f"request {i}")
        np.testing.assert_allclose(teng.cache_pitchf, jeng.cache_pitchf, rtol=1e-4, err_msg=f"request {i}")
    assert len(teng._cached) == 2  # one graphed _infer per geometry


@pytest.mark.parametrize("semitones", [0.0, 12.0, -5.0, 7.0, 2.5])
def test_pitch_shift_with_a_tensor_control_matches_jax(semitones):
    f0 = np.random.default_rng(5).uniform(50.0, 1100.0, 300).astype(np.float32)
    st = torch.tensor(semitones, dtype=torch.float32)
    got = tf0.apply_pitch_shift(torch.from_numpy(f0), st).numpy()
    want = np.asarray(jf0.apply_pitch_shift(jnp.asarray(f0), jnp.float32(semitones)))
    # the exponent is JAX's float32 st / 12, bit for bit; exp2 itself is PyTorch's, which differs from
    # XLA's by at most one float32 ulp (as XLA's own jitted and op-by-op exp2 do on some inputs); each
    # side then takes the one float32 product f0 * factor
    assert (st / 12.0).numpy().tobytes() == np.asarray(jnp.float32(semitones) / 12.0).tobytes()
    factor = torch.exp2(st / 12.0).numpy()
    jfactor = np.asarray(jnp.exp2(jnp.float32(semitones) / 12.0))
    np.testing.assert_array_max_ulp(factor, jfactor, maxulp=1)
    assert got.tobytes() == (f0 * factor).tobytes() and want.tobytes() == (f0 * jfactor).tobytes()
    # a number or a tensor: the same float32 arithmetic
    assert got.tobytes() == tf0.apply_pitch_shift(torch.from_numpy(f0), semitones).numpy().tobytes()


@pytest.mark.parametrize("mix", [1.0, 0.5, 0.0, 0.3])
def test_envelope_mixing_with_a_tensor_control_matches_jax(mix):
    rng = np.random.default_rng(8)
    inp = (rng.standard_normal(16800) * np.linspace(0.05, 0.5, 16800)).astype(np.float32)
    out = (rng.standard_normal(16320) * 0.2).astype(np.float32)
    m = torch.tensor(mix, dtype=torch.float32)
    got = tenvelope.envelope_mixing(torch.from_numpy(inp), torch.from_numpy(out), 48000, m).numpy()
    want = np.asarray(jenvelope.envelope_mixing(jnp.asarray(inp), jnp.asarray(out), 48000, jnp.float32(mix)))
    assert (1.0 - m).numpy().tobytes() == np.asarray(1.0 - jnp.float32(mix)).tobytes()
    if mix == 1.0:  # the exponent is 0: the gain is exactly 1 on both sides
        assert got.tobytes() == want.tobytes() == out.tobytes()
    # the window energies are float32 prefix sums taken in another order (test_torch_port_dsp.py's bound)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert got.tobytes() == tenvelope.envelope_mixing(torch.from_numpy(inp), torch.from_numpy(out), 48000,
                                                      mix).numpy().tobytes()


def _first_batchnorm(module):
    return next(m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d))


def _attach_index(pipe):
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex

    table = np.random.default_rng(0).standard_normal((16, SY["feature_dim"])).astype(np.float32)
    pipe.retrieval_index = RetrievalIndex().load(RetrievalIndex.make_params(table), "cpu")


def _set_data(p):
    p.data = p.data.clone()


#: one kind of change each: what the weights check must see before the next replay
WEIGHT_CHANGES = {
    "reload": lambda pipe: pipe.init_params(seed=3),  # load_state_dict writes in place
    "in_place_write": lambda pipe: next(pipe.synthesizer.parameters()).mul_(2.0),
    "buffer_write": lambda pipe: _first_batchnorm(pipe.rmvpe).running_mean.add_(1.0),
    "cast": lambda pipe: pipe.rmvpe.to(torch.float64),  # moves the storage
    "data_assigned": lambda pipe: _set_data(next(pipe.contentvec.parameters())),
    "module_swap": lambda pipe: setattr(pipe, "synthesizer", type(pipe.synthesizer)(pipe.synth_cfg)),
    "index_generation": lambda pipe: setattr(pipe.retrieval_index, "generation", pipe.retrieval_index.generation + 1),
}


@pytest.mark.parametrize("change", list(WEIGHT_CHANGES))
def test_weights_version_sees_reloads_casts_and_swaps(change):
    pipe = _small_pipe()
    _attach_index(pipe)
    version = WeightsVersion(pipe._weight_modules)
    key = version.key()
    assert version.key() == key
    with torch.no_grad():
        WEIGHT_CHANGES[change](pipe)
    changed = version.key()
    assert changed != key
    assert version.key() == changed


def _tuple_key(modules):
    """The weights check as a Python tuple: every module's id and generation,
    every parameter's and buffer's data pointer and version."""
    mods = tuple(modules())
    return tuple((id(m), getattr(m, "generation", 0)) for m in mods) + tuple(
        (t.data_ptr(), t._version) for m in mods for t in itertools.chain(m.parameters(), m.buffers()))


def test_weights_version_keys_follow_the_tuple_of_every_tensor():
    """A seeded sequence of changes and pauses: the native check's keys
    compare equal where the tuple's do, call to call, and two keys are
    never equal where the tuples differ."""
    pipe = _small_pipe()
    _attach_index(pipe)
    version = WeightsVersion(pipe._weight_modules)
    rng = np.random.default_rng(22)
    names = list(WEIGHT_CHANGES) + ["none"] * 4
    keys, tuples = [version.key()], [_tuple_key(pipe._weight_modules)]
    for step in range(48):
        name = names[rng.integers(len(names))]
        with torch.no_grad():
            if name == "cast":  # back and forth, so both ways are met
                pipe.rmvpe.to(torch.float64 if next(pipe.rmvpe.parameters()).dtype == torch.float32 else torch.float32)
            elif name != "none":
                WEIGHT_CHANGES[name](pipe)
        keys.append(version.key())
        tuples.append(_tuple_key(pipe._weight_modules))
        assert (keys[-1] == keys[-2]) == (tuples[-1] == tuples[-2]), (step, name)
    for i in range(len(keys)):
        for j in range(i):
            assert keys[i] != keys[j] or tuples[i] == tuples[j], (j, i)
    assert len({k for k in keys}) > 10


def test_weight_reload_after_the_first_call_reaches_the_graphed_step():
    pipe = _small_pipe()
    pipe.init_params(seed=1)
    cfg = pipe.cfg
    chunk = torch.from_numpy(voiced_signal(1, cfg, seed=9))
    controls = StepControls.default(pitch_shift=2.0)
    with torch.no_grad():
        _, before = pipe.jit_step(pipe.new_state(), chunk, controls)
        pipe.init_params(seed=2)
        _, eager = pipe.step(pipe.new_state(), chunk, controls)
        for step in (pipe.jit_step, pipe.staged_step):
            _, after = step(pipe.new_state(), chunk, controls)
            torch.testing.assert_close(after, eager, rtol=0, atol=0)
    assert float((eager - before).abs().max()) > 1e-3 * float(before.abs().max())


def test_an_evicted_geometry_frees_its_pipeline_and_graph(pipes):
    """The graphs a pipeline owns hold it weakly: the engine's bounded cache
    frees an evicted geometry's pipeline (and with it, on a card, its graph
    and memory pool) at once, with the garbage collector off."""
    import gc
    import weakref

    _, _, tpipe = pipes
    engine = RvcEngine(tpipe, max_geometries=1, exec_cache=True)
    refs = []
    gc.disable()
    try:
        for extra in (0.30, 0.40):
            cfg = ChunkConfig.build(sample_length=0.20, extra_inference_time=extra)
            x = np.zeros(cfg.input_buffer_16k_size, np.float32)
            engine.infer(x, cfg.sample_frame_16k_size, 0, cfg.skip_head, cfg.return_length)
            (pipe,) = engine._pipelines.values()
            refs.append((weakref.ref(pipe), weakref.ref(pipe.jit_infer)))
            del pipe
        assert refs[0][0]() is None and refs[0][1]() is None  # evicted by the second geometry
        assert refs[1][0]() is not None and len(engine._cached) == 1
    finally:
        gc.enable()
