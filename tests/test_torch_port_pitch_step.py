"""The port's streaming step with the CREPE and FCPE pitch algorithms against
the JAX step, also two streams at once through the batched step, and
through the graphed session, the engine and the CLI.

Reduced widths: the ``CV``/``SY`` of ``test_torch_port_pipeline.py``, CREPE
``tiny``, FCPE at hidden 64 with 2 layers; the pitch network's weights are
fan-in scaled (``init_variables``), the others the JAX fast init, all
perturbed by ``randomize`` and carried across by ``load_jax_params``.
Tolerances are ``test_torch_port_pipeline.py``'s: f0 rtol 1e-4, coarse codes
exact away from a code boundary, emitted audio atol 2e-3. bfloat16 is held
to ``test_torch_port_bf16.py``'s error budget against JAX float32 (audio
2e-3, salience 2e-4, f0 2e-4), as ``test_torch_port_bf16_step.py`` holds
RMVPE's step; the pitch codes by the same rule: frames whose code differs
from JAX float32's, at most twice as many as JAX bf16's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.models.checkpoints import cast_params_for_serving as j_cast
from obs_rvc_tpu.models.crepe import CrepeConfig as JCrepeConfig
from obs_rvc_tpu.models.fcpe import FcpeConfig as JFcpeConfig
from obs_rvc_tpu.models.weights import export_crepe, export_fcpe
from obs_rvc_tpu.stream import RvcEngine as JEngine
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamSession as JSession
from obs_rvc_tpu.stream import StreamState as JState

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.crepe import CrepeConfig
from obs_rvc_tpu_torch.models.fcpe import FcpeConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models import weights as W
from obs_rvc_tpu_torch.models.weights import load_jax_params
from obs_rvc_tpu_torch.serve import cli
from obs_rvc_tpu_torch.stream import RvcEngine, RvcPipeline, StepControls, StreamSession, StreamState
from obs_rvc_tpu_torch.utils import read_wav, write_wav

from test_torch_port_batch import STREAMS, assert_rows_match, run_jax_streams, run_port_batch, stream_inputs
from test_torch_port_bf16 import budget, init_variables
from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, SY, _stream_and_compare, voiced_signal
from test_torch_port_session import GEOMETRY, _feed

FCPE_SMALL = dict(hidden=64, n_layers=2)
#: per algorithm: the JAX and the port pitch config
PITCH = {"crepe": (JCrepeConfig("tiny"), CrepeConfig("tiny")),
         "fcpe": (JFcpeConfig(**FCPE_SMALL), FcpeConfig(**FCPE_SMALL))}
CONTROLS = dict(pitch_shift=2.0, rms_mix_rate=0.5)
SMALL = ["--sample-length", "0.10", "--extra-inference-time", "0.5"]


def _pitch_example(algo, cfg):
    return jnp.zeros((cfg.rmvpe_n_frames, 1024 if algo == "crepe" else 128))


def jax_params(jpipe, algo, seed=0):
    """The JAX fast init, perturbed; the pitch network fan-in scaled."""
    params = jpipe.init_params_fast(seed)
    params = {k: randomize(v, seed=seed + i) for i, (k, v) in enumerate(sorted(params.items()))}
    params[algo] = init_variables(getattr(jpipe, algo), _pitch_example(algo, jpipe.cfg), seed=seed + 7)
    return params


def make_pitch_pipes(algo, geometry=None, dtype="float32", params=None):
    """``(JAX pipeline, JAX params, port pipeline)`` for ``algo`` at reduced widths."""
    geometry = geometry or {}
    jcfg, tcfg = PITCH[algo]
    jpipe = JPipeline(JChunkConfig.build(**geometry), contentvec_cfg=JContentVecConfig(**CV),
                      synth_cfg=JSynthesizerConfig(**SY), pitch_algorithm=algo, compute_dtype=getattr(jnp, dtype),
                      **{f"{algo}_cfg": jcfg})
    params = params if params is not None else jax_params(jpipe, algo)
    tpipe = RvcPipeline(ChunkConfig.build(**geometry), contentvec_cfg=ContentVecConfig(**CV),
                        synth_cfg=SynthesizerConfig(**SY), device="cpu", pitch_algorithm=algo,
                        compute_dtype=getattr(torch, dtype), **{f"{algo}_cfg": tcfg})
    load_jax_params(tpipe, params)
    return jpipe, params, tpipe


@pytest.fixture(scope="module")
def default_pipes():
    """``get(algo)``: :func:`make_pitch_pipes` at the default geometry with
    the JAX step and pitch update jitted, built once per module."""
    built = {}

    def get(algo):
        if algo not in built:
            jpipe, params, tpipe = make_pitch_pipes(algo)
            built[algo] = (jpipe, params, jax.jit(jpipe.step), jax.jit(jpipe._pitch_cache_update), tpipe)
        return built[algo]

    return get


@pytest.mark.parametrize("algo", ["crepe", "fcpe"])
def test_step_matches_jax_over_chunks(default_pipes, algo):
    pipes = default_pipes(algo)
    jpipe, params, _, _, tpipe = pipes
    assert set(tpipe.modules()) == {"contentvec", algo, "synthesizer"} and tpipe.rmvpe is None
    assert set(params) == {"contentvec", algo, "synthesizer"}
    _stream_and_compare(pipes, CONTROLS, 5)


@pytest.mark.parametrize("algo", ["crepe", "fcpe"])
def test_batched_pitch_algorithms_match_jax(default_pipes, algo):
    """Two streams with their own voices and controls (pitch shift, rms mix,
    speaker id) through the port's batched step, one chunk, each against
    the JAX step on that stream alone (what the JAX ``jit_step_batch`` maps
    over the stream axis), with the step's bounds."""
    jpipe, params, jstep, _, tpipe = default_pipes(algo)
    chunks, controls = stream_inputs(tpipe.cfg, STREAMS[1:], 1)
    assert_rows_match(run_port_batch(tpipe, chunks, controls),
                      run_jax_streams(jpipe, jstep, tpipe, params, chunks, controls),
                      f"{algo} port batch vs the JAX step stream by stream")


@pytest.fixture(scope="module", params=["crepe", "fcpe"])
def small_pipes(request):
    return request.param, make_pitch_pipes(request.param, GEOMETRY)


def test_graphed_sessions_match_the_jax_fused_session(small_pipes):
    """Both session modes (a graph per stage, one graph of the step) against
    the JAX fused session, the controls changed mid-stream."""
    algo, (jpipe, params, tpipe) = small_pipes
    cfg = tpipe.cfg
    n = 5
    wav = voiced_signal(n, cfg, seed=3)
    chunk = cfg.sample_frame_size

    def feed(session):
        out = []
        for i in range(n):
            if i == 2:
                session.update_controls(pitch_shift=7.0, rms_mix_rate=0.5)
            out.append(_feed(session, wav[i * chunk : (i + 1) * chunk], 1001, chunk))
        return np.concatenate(out)

    want = feed(JSession(jpipe, params, JControls.default(), mode="fused"))
    assert np.abs(want).max() > 1e-3
    for mode in ("staged", "fused"):
        sess = StreamSession(tpipe, StepControls.default(), mode=mode, exec_cache=True)
        sess.prepare()
        with torch.no_grad():
            got = feed(sess)
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=f"{algo} {mode}")
        assert sess.metrics.snapshot().errors == 0


def test_engine_keeps_the_pitch_network_at_a_second_geometry(small_pipes):
    algo, (jpipe, params, tpipe) = small_pipes
    jeng, teng = JEngine(jpipe, params), RvcEngine(tpipe)
    teng.prepare()
    launch, other = JChunkConfig.build(**GEOMETRY), JChunkConfig.build(sample_length=0.20, extra_inference_time=0.30)
    rng = np.random.default_rng(0)
    for i, cfg in enumerate([launch, other, launch]):
        t = np.arange(cfg.input_buffer_16k_size) / 16000
        x = (0.3 * np.sin(2 * np.pi * (150 + 60 * rng.random()) * t)
             + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
        args = (x, cfg.sample_frame_16k_size, (-2, 4, 0)[i], cfg.skip_head, cfg.return_length)
        want, got = jeng.infer(*args), teng.infer(*args)
        assert got.shape == want.shape == (cfg.return_length * 400,) and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=f"{algo} request {i}")
        np.testing.assert_allclose(teng.cache_pitchf, jeng.cache_pitchf, rtol=1e-4)
    (second,) = teng._pipelines.values()
    assert second.pitch_algorithm == algo and second.modules()[algo] is tpipe.modules()[algo]
    assert second.cfg.sample_frame_size != tpipe.cfg.sample_frame_size
    assert f"pitch={algo}" in second.fingerprint() and second.fingerprint() != tpipe.fingerprint()


@pytest.mark.parametrize("algo", ["crepe", "fcpe"])
def test_keyshift_and_unknown_algorithms_are_refused_as_in_jax(algo):
    cfg = ChunkConfig.build(**GEOMETRY)
    with pytest.raises(ValueError, match="resonance shift"):
        JPipeline(JChunkConfig.build(**GEOMETRY), pitch_algorithm=algo, keyshift=2)
    with pytest.raises(ValueError, match="resonance shift"):
        RvcPipeline(cfg, device="cpu", pitch_algorithm=algo, keyshift=2)
    with pytest.raises(ValueError, match="unknown pitch_algorithm"):
        RvcPipeline(cfg, device="cpu", pitch_algorithm=algo.upper())
    # the passthrough geometry builds no network, whatever the algorithm
    assert RvcPipeline(ChunkConfig.build(skip_inference=True), device="cpu", pitch_algorithm=algo).modules() == {}


N_BF16_CHUNKS = 4


def _bf16_streams(algo):
    """``{side: [(audio, salience, f0, codes) per chunk]}`` for JAX and the
    port in float32 and bfloat16, on one set of float32 weights."""
    cfg = ChunkConfig.build()
    wav = voiced_signal(N_BF16_CHUNKS, cfg, seed=5)
    chunks = [wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size] for i in range(N_BF16_CHUNKS)]
    params, out = None, {}
    for name in ("float32", "bfloat16"):
        jpipe, params, tpipe = make_pitch_pipes(algo, dtype=name, params=params)
        if name == "bfloat16":
            cast_params_for_serving(tpipe)
        jparams = j_cast(params) if name == "bfloat16" else params
        jstep, jpitch = jax.jit(jpipe.step), jax.jit(jpipe._pitch_cache_update)
        jsal = jax.jit(lambda p, b, jpipe=jpipe: jpipe._pitch_net(p, jpipe._pitch_frontend(b)))
        jstate, trows, jrows = jax.tree.map(jnp.asarray, JState.init(jpipe.cfg)), [], []
        tstate = StreamState.init(cfg, device="cpu")
        jc, tc = JControls.default(**CONTROLS), StepControls.default(**CONTROLS)
        for chunk in chunks:
            new, audio = jstep(jparams, jstate, jnp.asarray(chunk), jc)
            _, codes, f0 = jpitch(jstate.cache_pitchf, new.input_buffer_16k, jc, jparams)
            jrows.append(tuple(np.asarray(a) for a in (audio, jsal(jparams, new.input_buffer_16k), f0, codes)))
            jstate = new
            with torch.no_grad():
                tnew, taudio = tpipe.step(tstate, torch.from_numpy(chunk), tc)
                _, tcodes, tf0 = tpipe._pitch_cache_update(tstate.cache_pitchf, tnew.input_buffer_16k, tc)
                sal = tpipe.stage_salience(tpipe.stage_mel(tnew.input_buffer_16k[None]))[0]
            assert taudio.dtype == tf0.dtype == sal.dtype == torch.float32
            trows.append(tuple(t.numpy() for t in (taudio, sal, tf0, tcodes)))
            tstate = tnew
        out[f"jax {name}"], out[f"port {name}"] = jrows, trows
    return out


@pytest.mark.parametrize("algo", ["crepe", "fcpe"])
def test_step_bf16_within_budget_over_chunks(algo):
    runs = _bf16_streams(algo)
    audio, sal, f0, codes = ({side: np.concatenate([r[j] for r in rows]) for side, rows in runs.items()}
                             for j in range(4))
    assert np.abs(audio["jax float32"]).max() > 1e-3
    for what, got, tol in (("emitted audio", audio, 2e-3), ("salience", sal, 2e-4)):
        budget(f"{algo} step {what}", got["port bfloat16"], got["jax bfloat16"], got["jax float32"], tol)
    budget(f"{algo} step f0", f0["port bfloat16"], f0["jax bfloat16"], f0["jax float32"], 2e-4, floor=0.0)
    # the pitch codes, by the same budget: a random network's salience has top bins within bf16's
    # rounding of each other (CREPE tiny: a median gap of ~1e-3), so bf16 moves the argmax of some
    # frames in either package, not of the same ones
    n_ref = int((codes["jax bfloat16"] != codes["jax float32"]).sum())
    n_port = int((codes["port bfloat16"] != codes["jax float32"]).sum())
    print(f"{algo} step pitch codes off JAX float32's: JAX bf16 {n_ref}, port bf16 {n_port} of "
          f"{codes['jax float32'].size} frames")
    assert n_port <= 2 * n_ref
    # float32: the tolerances of test_torch_port_pipeline.py
    for i, (j, t) in enumerate(zip(runs["jax float32"], runs["port float32"])):
        np.testing.assert_allclose(t[2], j[2], rtol=1e-4, err_msg=f"{algo} f0, chunk {i}")
        np.testing.assert_allclose(t[0], j[0], atol=2e-3, err_msg=f"{algo} emitted audio, chunk {i}")


def _reduced_cli_defaults(monkeypatch, algo):
    """Both packages' CLIs build the reduced networks of this file."""
    from obs_rvc_tpu.stream import pipeline as jpipeline_mod
    from obs_rvc_tpu_torch.stream import pipeline as pipeline_mod

    jcfg, tcfg = PITCH[algo]
    monkeypatch.setattr(JContentVecConfig, "v2", staticmethod(lambda: JContentVecConfig(**CV)))
    monkeypatch.setattr(JSynthesizerConfig, "for_sample_rate",
                        staticmethod(lambda sr, feature_dim=768: JSynthesizerConfig(**SY)))
    monkeypatch.setattr(jpipeline_mod, f"{algo.capitalize()}Config", lambda: jcfg)
    monkeypatch.setattr(ContentVecConfig, "v2", staticmethod(lambda: ContentVecConfig(**CV)))
    monkeypatch.setattr(SynthesizerConfig, "for_sample_rate",
                        staticmethod(lambda sr, feature_dim=768: SynthesizerConfig(**SY)))
    monkeypatch.setattr(pipeline_mod, f"{algo.capitalize()}Config", lambda: tcfg)


@pytest.mark.parametrize("algo", ["crepe", "fcpe"])
def test_cli_converts_like_the_jax_cli(tmp_path, monkeypatch, algo):
    """``serve.cli --pitch-algorithm <algo> --<algo> <checkpoint>`` in both
    packages on one WAV file: the pitch network from a torchcrepe- or
    torchfcpe-layout file (weights of another draw than the rest), the other
    networks from one JAX parameter dict."""
    from obs_rvc_tpu.serve import cli as jcli

    _reduced_cli_defaults(monkeypatch, algo)
    jpipe = JPipeline(JChunkConfig.build(**dict(GEOMETRY)), pitch_algorithm=algo)
    params = jax_params(jpipe, algo, seed=3)
    monkeypatch.setattr(JPipeline, "init_params", lambda self, rng: dict(params))  # the loader writes into it
    monkeypatch.setattr(RvcPipeline, "init_params", lambda self, seed=0, std=0.02: load_jax_params(self, params))
    other = init_variables(getattr(jpipe, algo), _pitch_example(algo, jpipe.cfg), seed=99)
    if algo == "crepe":
        ckpt = tmp_path / "crepe.pth"
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_crepe(other).items()}, ckpt)
    else:
        ckpt = tmp_path / "fcpe.pt"
        sd = export_fcpe(other, n_layers=FCPE_SMALL["n_layers"])
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, ckpt)
    sr = 48000
    write_wav(tmp_path / "in.wav", voiced_signal(5, ChunkConfig.build(**GEOMETRY), seed=4)[None], sr)
    made = []
    real = cli.pipeline_from_args
    monkeypatch.setattr(cli, "pipeline_from_args", lambda *a: made.append(real(*a)) or made[-1])
    flags = [*SMALL, "--pitch-algorithm", algo, f"--{algo}", str(ckpt), "--pitch-shift", "3"]
    jcli.main([str(tmp_path / "in.wav"), str(tmp_path / "want.wav"), *flags])
    cli.main([str(tmp_path / "in.wav"), str(tmp_path / "got.wav"), *flags, "--device", "cpu"])
    want, _ = read_wav(tmp_path / "want.wav")
    got, got_sr = read_wav(tmp_path / "got.wav")
    assert got_sr == sr and got.shape == want.shape == (1, 5 * 4800) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-3)
    # the pitch network holds the file's weights, not the parameter dict's
    pipe = made[0][0]
    assert pipe.pitch_algorithm == algo and pipe.compute_dtype == torch.float32
    loaded = pipe.modules()[algo].state_dict()
    sd = W.crepe_state_dict(other) if algo == "crepe" else W.fcpe_state_dict(other, FCPE_SMALL["n_layers"])
    for k, v in sd.items():
        np.testing.assert_allclose(loaded[k].numpy(), v, rtol=1e-6, atol=1e-7, err_msg=k)
    # a resonance shift needs RMVPE, in both packages
    for main in (jcli.main, lambda argv: cli.main([*argv, "--device", "cpu"])):
        with pytest.raises(ValueError, match="resonance shift"):
            main([str(tmp_path / "in.wav"), str(tmp_path / "x.wav"), *SMALL, "--resonance-shift", "2",
                  "--pitch-algorithm", algo])
