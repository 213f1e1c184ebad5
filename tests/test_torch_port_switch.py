"""The JAX package's kernel switch, ``pallas_resblocks``, in the port.

``RvcPipeline(pallas_resblocks=False)`` (``--no-pallas-resblocks`` on the
server, the CLI and ``scripts/torch_bench.py``) turns
``RMVPEConfig.pallas_unet`` and ``SynthesizerConfig.pallas_resblocks`` off,
as the JAX pipeline does: the U-Net chain and resblock bank levels then run
the networks' own convolution modules (cuDNN on a card, PyTorch's
convolutions here), never the kernels' wrappers. Here, at reduced widths
(``test_torch_port_pipeline.py``'s ``CV``/``RM``/``SY``) on one set of
weights: the port with the switch off against the JAX pipeline with it off,
each network (ContentVec and RMVPE at 2e-4, the synthesizer at 2e-3) and
four chunks of the step (the step tolerances of
``test_torch_port_pipeline.py``), and in bfloat16 each network by the error
budget of ``test_torch_port_bf16.py``; no wrapper is called; the flag at the
front doors and the bench; and the copies (``with_config``, the engine's
geometries, a mesh's rows) keep the switch, which ``fingerprint()`` tells
apart.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.models import RMVPE as JRMVPE
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import Synthesizer as JSynthesizer
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models import weights as W
from obs_rvc_tpu_torch.models.rmvpe import RMVPE, RMVPEConfig, _Chain
from obs_rvc_tpu_torch.models.synthesizer import Synthesizer, SynthesizerConfig
from obs_rvc_tpu_torch.parallel import make_mesh, shard_params
from obs_rvc_tpu_torch.serve import cli, server
from obs_rvc_tpu_torch.stream import RvcEngine, StepControls
from obs_rvc_tpu_torch.utils import read_wav, write_wav

from test_torch_bench import bench_line, small  # noqa: F401 (fixture)
from test_torch_port_bf16 import RMVPE_PALLAS, SYNTH_PALLAS, _cast, budget, init_variables
from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import _make_pipes, _stream_and_compare, voiced_signal

SMALL = ["--sample-length", "0.10", "--extra-inference-time", "0.5"]


@pytest.fixture(scope="module")
def off_pipes():
    return _make_pipes(pallas_resblocks=False)


@pytest.fixture
def no_wrappers(monkeypatch):
    """The chain's and the bank's wrappers as the networks call them, made to raise."""
    def called(*args, **kw):
        raise AssertionError("a kernel wrapper was called with the switch off")

    monkeypatch.setattr("obs_rvc_tpu_torch.models.rmvpe.conv_block_res_chain", called)
    monkeypatch.setattr("obs_rvc_tpu_torch.models.synthesizer.resblock_bank", called)


def _levels(pipe):
    chains = [m for m in pipe.rmvpe.modules() if isinstance(m, _Chain)]
    gen = pipe.synthesizer.dec
    return [c.fused for c in chains], [gen.uses_bank_kernel(up.out_channels) for up in gen.ups]


def test_the_switch_sets_both_configs_as_jax_does(off_pipes):
    jpipe, _, _, _, tpipe = off_pipes
    assert (jpipe.rmvpe_cfg.pallas_unet, jpipe.synth_cfg.pallas_resblocks) == (False, False)
    assert (tpipe.rmvpe_cfg.pallas_unet, tpipe.synth_cfg.pallas_resblocks) == (False, False)
    chains, banks = _levels(tpipe)
    assert chains and not any(chains) and banks and not any(banks)
    # the default: every chain level of at most pallas_unet_max_ch channels and every bank level of at
    # most 64 on the kernels (here the encoder's and decoder's 8, 16, 32 and the banks' 64, 32, 16, 8), the
    # wider ones on their modules (the intermediate level's 64)
    on = _make_pipes()[-1]
    assert (on.rmvpe_cfg.pallas_unet, on.synth_cfg.pallas_resblocks) == (True, True)
    chains, banks = _levels(on)
    assert chains == [True] * 3 + [False] + [True] * 3 and banks == [True, True, True, True]
    # a config passed in keeps its widths; the switch decides the two fields, as the JAX pipeline's does
    assert tpipe.rmvpe_cfg.en_out_channels == on.rmvpe_cfg.en_out_channels == 8


def test_switch_off_networks_match_jax(off_pipes):
    """Each network on the same input, the port's modules against the JAX
    flax path (both with the switch off): ContentVec's features and RMVPE's
    salience within 2e-4 of max, the synthesizer's audio 2e-3."""
    jpipe, params, _, _, tpipe = off_pipes
    cfg = tpipe.cfg
    wav = voiced_signal(1, cfg, seed=3)
    t = np.arange(cfg.input_buffer_16k_size) / 16000
    buf16 = (0.3 * np.sin(2 * np.pi * 190.0 * t) + 0.01 * np.random.default_rng(3).standard_normal(t.size)
             + np.resize(wav, t.size) * 0.1).astype(np.float32)
    jb = jnp.asarray(buf16)
    jfeat = np.asarray(jpipe._stage_features(params, jb, 0.0))
    jsal = np.asarray(jpipe._stage_salience(params, jpipe._stage_mel(jb)))
    with torch.no_grad():
        tb = torch.from_numpy(buf16)[None]
        tfeat = tpipe.stage_features(tb).numpy()
        tsal = tpipe.stage_salience(tpipe.stage_mel(tb))[0].numpy()
    for name, got, want, tol in (("features", tfeat, jfeat, 2e-4), ("salience", tsal, jsal, 2e-4)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), err_msg=name)
    rng = np.random.default_rng(4)
    T = cfg.return_length
    pitch = rng.integers(1, 256, T).astype(np.int32)
    pitchf = np.where(rng.uniform(size=T) < 0.2, 0.0, rng.uniform(80.0, 400.0, T)).astype(np.float32)
    want = np.asarray(jpipe._stage_synth(params, jnp.asarray(jfeat), jnp.asarray(pitch), jnp.asarray(pitchf),
                                         jnp.asarray(0, jnp.int32), None))
    with torch.no_grad():
        got = tpipe.stage_synth(torch.from_numpy(jfeat.copy()), torch.from_numpy(pitch.astype(np.int64))[None],
                                torch.from_numpy(pitchf)[None], torch.zeros(1, dtype=torch.long))[0].numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_switch_off_step_matches_jax_over_four_chunks(off_pipes, no_wrappers):
    """Four chunks of the step, neither wrapper called: f0 rtol 1e-4, codes
    exact away from a code boundary, emitted audio 2e-3."""
    _stream_and_compare(off_pipes, dict(pitch_shift=3.0, rms_mix_rate=0.6), 4)


def test_the_default_calls_the_wrappers(no_wrappers):
    """The guard of the test above: with the switch at its default the step
    goes through the wrappers (their plain versions on the CPU)."""
    tpipe = _make_pipes()[-1]
    cfg = tpipe.cfg
    with pytest.raises(AssertionError, match="kernel wrapper"), torch.no_grad():
        tpipe.step(tpipe.new_state(), torch.zeros(cfg.sample_frame_size), StepControls.default())


def test_switch_off_rmvpe_bf16_within_budget(no_wrappers):
    mel = np.random.default_rng(12).standard_normal((1, 128, 32)).astype(np.float32)
    jcfg = JRMVPEConfig(**RMVPE_PALLAS)
    variables = init_variables(JRMVPE(jcfg), jnp.asarray(mel))
    want = np.asarray(jax.jit(JRMVPE(jcfg).apply)(variables, jnp.asarray(mel)))
    ref = np.asarray(jax.jit(JRMVPE(dataclasses.replace(jcfg, dtype=jnp.bfloat16, pallas_unet=False)).apply)(
        _cast(variables), jnp.asarray(mel)))
    tm = RMVPE(RMVPEConfig(**RMVPE_PALLAS, pallas_unet=False)).to(torch.bfloat16)
    W.load_state_dict(tm, W.rmvpe_state_dict(variables, RMVPE_PALLAS["n_blocks"], RMVPE_PALLAS["en_de_layers"],
                                             RMVPE_PALLAS["inter_layers"]))
    assert not any(getattr(m, "fused", False) for m in tm.modules())
    with torch.no_grad():
        got = tm(torch.from_numpy(mel))
    budget("rmvpe, switch off", got.numpy(), ref, want, 2e-4)


def test_switch_off_synthesizer_bf16_within_budget(no_wrappers):
    rng = np.random.default_rng(13)
    T = 12
    jcfg = JSynthesizerConfig(**SYNTH_PALLAS)
    phone = rng.standard_normal((1, T, jcfg.feature_dim)).astype(np.float32)
    pitch = rng.integers(1, 256, (1, T)).astype(np.int32)
    pitchf = np.where(rng.uniform(size=(1, T)) < 0.2, 0.0, rng.uniform(80.0, 400.0, (1, T))).astype(np.float32)
    sid = np.array([3], np.int32)
    jargs = tuple(jnp.asarray(a) for a in (phone, pitch, pitchf, sid))
    variables = init_variables(JSynthesizer(jcfg), *jargs)
    want = np.asarray(jax.jit(JSynthesizer(jcfg).apply)(variables, *jargs))
    ref = np.asarray(jax.jit(JSynthesizer(dataclasses.replace(jcfg, dtype=jnp.bfloat16,
                                                              pallas_resblocks=False)).apply)(_cast(variables), *jargs))
    tm = Synthesizer(SynthesizerConfig(**SYNTH_PALLAS, pallas_resblocks=False)).to(torch.bfloat16)
    W.load_state_dict(tm, W.synthesizer_state_dict(variables, tm.cfg))
    assert not tm.dec.uses_bank_kernel(64)
    with torch.no_grad():
        got = tm(torch.from_numpy(phone), torch.from_numpy(pitch.astype(np.int64)), torch.from_numpy(pitchf),
                 torch.from_numpy(sid.astype(np.int64)))
    budget("synthesizer, switch off", got.numpy(), ref, want, 2e-3)


# --- the copies keep it ---

def test_copies_keep_the_switch_and_the_fingerprint_tells_it_apart(off_pipes):
    _, _, _, _, off = off_pipes
    on = _make_pipes()[-1]
    assert off.fingerprint() != on.fingerprint()
    other = ChunkConfig.build(sample_length=0.20, extra_inference_time=0.30)
    moved = off.with_config(other)
    assert (moved.rmvpe_cfg.pallas_unet, moved.synth_cfg.pallas_resblocks) == (False, False)
    assert moved.fingerprint() != on.with_config(other).fingerprint()
    # the engine's pipeline at a second geometry
    engine = RvcEngine(off)
    key = (other.input_buffer_16k_size, other.sample_frame_16k_size, other.skip_head, other.return_length)
    pipe = engine._pipeline_for(key)
    assert pipe is not off and (pipe.rmvpe_cfg.pallas_unet, pipe.synth_cfg.pallas_resblocks) == (False, False)
    # a mesh's rows: one that shares the pipeline's networks and one with ContentVec split along model
    for n_model in (1, 2):
        rows = shard_params(off, make_mesh(n_data=2, n_model=n_model, devices=["cpu"] * 4))
        for row in rows:
            assert (row.rmvpe_cfg.pallas_unet, row.synth_cfg.pallas_resblocks) == (False, False)
            assert not any(_levels(row)[0]) and not any(_levels(row)[1])
            assert row.fingerprint().split("|device=")[0] == off.fingerprint().split("|device=")[0]


# --- the front doors and the bench ---

def test_cli_and_server_take_the_flag(tmp_path):
    args = server.build_parser().parse_args(["--skip-inference", "--device", "cpu", "--no-pallas-resblocks", *SMALL])
    pipe, _ = server.build_pipeline(args)
    assert (pipe.rmvpe_cfg.pallas_unet, pipe.synth_cfg.pallas_resblocks) == (False, False)
    on, _ = server.build_pipeline(server.build_parser().parse_args(["--skip-inference", "--device", "cpu", *SMALL]))
    assert (on.rmvpe_cfg.pallas_unet, on.synth_cfg.pallas_resblocks) == (True, True)
    sr = 48000
    t = np.arange(5 * 4800) / sr
    write_wav(tmp_path / "in.wav", (0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)[None], sr)
    for name, flags in (("off.wav", ["--no-pallas-resblocks"]), ("on.wav", [])):
        cli.main([str(tmp_path / "in.wav"), str(tmp_path / name), "--skip-inference", "--device", "cpu",
                  *SMALL, *flags])
    off_audio, off_sr = read_wav(tmp_path / "off.wav")
    assert off_sr == sr and off_audio.shape == (1, 5 * 4800)
    np.testing.assert_array_equal(off_audio, read_wav(tmp_path / "on.wav")[0])  # passthrough: no network


def test_server_main_serves_with_the_flag():
    import socket
    import threading
    import urllib.request

    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    duplex, port = ports
    stop, listening = threading.Event(), threading.Event()
    argv = ["--skip-inference", "--device", "cpu", "--no-pallas-resblocks", *SMALL, "--port", str(duplex),
            "--health-port", str(port)]
    t = threading.Thread(target=server.main, args=(argv,), kwargs=dict(ready=lambda b: listening.set(),
                                                                        stop_event=stop), daemon=True)
    t.start()
    try:
        assert listening.wait(30.0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30.0) as r:
            assert r.read() == b"ok"
    finally:
        stop.set()
        t.join(30.0)
    assert not t.is_alive()


def test_bench_line_with_the_switch_off(small, capsys):  # noqa: F811 (fixture)
    line = bench_line(capsys, "--no-pallas-resblocks")
    x = line["extra"]
    assert x["pallas_resblocks"] is False and (x["batch"], x["mode"]) == (1, "fused")
    assert json.loads(json.dumps(line)) == line and np.isfinite(line["value"])
