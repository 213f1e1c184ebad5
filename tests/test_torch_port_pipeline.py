"""The port's streaming step against the JAX ``RvcPipeline.step``, chunk after
chunk at the default geometry (48 kHz, 0.30 s chunks, 2.0 s context, the
40 kHz generator's upsample stack), with reduced-width networks whose
weights are carried across by the port's ``models/weights.py``.

Each stream runs independently in both packages; per chunk the pitch track
(f0 relative 1e-4, coarse codes exactly wherever the f0 is clear of a code
boundary) and the emitted audio (absolute 2e-3, the synthesizer's
tolerance) are compared.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.dsp.f0 import F0_MEL_MAX, F0_MEL_MIN
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamState as JState

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models.weights import load_jax_params
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState

from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)

CV = dict(dim=64, num_layers=2, tap_layer=2, num_heads=4, ffn_dim=128, out_dim=64)
RM = dict(en_de_layers=3, inter_layers=1, n_blocks=2, en_out_channels=8, gru_hidden=32)
# the 40 kHz upsample stack (x400) at 128 initial channels: levels of 64
# (the bank kernel's C=64), 32 (C=32), 16 and 8 channels
SY = dict(feature_dim=64, inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=2,
          upsample_initial_channel=128, gin_channels=16, spk_embed_dim=4)


def _make_pipes(**options):
    jcfg = JChunkConfig.build()
    jpipe = JPipeline(jcfg, contentvec_cfg=JContentVecConfig(**CV), rmvpe_cfg=JRMVPEConfig(**RM),
                      synth_cfg=JSynthesizerConfig(**SY), **options)
    params = jpipe.init_params_fast(0)
    params = {k: randomize(v, seed=i) for i, (k, v) in enumerate(sorted(params.items()))}
    tpipe = RvcPipeline(ChunkConfig.build(), contentvec_cfg=ContentVecConfig(**CV),
                        rmvpe_cfg=RMVPEConfig(**RM), synth_cfg=SynthesizerConfig(**SY), device="cpu",
                        **options)
    load_jax_params(tpipe, params)
    return jpipe, params, jax.jit(jpipe.step), jax.jit(jpipe._pitch_cache_update), tpipe


@pytest.fixture(scope="module")
def pipes():
    return _make_pipes()


def voiced_signal(n_chunks, cfg, seed=0):
    """A harmonic tone with vibrato and a little noise."""
    t = np.arange(n_chunks * cfg.sample_frame_size) / cfg.sample_rate
    f = 180.0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / cfg.sample_rate
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    x = x + 0.01 * np.random.default_rng(seed).standard_normal(t.shape)
    return x.astype(np.float32)


def _codes_distance(f0):
    """How far each frame's continuous pitch code lies from a rounding
    boundary (inf where the code is clipped to 1 or 255)."""
    mel = np.log(f0.astype(np.float64) / 700.0 + 1.0) * 1127.0
    scaled = (mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    inside = (mel > 0) & (scaled > 1.0) & (scaled < 255.0)
    return np.where(inside, np.abs(scaled - np.floor(scaled) - 0.5), np.inf)


def _stream_and_compare(pipes, controls_kw, n_chunks):
    jpipe, params, jstep, jpitch, tpipe = pipes
    cfg = tpipe.cfg
    wav = voiced_signal(n_chunks, cfg)
    jc = JControls.default(**controls_kw)
    tc = StepControls.default(**controls_kw)
    jstate = jax.tree.map(jnp.asarray, JState.init(jpipe.cfg))
    tstate = StreamState.init(cfg, device="cpu")
    for i in range(n_chunks):
        chunk = wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size]
        jnew, jout = jstep(params, jstate, jnp.asarray(chunk), jc)
        _, jcodes, jf0 = jpitch(jstate.cache_pitchf, jnew.input_buffer_16k, jc, params)
        with torch.no_grad():
            tnew, tout = tpipe.step(tstate, torch.from_numpy(chunk), tc)
            _, tcodes, tf0 = tpipe._pitch_cache_update(tstate.cache_pitchf, tnew.input_buffer_16k, tc)
        jf0 = np.asarray(jf0)
        np.testing.assert_allclose(tf0.numpy(), jf0, rtol=1e-4, err_msg=f"f0, chunk {i}")
        # random weights put f0 anywhere, so a frame may land within rounding
        # noise of a code boundary: the codes must agree exactly on every frame
        # clear of one (nearly all), and within one code on the rest
        clear = _codes_distance(jf0) > 1e-3
        assert clear.mean() > 0.9
        tcodes, jcodes = tcodes.numpy(), np.asarray(jcodes)
        np.testing.assert_array_equal(tcodes[clear], jcodes[clear], err_msg=f"codes, chunk {i}")
        assert np.abs(tcodes - jcodes).max() <= 1
        np.testing.assert_allclose(tnew.cache_pitchf.numpy(), np.asarray(jnew.cache_pitchf), rtol=1e-4)
        np.testing.assert_allclose(tnew.input_buffer_16k.numpy(), np.asarray(jnew.input_buffer_16k),
                                   atol=1e-5)
        assert tout.shape == (cfg.sample_frame_size,)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-3,
                                   err_msg=f"emitted audio, chunk {i}")
        assert np.abs(np.asarray(jout)).max() > 1e-3  # the comparison is not of silence
        jstate, tstate = jnew, tnew


@pytest.mark.parametrize("controls_kw,n_chunks", [
    ({}, 6),
    (dict(pitch_shift=7.0), 5),
    (dict(pitch_shift=-4.5, rms_mix_rate=0.3), 5),
])
def test_step_matches_jax_over_chunks(pipes, controls_kw, n_chunks):
    _stream_and_compare(pipes, controls_kw, n_chunks)


def test_step_with_keyshift_phase_vocoder_and_median_matches_jax():
    """The constructor options of the step: mel keyshift (the resonance
    shift), the phase-vocoder SOLA crossfade and the f0 median filter."""
    _stream_and_compare(_make_pipes(keyshift=2, phase_vocoder=True, f0_median_radius=3),
                        dict(pitch_shift=-3.0), 4)


def test_convert_offline_matches_jax(pipes):
    jpipe, params, _, _, tpipe = pipes
    cfg = tpipe.cfg
    wav = voiced_signal(4, cfg, seed=1)
    wav = np.concatenate([wav, wav[:1000]])  # a partial last chunk is dropped
    controls = dict(pitch_shift=3.0, rms_mix_rate=0.5)
    want = np.asarray(jpipe.convert_offline(params, jnp.asarray(wav), JControls.default(**controls)))
    got = tpipe.convert_offline(torch.from_numpy(wav), StepControls.default(**controls)).numpy()
    assert got.shape == want.shape == (4 * cfg.sample_frame_size,)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_skip_inference_step_matches_jax():
    jcfg = JChunkConfig.build(skip_inference=True)
    jpipe = JPipeline(jcfg)
    tpipe = RvcPipeline(ChunkConfig.build(skip_inference=True), device="cpu")
    wav = voiced_signal(3, tpipe.cfg, seed=2)
    got = tpipe.convert_offline(torch.from_numpy(wav)).numpy()
    want = np.asarray(jpipe.convert_offline({}, jnp.asarray(wav)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pipeline_runs_on_the_card_unless_told_otherwise():
    cfg = ChunkConfig.build(skip_inference=True)
    if torch.cuda.is_available():
        assert RvcPipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RvcPipeline(cfg)
    assert RvcPipeline(cfg, device="cpu").device.type == "cpu"


def test_init_params_follows_the_fast_init_rule():
    cfg = ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50)
    kw = dict(contentvec_cfg=ContentVecConfig(**CV), rmvpe_cfg=RMVPEConfig(**RM),
              synth_cfg=SynthesizerConfig(**SY), device="cpu")
    a, b = RvcPipeline(cfg, **kw), RvcPipeline(cfg, **kw)
    a.init_params(3)
    b.init_params(3)
    for name, module in a.modules().items():
        sd_a, sd_b = module.state_dict(), b.modules()[name].state_dict()
        for key, t in sd_a.items():
            torch.testing.assert_close(t, sd_b[key])
    rm = a.rmvpe.unet.encoder.layers[0].conv[0].conv
    assert torch.all(rm[1].weight == 1) and torch.all(rm[1].running_var == 1)
    assert torch.all(rm[1].bias == 0) and torch.all(rm[1].running_mean == 0)
    assert torch.all(a.synthesizer.enc_p.encoder.norm_layers_1[0].gamma == 1)
    w = a.contentvec.encoder.layers[0].fc1.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.002 and torch.all(a.contentvec.encoder.layers[0].fc1.bias == 0)
    state = StreamState.init(cfg, device="cpu")
    state, out = a.step(state, torch.zeros(cfg.sample_frame_size), StepControls.default())
    assert out.shape == (cfg.sample_frame_size,) and torch.isfinite(out).all()
    cleared = state.clear()
    assert all(torch.all(getattr(cleared, f) == 0) for f in
               ("input_buffer", "input_buffer_16k", "sola_buffer", "cache_pitchf"))
