"""The port's DSP stages against their JAX twins, on the same numpy inputs.

Tolerances are absolute in float32 and stated per test: 1e-5 where both
sides compute the same few operations, wider where a long float32 sum
(a cumulative sum, an FFT) is taken in another order, with the reason given.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu import dsp as jdsp
from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.dsp import f0 as jf0
from obs_rvc_tpu.dsp import window as jwindow
from obs_rvc_tpu.stream.pipeline import slide_pitch_cache as j_slide

from obs_rvc_tpu_torch import dsp as tdsp
from obs_rvc_tpu_torch.config import ChunkConfig as TChunkConfig
from obs_rvc_tpu_torch.dsp import f0 as tf0
from obs_rvc_tpu_torch.dsp import window as twindow
from obs_rvc_tpu_torch.stream.pipeline import slide_pitch_cache as t_slide

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)


def _rng(seed):
    return np.random.default_rng(seed)


def _j(x):
    return np.array(x)


def _t(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("kwargs", [
    {},
    dict(sample_length=0.10, extra_inference_time=0.50),
    dict(sample_rate=44100, model_sample_rate=32000, sample_length=0.25, fade_length=0.05),
    dict(model_sample_rate=48000, skip_inference=True),
])
def test_chunk_config_matches(kwargs):
    j = JChunkConfig.build(**kwargs)
    t = TChunkConfig.build(**kwargs)
    for name in TChunkConfig.__dataclass_fields__:
        assert getattr(t, name) == getattr(j, name), name
    for prop in ("skip_head", "return_length", "rmvpe_frame_16k", "rmvpe_n_frames",
                 "pitch_cache_len", "downsample_window", "downsample_keep_16k"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_default_geometry_is_the_slice_geometry():
    cfg = TChunkConfig.build()
    assert cfg.sample_frame_size == 14400
    assert cfg.input_buffer_16k_size == 38080
    assert cfg.rmvpe_frame_16k == 10080 and cfg.rmvpe_n_frames == 64
    assert cfg.return_length == 35 and cfg.model_return_size == 14000


def test_windows_match():
    for n in (7, 1024, 1194):
        np.testing.assert_allclose(_t(twindow.hann_window_periodic(n)),
                                   _j(jwindow.hann_window_periodic(n)), atol=1e-7)
    for a, b in zip(twindow.fade_windows(1920), jwindow.fade_windows(1920)):
        np.testing.assert_allclose(_t(a), _j(b), atol=1e-7)
    x = _rng(0).standard_normal(300).astype(np.float32)
    np.testing.assert_array_equal(_t(twindow.pad_reflect(torch.from_numpy(x), 17)),
                                  _j(jwindow.pad_reflect(jnp.asarray(x), 17)))


@pytest.mark.parametrize("fft,hop,n", [(1024, 160, 10080), (512, 128, 3000)])
def test_stft_magnitude_matches(fft, hop, n):
    from obs_rvc_tpu.dsp.stft import stft_magnitude as jstft
    from obs_rvc_tpu_torch.dsp.stft import stft_magnitude as tstft

    x = _rng(1).standard_normal(n).astype(np.float32) * 0.3
    w = _j(jwindow.hann_window_periodic(fft))
    got = _t(tstft(torch.from_numpy(x), fft, hop, torch.from_numpy(w)))
    want = _j(jstft(jnp.asarray(x), fft, hop, jnp.asarray(w)))
    assert got.shape == want.shape
    # 1024-term float32 dot products summed in another order: ~1e-6 * |X|
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("keyshift", [0, 3, -2])
def test_log_mel_matches(keyshift):
    x = _rng(2).standard_normal(10080).astype(np.float32) * 0.3
    got = _t(tdsp.MelSpectrogram(device="cpu")(torch.from_numpy(x), keyshift=keyshift))
    want = _j(jdsp.MelSpectrogram()(jnp.asarray(x), keyshift=keyshift))
    assert got.shape == want.shape == (128, 64)
    # log of a sum of float32 DFT magnitudes: 1e-5 relative in the mel
    # energy is 1e-5 absolute after the log
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_mel_filterbank_matches():
    from obs_rvc_tpu.dsp.mel import mel_filterbank as jfb

    for htk, fmin in ((True, 30.0), (False, 0.0)):
        np.testing.assert_array_equal(
            tdsp.mel_filterbank(16000, 1024, 128, fmin, 8000.0, htk=htk),
            jfb(16000, 1024, 128, fmin, 8000.0, htk=htk))


@pytest.mark.parametrize("sr_in,sr_out,n", [(48000, 16000, 15360), (40000, 48000, 14000),
                                            (44100, 16000, 4410), (32000, 48000, 3200)])
def test_resample_poly_matches(sr_in, sr_out, n):
    from obs_rvc_tpu.dsp.resample import resample_poly as jres

    x = _rng(3).standard_normal(n).astype(np.float32) * 0.3
    got = _t(tdsp.resample_poly(torch.from_numpy(x), sr_in, sr_out))
    want = _j(jres(jnp.asarray(x), sr_in, sr_out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_decode_f0_matches():
    rng = _rng(4)
    sal = rng.uniform(0.0, 0.02, (64, 360)).astype(np.float32)
    peaks = rng.integers(0, 360, 48)
    sal[np.arange(48), peaks] = rng.uniform(0.2, 0.9, 48)
    sal[np.arange(48), np.clip(peaks + 1, 0, 359)] += 0.1
    sal[5, 0] = 0.95   # window clipped at the low edge
    sal[6, 359] = 0.95  # and at the high edge
    got = _t(tdsp.decode_f0(torch.from_numpy(sal)))
    want = _j(jdsp.decode_f0(jnp.asarray(sal)))
    # a 9-term float32 weighted mean taken in another order, then exp2:
    # a few float32 ulps of relative error in Hz
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[48:] == 0).all() and (got[:48] > 0).all()


def test_get_f0_post_and_pitch_shift_match():
    rng = _rng(5)
    f0 = np.concatenate([np.zeros(5), rng.uniform(40.0, 1100.0, 200)]).astype(np.float32)
    for st in (0.0, 7.0, -12.0, 2.5):
        tf = tf0.apply_pitch_shift(torch.from_numpy(f0), st)
        jf = jf0.apply_pitch_shift(jnp.asarray(f0), st)
        np.testing.assert_allclose(_t(tf), _j(jf), rtol=1e-6)
        tc, tp = tdsp.get_f0_post(tf)
        jc, jp = jdsp.get_f0_post(jnp.asarray(_t(tf)))
        np.testing.assert_array_equal(_t(tc), _j(jc))
        np.testing.assert_array_equal(_t(tp), _j(jp))


@pytest.mark.parametrize("radius", [0, 3, 4, 7])
def test_median_filter_f0_matches(radius):
    f0 = _rng(6).uniform(80.0, 400.0, 64).astype(np.float32)
    np.testing.assert_array_equal(_t(tdsp.median_filter_f0(torch.from_numpy(f0), radius)),
                                  _j(jdsp.median_filter_f0(jnp.asarray(f0), radius)))


@pytest.mark.parametrize("n,size", [(41, 14401), (10, 25)])
def test_linear_interpolate_matches(n, size):
    x = _rng(7).uniform(0.0, 1.0, n).astype(np.float32)
    np.testing.assert_allclose(
        _t(tdsp.linear_interpolate_align_corners(torch.from_numpy(x), size)),
        _j(jdsp.linear_interpolate_align_corners(jnp.asarray(x), size)), atol=1e-6)


@pytest.mark.parametrize("mix", [1.0, 0.5, 0.0])
def test_envelope_mixing_matches(mix):
    rng = _rng(8)
    inp = (rng.standard_normal(16800) * np.linspace(0.05, 0.5, 16800)).astype(np.float32)
    out = (rng.standard_normal(16320) * 0.2).astype(np.float32)
    got = _t(tdsp.envelope_mixing(torch.from_numpy(inp), torch.from_numpy(out), 48000, mix))
    want = _j(jdsp.envelope_mixing(jnp.asarray(inp), jnp.asarray(out), 48000, mix))
    # window energies are differences of float32 prefix sums over ~16k
    # squared samples, taken in another order on each side
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_sola_offset_and_crossfade_match():
    rng = _rng(9)
    cfg = TChunkConfig.build()
    B, S = cfg.sola_buffer_frame_size, cfg.sola_search_frame_size
    t = np.arange(cfg.sample_frame_size + B + S) / 48000
    out = (np.sin(2 * np.pi * 210 * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    sola = (np.sin(2 * np.pi * 210 * (t[:B] + 123 / 48000))).astype(np.float32)
    t_off = tdsp.sola_offset(torch.from_numpy(out), torch.from_numpy(sola), B, S)
    j_off = jdsp.sola_offset(jnp.asarray(out), jnp.asarray(sola), B, S)
    assert int(t_off) == int(j_off)
    fin_t, fout_t = twindow.fade_windows(B)
    fin_j, fout_j = jwindow.fade_windows(B)
    for pv in (False, True):
        te, ts = tdsp.sola_crossfade(torch.from_numpy(out), torch.from_numpy(sola), t_off,
                                     fin_t, fout_t, cfg.sample_frame_size, phase_vocoder=pv)
        je, js = jdsp.sola_crossfade(jnp.asarray(out), jnp.asarray(sola), j_off, fin_j, fout_j,
                                     cfg.sample_frame_size, phase_vocoder=pv)
        # the phase vocoder sums B/2+1 cosines of float32 arguments up to
        # pi*B ~ 6e3 rad, where one float32 ulp of the argument is 5e-4 rad;
        # the two FFTs' last-bit phase differences move a few such ulps
        atol = 3e-3 if pv else 1e-6
        np.testing.assert_allclose(_t(te), _j(je), atol=atol)
        np.testing.assert_allclose(_t(ts), _j(js), atol=atol)


def test_slide_pitch_cache_matches():
    rng = _rng(10)
    tc = torch.zeros(1024)
    jc = jnp.zeros(1024)
    for _ in range(6):
        f0 = rng.uniform(0.0, 400.0, 64).astype(np.float32)
        tc = t_slide(tc, torch.from_numpy(f0), 30)
        jc = j_slide(jc, jnp.asarray(f0), 30)
        np.testing.assert_array_equal(_t(tc), _j(jc))
