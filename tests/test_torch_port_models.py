"""The port's three networks against the JAX models, at reduced widths, with
weights carried across by the port's ``models/weights.py`` and every
BatchNorm statistic, scale and bias perturbed so that a wrong copy cannot
cancel out.

Tolerances are the JAX package's own for these nets (``PARITY.md``):
ContentVec and RMVPE 2e-4, the synthesizer 2e-3 (its float32 phase
cumulative sum over ``T * upp`` samples).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.models import ContentVec as JContentVec
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import RMVPE as JRMVPE
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import Synthesizer as JSynthesizer
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.models.contentvec import extract_feature as j_extract_feature
from obs_rvc_tpu.models.synthesizer import sine_source as j_sine_source

from obs_rvc_tpu_torch.models import weights as W
from obs_rvc_tpu_torch.models.contentvec import ContentVec, ContentVecConfig, extract_feature
from obs_rvc_tpu_torch.models.rmvpe import RMVPE, RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import Synthesizer, SynthesizerConfig, sine_source


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The suite runs six workers on the machine's cores, and a torch pool of
    one thread per core in each of them oversubscribes the CPU many times
    over (the port's files took nearly three times as long in parallel that
    way). Each port test module runs torch on two threads and restores the
    count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize(variables, seed=0):
    """Perturb norm scales, biases and BatchNorm statistics (variances kept
    positive); the other weights keep their random init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        arr = np.asarray(leaf, np.float32)
        if "batch_stats" in name and "var" in name:
            return rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rng.standard_normal(arr.shape)).astype(np.float32)
        if "bias" in name or ("batch_stats" in name and "mean" in name):
            return (0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(fill, variables)


CV_SMALL = dict(dim=64, num_layers=2, tap_layer=2, num_heads=4, ffn_dim=128, out_dim=64)


@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_contentvec_v2_matches(gelu_approximate):
    jcfg = JContentVecConfig(**CV_SMALL, gelu_approximate=gelu_approximate)
    tcfg = ContentVecConfig(**CV_SMALL, gelu_approximate=gelu_approximate)
    wav = (np.random.default_rng(1).standard_normal((1, 8000)) * 0.1).astype(np.float32)
    jm = JContentVec(jcfg)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(wav)))
    tm = W.load_state_dict(ContentVec(tcfg), W.contentvec_state_dict(variables, tcfg.num_layers))
    want = np.asarray(jm.apply(variables, jnp.asarray(wav)))
    with torch.no_grad():
        got = tm(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 24, 64)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(extract_feature(torch.from_numpy(want.copy())).numpy(),
                                  np.asarray(j_extract_feature(jnp.asarray(want))))


def test_contentvec_v1_final_projection_matches():
    kw = dict(CV_SMALL, num_layers=3, tap_layer=2, out_dim=32, final_proj=True)
    wav = (np.random.default_rng(2).standard_normal((1, 6400)) * 0.1).astype(np.float32)
    jm = JContentVec(JContentVecConfig(**kw))
    variables = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(wav)))
    tm = W.load_state_dict(ContentVec(ContentVecConfig(**kw)),
                           W.contentvec_state_dict(variables, 3, final_proj=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, jnp.asarray(wav))),
                               atol=2e-4, rtol=1e-4)


# C<=32 levels present (8, 16 and 32 channels) so the chain wrapper's plain
# path runs inside the net, plus a 64-channel intermediate level of plain convs
RMVPE_SMALL = dict(en_de_layers=3, inter_layers=1, n_blocks=2, en_out_channels=8, gru_hidden=32)


def test_rmvpe_matches():
    jm = JRMVPE(JRMVPEConfig(**RMVPE_SMALL))
    mel = np.random.default_rng(2).standard_normal((1, 128, 32)).astype(np.float32)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(mel)))
    tm = W.load_state_dict(RMVPE(RMVPEConfig(**RMVPE_SMALL)), W.rmvpe_state_dict(
        variables, RMVPE_SMALL["n_blocks"], RMVPE_SMALL["en_de_layers"], RMVPE_SMALL["inter_layers"]))
    fused = [m.fused for m in tm.modules() if hasattr(m, "fused")]
    assert any(fused) and not all(fused)
    want = np.asarray(jm.apply(variables, jnp.asarray(mel)))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 32, 360)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_rmvpe_folded_chain_follows_weight_updates():
    """The folded BatchNorm weights are recomputed after the weights change."""
    tm = RMVPE(RMVPEConfig(**RMVPE_SMALL)).eval()
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 128, 32)).astype(np.float32))
    with torch.no_grad():
        first = tm(mel)
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.mul_(2.0)
        second = tm(mel)
        for chain in (m for m in tm.modules() if getattr(m, "fused", False)):
            chain.fused = False
        plain = tm(mel)
    assert not torch.allclose(first, second)
    torch.testing.assert_close(second, plain, atol=1e-5, rtol=1e-5)


def _synth_case(jcfg, tcfg, T=12, seed=3, with_rnd=True):
    rng = np.random.default_rng(seed)
    phone = rng.standard_normal((1, T, jcfg.feature_dim)).astype(np.float32)
    pitch = rng.integers(1, 256, (1, T)).astype(np.int32)
    pitchf = np.where(rng.uniform(size=(1, T)) < 0.2, 0.0,
                      rng.uniform(80.0, 400.0, (1, T))).astype(np.float32)
    rnd = rng.standard_normal((1, T, jcfg.inter_channels)).astype(np.float32) if with_rnd else None
    sid = np.array([5], np.int32)
    jm = JSynthesizer(jcfg)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(phone), jnp.asarray(pitch),
                                  jnp.asarray(pitchf), jnp.asarray(sid)))
    tm = W.load_state_dict(Synthesizer(tcfg), W.synthesizer_state_dict(variables, tcfg))
    want = np.asarray(jm.apply(variables, jnp.asarray(phone), jnp.asarray(pitch), jnp.asarray(pitchf),
                               jnp.asarray(sid), None if rnd is None else jnp.asarray(rnd)))
    with torch.no_grad():
        got = tm(torch.from_numpy(phone), torch.from_numpy(pitch.astype(np.int64)),
                 torch.from_numpy(pitchf), torch.from_numpy(sid.astype(np.int64)),
                 None if rnd is None else torch.from_numpy(rnd)).numpy()
    return tm, got, want


# the 40 kHz generator with narrow levels: 128 → 64 → 32 channels, so the
# last two levels reach the bank at C=64 and C=32 as the full model's do
SYNTH_SMALL = dict(feature_dim=48, inter_channels=16, hidden_channels=16, filter_channels=32,
                   n_layers=2, upsample_initial_channel=128, upsample_rates=(4, 4),
                   upsample_kernel_sizes=(8, 8), gin_channels=16, spk_embed_dim=8)


@pytest.mark.parametrize("with_rnd", [True, False])
def test_synthesizer_matches(with_rnd):
    jcfg = JSynthesizerConfig(**SYNTH_SMALL)
    tcfg = SynthesizerConfig(**SYNTH_SMALL)
    tm, got, want = _synth_case(jcfg, tcfg, with_rnd=with_rnd)
    assert [tm.dec.uses_bank_kernel(c) for c in (64, 32)] == [True, True]
    assert got.shape == want.shape == (1, 12 * 16)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_synthesizer_three_levels_matches():
    """Three upsample levels with a C=128 level of plain convs before the bank levels."""
    kw = dict(SYNTH_SMALL, upsample_initial_channel=256, upsample_rates=(4, 2, 2),
              upsample_kernel_sizes=(8, 4, 4))
    tm, got, want = _synth_case(JSynthesizerConfig(**kw), SynthesizerConfig(**kw), T=8, seed=4)
    assert [tm.dec.uses_bank_kernel(c) for c in (128, 64, 32)] == [False, True, True]
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("sr", [32000, 40000, 48000])
def test_synthesizer_geometry_for_sample_rate(sr):
    jcfg = JSynthesizerConfig.for_sample_rate(sr)
    tcfg = SynthesizerConfig.for_sample_rate(sr)
    for f in dataclasses.fields(tcfg):
        if hasattr(jcfg, f.name) and f.name != "pallas_resblocks":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    # the kernel switch: on by default in the port, off in the JAX package (ROADMAP.md, recorded differences)
    assert tcfg.pallas_resblocks and not jcfg.pallas_resblocks
    assert tcfg.upp == jcfg.upp == sr // 100
    gen = Synthesizer(tcfg).dec
    chans = [up.out_channels for up in gen.ups]
    assert chans == [256, 128, 64, 32]
    assert [gen.uses_bank_kernel(c) for c in chans + [16]] == [False, False, True, True, True]
    # a T-frame input becomes T * sr/100 samples through the upsample stack
    T, L = 35, 35
    for up, u in zip(gen.ups, tcfg.upsample_rates):
        k, s, p = up.kernel_size[0], up.stride[0], up.padding[0]
        L = (L - 1) * s - 2 * p + k
        assert s == u
    assert L == T * sr // 100


def test_sine_source_matches():
    rng = np.random.default_rng(7)
    f0 = np.where(rng.uniform(size=(2, 35)) < 0.2, 0.0,
                  rng.uniform(60.0, 900.0, (2, 35))).astype(np.float32)
    got = sine_source(torch.from_numpy(f0), 400, 40000).numpy()
    want = np.asarray(j_sine_source(jnp.asarray(f0), 400, 40000, None))
    # sin of a float32 phase cumulative sum over 14000 samples
    np.testing.assert_allclose(got, want, atol=2e-4)
    g = torch.Generator().manual_seed(0)
    noisy = sine_source(torch.from_numpy(f0), 400, 40000, generator=g).numpy()
    assert np.abs(noisy - got).max() > 0
