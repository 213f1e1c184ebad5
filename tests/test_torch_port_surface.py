"""The port's public surface against the JAX package's, on the CPU: every
name a JAX subpackage's ``__all__`` lists is in the port's counterpart
(``ops.log_mel_pallas`` is the port's ``ops.log_mel``) and resolves, and the
functions that came with it are held against their JAX counterparts:
``ReloadTier``/``diff_settings``, ``RvcModelVersion.output_layers``,
``hann_window``, ``pad_constant``, ``resample_poly_dilated`` and the
``dsp`` names listed there (exact, or at 1e-6 for float32 arithmetic).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import obs_rvc_tpu
from obs_rvc_tpu import config as jconfig
from obs_rvc_tpu import dsp as jdsp
from obs_rvc_tpu.dsp.resample import resample_poly_dilated as j_resample_poly_dilated

import obs_rvc_tpu_torch
from obs_rvc_tpu_torch import config as tconfig
from obs_rvc_tpu_torch import dsp as tdsp

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

#: a JAX name whose port counterpart has another name
RENAMED = {"ops.log_mel_pallas": "ops.log_mel"}


@pytest.mark.parametrize("sub", ["", "dsp", "models", "ops", "parallel", "retrieval", "serve", "stream", "utils"])
def test_every_jax_public_name_is_in_the_port(sub):
    jmod = importlib.import_module("obs_rvc_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("obs_rvc_tpu_torch" + (f".{sub}" if sub else ""))
    for name in jmod.__all__:
        qual = f"{sub}.{name}" if sub else name
        ported = RENAMED.get(qual, qual).rsplit(".", 1)[-1]
        assert ported in tmod.__all__, f"{qual} missing from the port's __all__"
        assert getattr(tmod, ported) is not None
    for name in tmod.__all__:
        getattr(tmod, name)


def test_version_and_root_names():
    assert obs_rvc_tpu_torch.__version__ == obs_rvc_tpu.__version__
    assert [m.name for m in obs_rvc_tpu_torch.PitchAlgorithm] == [m.name for m in obs_rvc_tpu.PitchAlgorithm]
    assert [f.name for f in dataclasses.fields(obs_rvc_tpu_torch.StreamSettings)] == \
        [f.name for f in dataclasses.fields(obs_rvc_tpu.StreamSettings)]


def test_reload_tiers_and_output_layers():
    assert [(t.name, int(t)) for t in tconfig.ReloadTier] == [(t.name, int(t)) for t in jconfig.ReloadTier]
    for v in ("v1", "v2"):
        assert tconfig.RvcModelVersion.from_str(v).output_layers == jconfig.RvcModelVersion.from_str(v).output_layers
    changes = {"pitch_shift": 3, "index_rate": 0.5, "rms_mix_rate": 0.9, "sample_length": 0.2, "fade_length": 0.05,
               "extra_inference_time": 1.0, "dest_sample_rate": 48000, "skip_inference": True,
               "resonance_shift": 2.0, "model_path": "m.pth", "index_path": "i.index", "model_version": "v1",
               "pitch_algorithm": "fcpe"}
    assert set(changes) == {f.name for f in dataclasses.fields(jconfig.StreamSettings)}

    def settings(pkg, **kw):
        c = pkg.config
        conv = {"model_version": c.RvcModelVersion.from_str, "pitch_algorithm": c.PitchAlgorithm.from_str}
        return c.StreamSettings(**{k: conv.get(k, lambda x: x)(v) for k, v in kw.items()})

    keys = list(changes)
    cases = [{}] + [{k: changes[k]} for k in keys] + [{a: changes[a], b: changes[b]}
                                                      for a, b in zip(keys, keys[3:] + keys[:3])]
    for kw in cases:
        want = jconfig.diff_settings(settings(obs_rvc_tpu), settings(obs_rvc_tpu, **kw))
        got = tconfig.diff_settings(settings(obs_rvc_tpu_torch), settings(obs_rvc_tpu_torch, **kw))
        assert (got.name, int(got)) == (want.name, int(want)), kw


@pytest.mark.parametrize("n", [1, 2, 16, 1024])
def test_windows_and_padding(n):
    if n > 1:
        np.testing.assert_allclose(tdsp.hann_window(n).numpy(), np.asarray(jdsp.hann_window(n)), atol=1e-7)
    x = np.random.default_rng(n).standard_normal(n + 8).astype(np.float32)
    for pad in (0, 3, 7):
        np.testing.assert_array_equal(tdsp.pad_constant(torch.from_numpy(x), pad, 0.5).numpy(),
                                      np.asarray(jdsp.pad_constant(jnp.asarray(x), pad, 0.5)))
        np.testing.assert_array_equal(tdsp.pad_reflect(torch.from_numpy(x), pad).numpy(),
                                      np.asarray(jdsp.pad_reflect(jnp.asarray(x), pad)))


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 16000), (40000, 48000), (44100, 16000), (16000, 16000)])
def test_resample_poly_dilated_matches_jax_and_the_phase_bank(sr_in, sr_out):
    x = np.random.default_rng(sr_in).standard_normal((2, 2205)).astype(np.float32)
    got = tdsp.resample_poly_dilated(torch.from_numpy(x), sr_in, sr_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_resample_poly_dilated(jnp.asarray(x), sr_in, sr_out)),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tdsp.resample_poly(torch.from_numpy(x), sr_in, sr_out).numpy(), atol=1e-5)
    one = tdsp.resample_poly_dilated(torch.from_numpy(x[0]), sr_in, sr_out)
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=1e-6)


def test_dsp_names_match_jax():
    np.testing.assert_array_equal(np.asarray(tdsp.CENTS_MAPPING, np.float32), np.asarray(jdsp.CENTS_MAPPING))
    for a, b in zip(tdsp.dft_matrices(64), jdsp.dft_matrices(64)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(tdsp.frame_signal(torch.from_numpy(x), 128, 40, 20).numpy(),
                                  np.asarray(jdsp.frame_signal(jnp.asarray(x), 128, 40, 20)))
    sal = np.random.default_rng(1).uniform(0, 1, (12, 360)).astype(np.float32) ** 4
    sal[3] = 0.0  # a frame under the threshold
    np.testing.assert_allclose(tdsp.to_local_average_cents(torch.from_numpy(sal)).numpy(),
                               np.asarray(jdsp.to_local_average_cents(jnp.asarray(sal))), rtol=1e-6, atol=1e-3)
