"""The port's CREPE and FCPE pitch networks, their frontends and decoder, and
their checkpoint loaders, against the JAX package's, on the same seeded
numpy inputs.

Weights are drawn fan-in scaled from a numpy seed (``init_variables``), with
every norm scale, bias and BatchNorm statistic perturbed (``randomize``),
and carried across by ``models/weights.py``. Tolerances: the networks'
salience 1e-4 (CREPE ``tiny``, CREPE ``full`` over a few frames, FCPE at
hidden 64 with 2 layers), the CREPE frames 1e-6, the FCPE decode rtol 1e-6,
FCPE's Slaney log-mel 1e-4 (the RMVPE log-mel's bound is 2e-4 / 1e-4). In
bfloat16 each network is held to the error budget of
``test_torch_port_bf16.py`` against JAX float32 (salience tolerance 2e-4).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.dsp.mel import MelSpectrogram as JMelSpectrogram
from obs_rvc_tpu.models.crepe import Crepe as JCrepe
from obs_rvc_tpu.models.crepe import CrepeConfig as JCrepeConfig
from obs_rvc_tpu.models.crepe import extract_crepe_frames as j_extract_crepe_frames
from obs_rvc_tpu.models.fcpe import Fcpe as JFcpe
from obs_rvc_tpu.models.fcpe import FcpeConfig as JFcpeConfig
from obs_rvc_tpu.models.fcpe import decode_f0_fcpe as j_decode_f0_fcpe
from obs_rvc_tpu.models.fcpe import fcpe_cent_table as j_fcpe_cent_table
from obs_rvc_tpu.models.weights import export_crepe, export_fcpe

from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram
from obs_rvc_tpu_torch.models import checkpoints as C
from obs_rvc_tpu_torch.models import weights as W
from obs_rvc_tpu_torch.models.crepe import Crepe, CrepeConfig, extract_crepe_frames
from obs_rvc_tpu_torch.models.fcpe import Fcpe, FcpeConfig, decode_f0_fcpe, fcpe_cent_table

from test_torch_port_bf16 import _bf16, _cast, budget, init_variables
from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

FCPE_SMALL = dict(hidden=64, n_layers=2)


def _voiced_16k(n, seed=0):
    t = np.arange(n) / 16000
    f = 180.0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _crepe_frames(n_frames, seed=0):
    """Normalised frames of a voiced signal, by the JAX frontend."""
    x = _voiced_16k(160 * (n_frames - 1) + 1, seed)
    return np.array(j_extract_crepe_frames(jnp.asarray(x), n_frames))


def _fcpe_mel(seed=0, n=10080):
    """FCPE's input ``[T, 128]``: the JAX Slaney log-mel of a voiced signal."""
    return np.asarray(JMelSpectrogram(f_min=0.0, htk=False)(jnp.asarray(_voiced_16k(n, seed)))).T.copy()


def _run_crepe(capacity, frames, dtype=torch.float32, seed=0):
    """(JAX float32 salience, JAX variables, port module) for one capacity."""
    jm = JCrepe(JCrepeConfig(capacity))
    variables = init_variables(jm, jnp.asarray(frames), seed=seed)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(frames)))
    tm = W.load_state_dict(Crepe(CrepeConfig(capacity)).to(dtype), W.crepe_state_dict(variables))
    return want, variables, tm


@pytest.mark.parametrize("capacity,n_frames", [("tiny", 16), ("full", 3)])
def test_crepe_matches(capacity, n_frames):
    frames = _crepe_frames(n_frames, seed=1)
    want, _, tm = _run_crepe(capacity, frames)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == want.shape == (n_frames, 360)
    assert 0.01 < want.std() and want.min() < 0.5 < want.max()  # not saturated
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_crepe_flattens_time_major():
    """The classifier reads ``[N, H, C]`` flattened (torchcrepe's permute):
    a channel-major flatten has the same shape and gives another output."""
    frames = _crepe_frames(4, seed=2)
    want, _, tm = _run_crepe("tiny", frames)
    x = torch.from_numpy(frames)[:, None, :]
    with torch.no_grad():
        for i in range(1, 7):
            conv, bn = getattr(tm, f"conv{i}"), getattr(tm, f"conv{i}_BN")
            x = torch.nn.functional.pad(x, (254, 254) if i == 1 else (31, 32))
            x = torch.nn.functional.max_pool1d(bn(torch.relu(conv(x[..., None])[..., 0])), 2)
        wrong = torch.sigmoid(tm.classifier(x.reshape(x.shape[0], -1))).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_extract_crepe_frames_matches_with_silence():
    x = _voiced_16k(10080, seed=3)
    x[:4000] = 0.0  # whole frames of silence come out 0, not NaN
    for n_frames, sig in ((64, x), (64, np.zeros_like(x)), (5, x[:700])):
        want = np.asarray(j_extract_crepe_frames(jnp.asarray(sig), n_frames))
        got = extract_crepe_frames(torch.from_numpy(sig), n_frames).numpy()
        assert got.shape == want.shape == (n_frames, 1024) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert np.all(extract_crepe_frames(torch.zeros(10080), 64).numpy() == 0.0)


def test_fcpe_matches():
    mel = _fcpe_mel(seed=4)
    jm = JFcpe(JFcpeConfig(**FCPE_SMALL))
    variables = init_variables(jm, jnp.asarray(mel), seed=4)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(mel)))
    tm = W.load_state_dict(Fcpe(FcpeConfig(**FCPE_SMALL)), W.fcpe_state_dict(variables, FCPE_SMALL["n_layers"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel))
    assert got.dtype == torch.float32 and got.shape == want.shape == (64, 360)
    assert 0.01 < want.std() and want.min() < 0.5 < want.max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _salience_cases():
    rng = np.random.default_rng(5)
    peaks = [0, 1, 2, 3, 180, 356, 357, 358, 359]
    rows = []
    for p in peaks:
        row = rng.uniform(0.0, 0.3, 360).astype(np.float32)
        row[max(p - 3, 0) : p + 4] += 0.2
        row[p] = 0.9
        rows.append(row)
    at = np.full(360, 0.01, np.float32)
    at[200] = np.float32(0.05)  # exactly at the threshold: unvoiced (the test is strict)
    above = at.copy()
    above[200] = np.nextafter(np.float32(0.05), np.float32(1.0))
    rows += [at, above, np.zeros(360, np.float32), rng.uniform(0, 1, 360).astype(np.float32)]
    return np.stack(rows)


def test_decode_f0_fcpe_matches_at_the_edges_and_the_threshold():
    sal = _salience_cases()
    np.testing.assert_array_equal(fcpe_cent_table(), j_fcpe_cent_table())
    want = np.asarray(j_decode_f0_fcpe(jnp.asarray(sal), threshold=0.05))
    got = decode_f0_fcpe(torch.from_numpy(sal), threshold=0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert want[9] == 0.0 and want[10] > 0.0 and want[11] == 0.0  # at, just above the threshold; all zero
    assert np.all(want[:9] > 0) and want[0] < want[3] < want[4] < want[5] < want[8]


def test_slaney_log_mel_matches_jax():
    jmel = JMelSpectrogram(f_min=0.0, htk=False)
    tmel = MelSpectrogram(f_min=0.0, htk=False, device="cpu")
    np.testing.assert_allclose(tmel.mel_basis.numpy(), np.asarray(jmel.mel_basis), rtol=1e-6, atol=1e-9)
    assert float(tmel.mel_basis[0].sum()) > 0  # fmin 0: the first triangle starts at bin 0
    for L, sig in ((10080, _voiced_16k(10080, 6)), (9920, _voiced_16k(9920, 7)), (10080, np.zeros(10080, np.float32))):
        want = np.asarray(jmel(jnp.asarray(sig)))
        got = tmel(torch.from_numpy(sig)).numpy()
        assert got.shape == want.shape == (128, 1 + L // 160)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_crepe_checkpoint_loads_like_the_jax_model(tmp_path):
    """A torchcrepe-layout ``.pth`` (``Conv2d`` weights ``[out, in, k, 1]``)
    written from JAX variables loads into the port's ``Crepe`` and gives the
    JAX output."""
    frames = _crepe_frames(8, seed=8)
    want, variables, carried = _run_crepe("tiny", frames, seed=8)
    sd = export_crepe(variables)
    assert sd["conv1.weight"].shape == (128, 1, 512, 1)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, tmp_path / "crepe.pth")
    tm = C.load_crepe(Crepe(CrepeConfig("tiny")), tmp_path / "crepe.pth")
    with torch.no_grad():
        got, via_tree = tm(torch.from_numpy(frames)).numpy(), carried(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got, via_tree)
    with pytest.raises(ValueError, match="shape"):
        C.load_crepe(Crepe(CrepeConfig("full")), tmp_path / "crepe.pth")


def test_fcpe_checkpoint_loads_like_the_jax_model(tmp_path):
    """A torchfcpe-layout ``.pt`` (``model`` payload, ``output_proj`` weight-normed
    as ``weight_v``/``weight_g``, each layer's unused ``norm``) loads into the
    port's ``Fcpe`` and gives the JAX output, as the JAX-carried model does."""
    mel = _fcpe_mel(seed=9)
    jm = JFcpe(JFcpeConfig(**FCPE_SMALL))
    variables = init_variables(jm, jnp.asarray(mel), seed=9)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(mel)))
    sd = export_fcpe(variables, n_layers=FCPE_SMALL["n_layers"])
    assert sd["output_proj.weight_g"].shape == (360, 1) and sd["output_proj.weight_v"].shape == (360, 64)
    payload = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    payload["net.encoder_layers.0.norm.weight"] = torch.ones(64)  # in torchfcpe's files, unused by conv-only layers
    torch.save({"model": payload, "config": {"model": {"hidden_dims": 64}}}, tmp_path / "fcpe.pt")
    tm = C.load_fcpe(Fcpe(FcpeConfig(**FCPE_SMALL)), tmp_path / "fcpe.pt")
    carried = W.load_state_dict(Fcpe(FcpeConfig(**FCPE_SMALL)), W.fcpe_state_dict(variables, FCPE_SMALL["n_layers"]))
    with torch.no_grad():
        got, via_tree = tm(torch.from_numpy(mel)).numpy(), carried(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, via_tree, atol=1e-6, rtol=0)


def test_crepe_bf16_within_budget():
    frames = _crepe_frames(16, seed=10)
    want, variables, _ = _run_crepe("tiny", frames, seed=10)
    ref = np.asarray(jax.jit(JCrepe(JCrepeConfig("tiny", dtype=jnp.bfloat16)).apply)(_cast(variables),
                                                                                     jnp.asarray(frames)))
    tm = W.load_state_dict(Crepe(CrepeConfig("tiny")).to(torch.bfloat16), W.crepe_state_dict(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(frames))
    assert got.dtype == torch.float32
    budget("crepe tiny", got.numpy(), ref, want, 2e-4)


def test_fcpe_bf16_within_budget():
    mel = _fcpe_mel(seed=11)
    jcfg = JFcpeConfig(**FCPE_SMALL)
    variables = init_variables(JFcpe(jcfg), jnp.asarray(mel), seed=11)
    want = np.asarray(jax.jit(JFcpe(jcfg).apply)(variables, jnp.asarray(mel)))
    ref = np.asarray(jax.jit(JFcpe(_bf16(jcfg)).apply)(_cast(variables), jnp.asarray(mel)))
    tm = W.load_state_dict(Fcpe(FcpeConfig(**FCPE_SMALL)).to(torch.bfloat16),
                           W.fcpe_state_dict(variables, FCPE_SMALL["n_layers"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel))
    assert got.dtype == torch.float32
    budget("fcpe", got.numpy(), ref, want, 2e-4)


def test_pipeline_casts_and_loads_only_its_own_pitch_network(tmp_path):
    """``cast_params_for_serving`` casts the pitch network, CREPE's BatchNorm
    statistics included (its step counters stay int64); a checkpoint for a
    pitch network the pipeline does not run is refused, as the JAX loader
    fails on it."""
    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.stream import RvcPipeline

    from test_torch_port_pipeline import CV, SY
    from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig

    cfg = ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50)
    kw = dict(contentvec_cfg=ContentVecConfig(**CV), synth_cfg=SynthesizerConfig(**SY), device="cpu",
              crepe_cfg=CrepeConfig("tiny"))
    pipe = RvcPipeline(cfg, compute_dtype=torch.bfloat16, pitch_algorithm="crepe", **kw)
    pipe.crepe.float()  # a module left in float32: the cast makes sure of every tensor
    C.cast_params_for_serving(pipe)
    for name, t in pipe.crepe.state_dict().items():
        want = torch.int64 if name.endswith("num_batches_tracked") else torch.bfloat16
        assert t.dtype == want, name
    assert pipe.crepe.conv3_BN.running_var.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute dtype|computes in"):
        C.cast_params_for_serving(pipe, torch.float32)
    torch.save(W.crepe_state_dict(init_variables(JCrepe(JCrepeConfig("tiny")), jnp.zeros((4, 1024)))),
               tmp_path / "crepe.pth")
    f32 = RvcPipeline(cfg, pitch_algorithm="fcpe", **kw)
    with pytest.raises(ValueError, match="pitch algorithm is fcpe"):
        C.load_pipeline_params(f32, crepe_path=tmp_path / "crepe.pth")
