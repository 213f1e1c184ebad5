"""The port's streaming step in bfloat16 against the JAX step, and v1 through
the whole step, at reduced widths (the ``CV``/``RM``/``SY`` of
``test_torch_port_pipeline.py``) and the default geometry.

Four chunks of a voiced signal go through four streams on the same float32
weights: the JAX step in float32 and in bfloat16 (jitted, flax
convolutions: XLA's CPU backend does not compile the Pallas kernels' bf16
products), and the port's in both dtypes, each bf16 side after its own
``cast_params_for_serving``. The bf16 gates are the error budgets of
``test_torch_port_bf16.py`` (``budget``): the emitted audio (tolerance
2e-3), the RMVPE salience of each chunk's pitch window (2e-4) and the f0
track decoded from it (2e-4); the f0 moves too little in bf16 to show the
rounding (its ``e_ref`` is ~1e-5), so the salience carries the check that
the bf16 path rounded. The pitch codes must equal JAX bf16's on at least 90%
of the frames and be within one code on the rest. v1 (ContentVec's final
projection to a narrower feature width, which the synthesizer takes) also
holds the float32 step's tolerances.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.config import RvcModelVersion as JVersion
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.models.checkpoints import cast_params_for_serving as j_cast
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamState as JState

from obs_rvc_tpu_torch.config import ChunkConfig, RvcModelVersion
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models.weights import load_jax_params
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState

from test_torch_port_bf16 import budget
from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, RM, SY, _codes_distance, voiced_signal

N_CHUNKS = 4
CONTROLS = dict(pitch_shift=2.0, rms_mix_rate=0.5)


def _configs(version):
    cv, sy = dict(CV), dict(SY)
    if version == "v1":
        cv.update(out_dim=32, final_proj=True)
        sy.update(feature_dim=32)
    return cv, sy


def run_streams(version):
    """``{side: [(emitted audio, salience, f0, pitch codes) per chunk]}`` for
    the sides ``jax float32``, ``jax bfloat16``, ``port float32`` and ``port
    bfloat16``, all on one set of float32 weights."""
    cv, sy = _configs(version)
    jver, tver = ((JVersion.V1, RvcModelVersion.V1) if version == "v1" else (JVersion.V2, RvcModelVersion.V2))
    cfg = ChunkConfig.build()
    wav = voiced_signal(N_CHUNKS, cfg, seed=5)
    chunks = [wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size] for i in range(N_CHUNKS)]
    params, out = None, {}
    for name in ("float32", "bfloat16"):
        jpipe = JPipeline(JChunkConfig.build(), version=jver, contentvec_cfg=JContentVecConfig(**cv),
                          rmvpe_cfg=JRMVPEConfig(**RM), synth_cfg=JSynthesizerConfig(**sy),
                          compute_dtype=getattr(jnp, name))
        if params is None:
            params = jpipe.init_params_fast(0)
            params = {k: randomize(v, seed=i) for i, (k, v) in enumerate(sorted(params.items()))}
        jparams = j_cast(params) if name == "bfloat16" else params
        jstep, jpitch = jax.jit(jpipe.step), jax.jit(jpipe._pitch_cache_update)
        jsal = jax.jit(lambda p, b, jpipe=jpipe: jpipe._pitch_net(p, jpipe._pitch_frontend(b)))
        state, rows, jc = jax.tree.map(jnp.asarray, JState.init(jpipe.cfg)), [], JControls.default(**CONTROLS)
        for chunk in chunks:
            new, audio = jstep(jparams, state, jnp.asarray(chunk), jc)
            _, codes, f0 = jpitch(state.cache_pitchf, new.input_buffer_16k, jc, jparams)
            sal = jsal(jparams, new.input_buffer_16k)
            rows.append(tuple(np.asarray(a) for a in (audio, sal, f0, codes)))
            state = new
        out[f"jax {name}"] = rows

        tpipe = RvcPipeline(cfg, tver, contentvec_cfg=ContentVecConfig(**cv), rmvpe_cfg=RMVPEConfig(**RM),
                            synth_cfg=SynthesizerConfig(**sy), device="cpu", compute_dtype=getattr(torch, name))
        load_jax_params(tpipe, params)
        if name == "bfloat16":
            cast_params_for_serving(tpipe)
        state, rows, tc = StreamState.init(cfg, device="cpu"), [], StepControls.default(**CONTROLS)
        with torch.no_grad():
            for chunk in chunks:
                new, audio = tpipe.step(state, torch.from_numpy(chunk), tc)
                _, codes, f0 = tpipe._pitch_cache_update(state.cache_pitchf, new.input_buffer_16k, tc)
                sal = tpipe.stage_salience(tpipe.stage_mel(new.input_buffer_16k[None]))[0]
                assert audio.dtype == f0.dtype == sal.dtype == new.cache_pitchf.dtype == torch.float32
                rows.append(tuple(t.numpy() for t in (audio, sal, f0, codes)))
                state = new
        out[f"port {name}"] = rows
    return out


@pytest.fixture(scope="module", params=["v2", "v1"])
def streams(request):
    return request.param, run_streams(request.param)


def test_step_bf16_within_budget_over_chunks(streams):
    version, runs = streams
    audio, sal, f0, codes = ({side: np.concatenate([r[j] for r in rows]) for side, rows in runs.items()}
                             for j in range(4))
    assert np.abs(audio["jax float32"]).max() > 1e-3
    for what, got, tol in (("emitted audio", audio, 2e-3), ("salience", sal, 2e-4)):
        budget(f"step {version} {what}", got["port bfloat16"], got["jax bfloat16"], got["jax float32"], tol)
    budget(f"step {version} f0", f0["port bfloat16"], f0["jax bfloat16"], f0["jax float32"], 2e-4, floor=0.0)
    same = codes["port bfloat16"] == codes["jax bfloat16"]
    print(f"step {version} pitch codes: {int((~same).sum())} of {same.size} frames differ from JAX bf16's "
          f"(JAX bf16 vs JAX f32: {int((codes['jax bfloat16'] != codes['jax float32']).sum())})")
    assert same.mean() >= 0.9
    assert np.abs(codes["port bfloat16"].astype(int) - codes["jax bfloat16"]).max() <= 1


def test_step_matches_jax_in_float32(streams):
    """The float32 tolerances of ``test_torch_port_pipeline.py``: f0 rtol
    1e-4, codes exact away from a code boundary, emitted audio atol 2e-3 (v2
    is held there too; this holds v1)."""
    version, runs = streams
    for i, (j, t) in enumerate(zip(runs["jax float32"], runs["port float32"])):
        (ja, _, jf, jc), (ta, _, tf, tc) = j, t
        np.testing.assert_allclose(tf, jf, rtol=1e-4, err_msg=f"{version} f0, chunk {i}")
        clear = _codes_distance(jf) > 1e-3
        np.testing.assert_array_equal(tc[clear], jc[clear], err_msg=f"{version} codes, chunk {i}")
        assert np.abs(tc.astype(int) - jc).max() <= 1
        np.testing.assert_allclose(ta, ja, atol=2e-3, err_msg=f"{version} emitted audio, chunk {i}")
