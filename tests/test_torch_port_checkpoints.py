"""The port's checkpoint loader against the JAX package's, on files the tests
write: an RVC release-format ``.pth`` (``{"weight", "config", "f0",
"version", "sr"}``, weight-normed keys) at reduced widths loads into both
packages, and their synthesizers agree to atol 2e-3 (the synthesizer's
bound); ``synthesizer_config_from_meta`` agrees field by field. fairseq and
RMVPE files with their prefixes, weight-normed ``pos_conv`` and training-only
keys load into the port exactly, and so does an ``.onnx`` container of the
same state dict.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.models import Synthesizer as JSynthesizer
from obs_rvc_tpu.models.checkpoints import load_synthesizer_params as j_load_synthesizer_params
from obs_rvc_tpu.models.checkpoints import synthesizer_config_from_meta as j_config_from_meta

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models import ContentVec, ContentVecConfig, RMVPE, RMVPEConfig, Synthesizer
from obs_rvc_tpu_torch.models import checkpoints as C
from obs_rvc_tpu_torch.models.onnx_reader import write_onnx_weights
from obs_rvc_tpu_torch.stream import RvcPipeline

from test_checkpoint_conversion import make_synth_state_dict
from test_torch_port_pipeline import CV, RM
from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

#: the positional config of a small v2 40 kHz model: 6 layers (the JAX
#: loader's default) at hidden width 16, upsampling from 128 channels
CONFIG = [1025, 32, 16, 16, 32, 2, 6, 3, 0, "1", [3, 7, 11], [[1, 3, 5]] * 3, [10, 10, 2, 2], 128,
          [16, 16, 4, 4], 4, 16, "40k"]


@pytest.fixture(scope="module")
def release_pth(tmp_path_factory):
    meta = {"config": CONFIG, "f0": 1, "version": "v2", "sr": "40k"}
    jcfg = j_config_from_meta(meta)
    sd = make_synth_state_dict(np.random.default_rng(3), jcfg)
    # weight-normed pairs keep their scale; the plain weights are scaled to
    # keep activations near unit size
    sd = {k: v if k.endswith(("weight_g", "weight_v")) else 0.1 * v for k, v in sd.items()}
    assert any(k.endswith("weight_g") for k in sd)
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({"weight": {k: torch.from_numpy(v) for k, v in sd.items()}, **meta}, path)
    return path, meta


def test_synthesizer_config_from_meta_matches_field_by_field(release_pth):
    _, meta = release_pth
    for m in (meta, {"sr": "48k", "version": "v1"}, {"sr": 32000}, {**meta, "config": CONFIG[:-1]}):
        got, want = C.synthesizer_config_from_meta(m), j_config_from_meta(m)
        for f in dataclasses.fields(got):
            if f.name != "pallas_resblocks":
                assert getattr(got, f.name) == getattr(want, f.name), (m, f.name)
        # the kernel switch: on by default in the port, off in the JAX package (ROADMAP.md, recorded differences)
        assert got.pallas_resblocks and not want.pallas_resblocks


def test_release_checkpoint_loads_into_both_packages_alike(release_pth):
    path, _ = release_pth
    jparams, jmeta = j_load_synthesizer_params(path)
    jcfg = j_config_from_meta(jmeta)
    tcfg = C.synthesizer_config_from_meta(jmeta)
    model = Synthesizer(tcfg).eval()
    meta = C.load_synthesizer(model, path)
    assert meta["version"] == "v2" and meta["sr"] == "40k"

    rng = np.random.default_rng(4)
    T = 12
    phone = (rng.standard_normal((1, T, tcfg.feature_dim)) * 0.5).astype(np.float32)
    pitchf = (180.0 + 20.0 * rng.standard_normal((1, T))).astype(np.float32)
    pitch = np.clip(np.round(pitchf / 4), 1, 255).astype(np.int32)
    want = np.asarray(JSynthesizer(jcfg).apply(jax.tree.map(jnp.asarray, jparams), jnp.asarray(phone),
                                               jnp.asarray(pitch), jnp.asarray(pitchf),
                                               jnp.zeros((1,), jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(phone), torch.from_numpy(pitch).long(), torch.from_numpy(pitchf),
                    torch.zeros(1, dtype=torch.long)).numpy()
    assert got.shape == want.shape == (1, T * 400)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-3)


def _randomized(module, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
            if v.is_floating_point() else v for k, v in module.state_dict().items()}


def test_contentvec_and_rmvpe_files_load_exactly(tmp_path):
    cv = ContentVec(ContentVecConfig(**CV))
    sd = _randomized(cv, 0)
    w = sd.pop("encoder.pos_conv.0.weight")
    # fairseq stores pos_conv weight-normed over the tap axis (dim=2)
    g = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    fairseq = {"hubert." + k: v for k, v in sd.items()}
    fairseq.update({"hubert.encoder.pos_conv.0.weight_g": g, "hubert.encoder.pos_conv.0.weight_v": w * 3.0,
                    "hubert.label_embs_concat": torch.zeros(3, 4), "hubert.mask_emb": torch.zeros(4)})
    torch.save({"model": fairseq, "cfg": {"note": "training config"}}, tmp_path / "cv.pt")
    fresh = C.load_contentvec(ContentVec(ContentVecConfig(**CV)), tmp_path / "cv.pt")
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, w if k == "encoder.pos_conv.0.weight" else sd[k], rtol=1e-6, atol=1e-7)

    rm = RMVPE(RMVPEConfig(**RM))
    sd = _randomized(rm, 1)
    torch.save({"model." + k: v for k, v in sd.items()}, tmp_path / "rmvpe.pt")
    fresh = C.load_rmvpe(RMVPE(RMVPEConfig(**RM)), tmp_path / "rmvpe.pt")
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)

    del sd["fc.1.weight"]
    torch.save(sd, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="lacks"):
        C.load_rmvpe(RMVPE(RMVPEConfig(**RM)), tmp_path / "short.pt")
    sd["fc.1.weight"] = torch.zeros(3, 3)
    torch.save(sd, tmp_path / "wrong.pt")
    with pytest.raises(ValueError, match="shape"):
        C.load_rmvpe(RMVPE(RMVPEConfig(**RM)), tmp_path / "wrong.pt")
    # an .onnx container of the same state dict (its initializers) loads the same way
    want = _randomized(rm, 1)
    # (torch's ONNX export keeps no BatchNorm step counters)
    write_onnx_weights(tmp_path / "rmvpe.onnx", {"model." + k: v.numpy() for k, v in want.items()
                                                 if not k.endswith("num_batches_tracked")})
    fresh = C.load_rmvpe(RMVPE(RMVPEConfig(**RM)), tmp_path / "rmvpe.onnx")
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_load_pipeline_params_fills_what_is_given(release_pth):
    path, meta = release_pth
    kw = dict(contentvec_cfg=ContentVecConfig(**CV), rmvpe_cfg=RMVPEConfig(**RM),
              synth_cfg=C.synthesizer_config_from_meta(meta), device="cpu")
    cfg = ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50)
    pipe, ref = RvcPipeline(cfg, **kw), RvcPipeline(cfg, **kw)
    C.load_pipeline_params(pipe, synthesizer_path=path, seed=5)
    ref.init_params(5, std=None)
    for k, v in pipe.contentvec.state_dict().items():  # left out: the random weights of the seed
        torch.testing.assert_close(v, ref.contentvec.state_dict()[k], rtol=0, atol=0)
    sd, _ = C.load_synthesizer_state(path)
    folded = C.fold_weight_norm(sd)
    for k, v in pipe.synthesizer.state_dict().items():
        torch.testing.assert_close(v, torch.as_tensor(np.asarray(folded[k], np.float32)), rtol=1e-6, atol=1e-7)
