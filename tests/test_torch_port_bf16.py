"""bfloat16 compute in the port (``RvcPipeline(compute_dtype=torch.bfloat16)``,
the JAX server's default) held to the JAX package at reduced widths.

bf16 rounds at other places in XLA than in PyTorch, so the port's bf16
output cannot be held to the JAX bf16 output at a float32 bound. Each gate
is an error budget against the JAX float32 output instead::

    e_ref  = max|JAX_bf16  - JAX_f32| / max|JAX_f32|
    e_port = max|port_bf16 - JAX_f32| / max|JAX_f32|
    e_port <= 2 * e_ref + tol_f32,   e_ref > 1e-4

``tol_f32`` is the part's float32 tolerance (ContentVec and RMVPE 2e-4, the
synthesizer and the emitted audio 2e-3); ``e_ref > 1e-4`` shows that the
bf16 path really rounded. Both sides start from the same float32 weights
(``randomize``, carried across by ``load_jax_params``) and apply their own
``cast_params_for_serving``. The JAX reference runs RMVPE and the
synthesizer as the JAX server does on the TPU, through the Pallas kernels
(in interpret mode, eagerly: XLA's CPU backend does not compile their
bf16 x bf16 -> f32 products). Each gate prints both errors. The whole step
is gated in ``test_torch_port_bf16_step.py``.

Also: ``cast_params_for_serving`` and the kernels' weight packs, and the
engine's dtype at a second geometry.
"""

import copy
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
from obs_rvc_tpu.models.checkpoints import cast_params_for_serving as j_cast

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models import weights as W
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
from obs_rvc_tpu_torch.models.contentvec import ContentVec, ContentVecConfig
from obs_rvc_tpu_torch.models.layers import BatchNorm2d
from obs_rvc_tpu_torch.models.rmvpe import RMVPE, RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import Synthesizer, SynthesizerConfig
from obs_rvc_tpu_torch.stream import RvcEngine, RvcPipeline

from test_torch_port_models import CV_SMALL, RMVPE_SMALL, SYNTH_SMALL, few_torch_threads, randomize  # noqa: F401
from test_torch_port_cuda import norm_rule_mismatch
from test_torch_port_pipeline import CV, RM, SY

BF16 = torch.bfloat16
# the JAX Pallas references run eagerly, op by op: narrower than the float32
# model tests' networks, so that each stays within seconds. RMVPE keeps two
# chain levels (8 and 16 channels) and a plain 32-channel one; the
# synthesizer keeps its C=64 and C=32 bank levels
RMVPE_PALLAS = dict(RMVPE_SMALL, en_de_layers=2, n_blocks=1, gru_hidden=16)
SYNTH_PALLAS = dict(SYNTH_SMALL, n_layers=1, flow_flows=2, flow_layers=2)


def budget(name, port, j_bf16, j_f32, tol, floor=1e-4):
    """Assert the error budget, and ``e_ref > floor``; returns ``(e_ref, e_port)``."""
    port, j_bf16, j_f32 = (np.asarray(a, np.float64) for a in (port, j_bf16, j_f32))
    assert port.shape == j_bf16.shape == j_f32.shape
    scale = np.abs(j_f32).max()
    e_ref = np.abs(j_bf16 - j_f32).max() / scale
    e_port = np.abs(port - j_f32).max() / scale
    print(f"{name}: e_ref {e_ref:.3e}, e_port {e_port:.3e}, budget 2*e_ref + {tol:g} = {2 * e_ref + tol:.3e}")
    assert np.isfinite(port).all()
    assert e_ref > floor, f"{name}: the JAX bf16 path did not round (e_ref {e_ref:.2e})"
    assert e_port <= 2 * e_ref + tol, f"{name}: e_port {e_port:.3e} over 2*{e_ref:.3e} + {tol}"
    return e_ref, e_port


def init_variables(module, *args, seed=0):
    """The module's variables from their shapes (``jax.eval_shape``, no
    compile), fan-in scaled normal draws from a numpy seed, then
    ``randomize``'s norm scales, biases and statistics."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree.map(draw, shapes), seed=seed)


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype=jnp.bfloat16)


def _cast(variables):
    return j_cast({"net": variables})["net"]


# ---------------------------------------------------------------------------
# the three networks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_contentvec_bf16_within_budget(version):
    kw = dict(CV_SMALL) if version == "v2" else dict(CV_SMALL, num_layers=3, tap_layer=2, out_dim=32,
                                                       final_proj=True)
    jcfg = JContentVecConfig(**kw)
    wav = (np.random.default_rng(11).standard_normal((1, 8000)) * 0.1).astype(np.float32)
    variables = init_variables(JContentVec(jcfg), jnp.asarray(wav))
    want = np.asarray(jax.jit(JContentVec(jcfg).apply)(variables, jnp.asarray(wav)))
    ref = np.asarray(jax.jit(JContentVec(_bf16(jcfg)).apply)(_cast(variables), jnp.asarray(wav)))
    tm = ContentVec(ContentVecConfig(**kw)).to(BF16)
    W.load_state_dict(tm, W.contentvec_state_dict(variables, kw["num_layers"], kw.get("final_proj", False)))
    with torch.no_grad():
        got = tm(torch.from_numpy(wav))
    assert got.dtype == torch.float32 and got.shape == want.shape
    budget(f"contentvec {version}", got.numpy(), ref, want, 2e-4)


def test_rmvpe_bf16_within_budget_of_the_pallas_chain():
    mel = np.random.default_rng(12).standard_normal((1, 128, 32)).astype(np.float32)
    jcfg = JRMVPEConfig(**RMVPE_PALLAS)
    variables = init_variables(JRMVPE(jcfg), jnp.asarray(mel))
    want = np.asarray(jax.jit(JRMVPE(jcfg).apply)(variables, jnp.asarray(mel)))
    # the JAX server's configuration: the C<=32 levels through the Pallas chain, bf16
    ref = np.asarray(JRMVPE(dataclasses.replace(jcfg, dtype=jnp.bfloat16, pallas_unet=True)).apply(
        _cast(variables), jnp.asarray(mel)))
    tm = RMVPE(RMVPEConfig(**RMVPE_PALLAS)).to(BF16)
    W.load_state_dict(tm, W.rmvpe_state_dict(variables, RMVPE_PALLAS["n_blocks"], RMVPE_PALLAS["en_de_layers"],
                                             RMVPE_PALLAS["inter_layers"]))
    assert any(getattr(m, "fused", False) for m in tm.modules())
    with torch.no_grad():
        got = tm(torch.from_numpy(mel))
    assert got.dtype == torch.float32
    budget("rmvpe", got.numpy(), ref, want, 2e-4)


@pytest.mark.parametrize("with_rnd", [False, True])
def test_synthesizer_bf16_within_budget_of_the_pallas_banks(with_rnd):
    rng = np.random.default_rng(13)
    T = 12
    jcfg = JSynthesizerConfig(**SYNTH_PALLAS)
    phone = rng.standard_normal((1, T, jcfg.feature_dim)).astype(np.float32)
    pitch = rng.integers(1, 256, (1, T)).astype(np.int32)
    pitchf = np.where(rng.uniform(size=(1, T)) < 0.2, 0.0, rng.uniform(80.0, 400.0, (1, T))).astype(np.float32)
    rnd = rng.standard_normal((1, T, jcfg.inter_channels)).astype(np.float32) if with_rnd else None
    sid = np.array([3], np.int32)
    jargs = tuple(jnp.asarray(a) for a in (phone, pitch, pitchf, sid)) + (None if rnd is None else jnp.asarray(rnd),)
    variables = init_variables(JSynthesizer(jcfg), *jargs[:4])
    want = np.asarray(jax.jit(JSynthesizer(jcfg).apply)(variables, *jargs))
    ref = np.asarray(JSynthesizer(dataclasses.replace(jcfg, dtype=jnp.bfloat16, pallas_resblocks=True)).apply(
        _cast(variables), *jargs))
    tm = Synthesizer(SynthesizerConfig(**SYNTH_PALLAS)).to(BF16)
    W.load_state_dict(tm, W.synthesizer_state_dict(variables, tm.cfg))
    assert tm.dec.uses_bank_kernel(64) and tm.dec.uses_bank_kernel(32)
    with torch.no_grad():
        got = tm(torch.from_numpy(phone), torch.from_numpy(pitch.astype(np.int64)), torch.from_numpy(pitchf),
                 torch.from_numpy(sid.astype(np.int64)), None if rnd is None else torch.from_numpy(rnd))
    assert got.dtype == torch.float32
    budget(f"synthesizer (rnd {with_rnd})", got.numpy(), ref, want, 2e-3)


# ---------------------------------------------------------------------------
# casting, packs, the engine
# ---------------------------------------------------------------------------


def test_bf16_norms_follow_flax_rule():
    """The networks' norms on the CPU, with a bfloat16 input and bfloat16
    parameters, compute as flax's norms with ``dtype`` do: float32 inside,
    one rounding at the output (``test_torch_port_cuda.py`` holds the card's);
    RMVPE's first BatchNorm takes the float32 mel and normalises it in
    float32 over its bf16 values."""
    for name, (share, steps) in norm_rule_mismatch("cpu").items():
        print(f"{name}: {share:.2e} of the outputs differ, by at most {steps:g} bf16 steps")
        assert share <= 1e-2 and steps <= 1.0, (name, share, steps)
    bn = BatchNorm2d(4).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        bn.running_var.copy_(torch.tensor([0.7, 1.3, 0.9, 1.1]))
        bn.weight.copy_(torch.tensor([1.1, 0.9, 1.2, 0.8]))
    mel = torch.randn(1, 4, 6, 8, generator=torch.Generator().manual_seed(1)) * 4
    want = bn(mel)  # float32
    got = bn.to(BF16)(mel)
    assert got.dtype == BF16
    torch.testing.assert_close(got, copy.deepcopy(bn).float()(mel).to(BF16))
    assert (got.float() - want).abs().max() > 0  # the stored values were rounded


def _small_pipe(compute_dtype, **geometry):
    return RvcPipeline(ChunkConfig.build(**geometry), contentvec_cfg=ContentVecConfig(**CV),
                       rmvpe_cfg=RMVPEConfig(**RM), synth_cfg=SynthesizerConfig(**SY), device="cpu",
                       compute_dtype=compute_dtype)


def test_cast_params_for_serving_casts_every_floating_tensor():
    pipe = _small_pipe(BF16)
    pipe.init_params(1)
    assert cast_params_for_serving(pipe) is pipe
    ints = 0
    for module in pipe.modules().values():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == BF16, name
            else:
                assert name.endswith("num_batches_tracked") and t.dtype == torch.int64, name
                ints += 1
    assert ints > 0  # the BatchNorms' counters are there, and untouched
    with pytest.raises(ValueError, match="compute_dtype"):
        cast_params_for_serving(_small_pipe(torch.float32))  # would change what the networks compute in
    with pytest.raises(ValueError, match="compute_dtype"):
        cast_params_for_serving(pipe, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _small_pipe(torch.float16)


def test_weight_packs_are_rebuilt_after_a_cast():
    """The chain's folded blocks and the bank's stacked params (and the
    kernels' packs made from them) follow the weights through a cast."""
    rm = RMVPE(RMVPEConfig(**RM))
    syn = Synthesizer(SynthesizerConfig(**SY))
    chain = next(m for m in rm.modules() if getattr(m, "fused", False))
    before = (chain._blocks(), syn.dec.bank_params(0), syn.dec.packed_bank(0, torch.float32))
    assert chain._blocks() is before[0] and syn.dec.bank_params(0) is before[1]
    rm.to(BF16)
    syn.to(BF16)
    blocks, params = chain._blocks(), syn.dec.bank_params(0)
    assert blocks is not before[0] and params is not before[1]
    assert blocks[0][0].dtype == BF16 and params[0][0].dtype == BF16
    pack = syn.dec.packed_bank(0, BF16)
    assert pack.dtype == BF16 and pack is syn.dec.packed_bank(0, BF16)
    assert chain._packed(BF16).dtype == BF16
    with torch.no_grad():
        ref = rm.unet.encoder.layers[0].conv[0].conv[1]
        torch.testing.assert_close(blocks[0][0], chain[0].folded()[0])
        assert ref.running_var.dtype == BF16


def test_engine_keeps_the_dtype_at_a_second_geometry():
    """An RPC request at a geometry other than the launch one runs on a
    pipeline of its own; it computes in the launch pipeline's bf16."""
    launch = _small_pipe(BF16, sample_length=0.10, extra_inference_time=0.50)
    launch.init_params(2)
    engine = RvcEngine(launch)
    seen = []
    hook = launch.synthesizer.dec.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    try:
        other = ChunkConfig.build(sample_length=0.20, extra_inference_time=0.30)
        t = np.arange(other.input_buffer_16k_size) / 16000
        x = (0.3 * np.sin(2 * np.pi * 170.0 * t)).astype(np.float32)
        y = engine.infer(x, other.sample_frame_16k_size, 0, other.skip_head, other.return_length)
    finally:
        hook.remove()
    pipe = engine._pipelines[(other.input_buffer_16k_size, other.sample_frame_16k_size, other.skip_head,
                              other.return_length)]
    assert pipe is not launch and pipe.compute_dtype == BF16 and pipe.synthesizer is launch.synthesizer
    assert seen == [BF16]
    assert y.dtype == np.float32 and y.shape == (other.return_length * 400,) and np.isfinite(y).all()
