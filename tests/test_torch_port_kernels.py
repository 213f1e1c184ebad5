"""The plain versions of the port's two kernels against the JAX package's
Pallas kernels, run in interpret mode as the JAX package's own tests run
them on the CPU; and the wrappers' dispatch rules.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.ops.resblock import resblock_bank as j_resblock_bank_im2col
from obs_rvc_tpu.ops.resblock import resblock_bank_tapdot as j_resblock_bank
from obs_rvc_tpu.ops.unet_block import conv_block_res_chain as j_chain
from obs_rvc_tpu.ops.unet_block import fold_bn as j_fold_bn

from obs_rvc_tpu_torch.ops import resblock as t_resblock
from obs_rvc_tpu_torch.ops import unet_block as t_unet

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)


def _bank_fixture(C, L, B=1, seed=0):
    rng = np.random.default_rng(seed)
    ks, dil = (3, 7, 11), (1, 3, 5)
    x = (rng.standard_normal((B, L, C)) * 0.3).astype(np.float32)
    params = []
    for k in ks:
        scale = 1.0 / np.sqrt(k * C)
        params.append(tuple(
            a.astype(np.float32) for a in (
                rng.standard_normal((3, k, C, C)) * scale,
                rng.standard_normal((3, C)) * 0.05,
                rng.standard_normal((3, k, C, C)) * scale,
                rng.standard_normal((3, C)) * 0.05,
            )))
    return x, params, ks, dil


def _torch_params(params):
    return [tuple(torch.from_numpy(a) for a in p) for p in params]


@pytest.mark.parametrize("C,L", [(32, 250), (64, 250)])
def test_resblock_bank_plain_matches_pallas_tapdot(C, L):
    x, params, ks, dil = _bank_fixture(C, L)
    want = np.asarray(j_resblock_bank(jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in params],
                                      ks, dil, interpret=True))
    got = t_resblock.resblock_bank(torch.from_numpy(x), _torch_params(params), ks, dil).numpy()
    assert got.shape == want.shape == (1, L, C)
    # the f32 bounds of the JAX package's own tapdot gate (tests/test_pallas_ops.py)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-3)


def test_resblock_bank_plain_matches_pallas_im2col_at_c16():
    """C<32 is the im2col kernel's range in the JAX package; the port's bank
    (kernel and plain version) takes C=16 too."""
    x, params, ks, dil = _bank_fixture(16, 200, seed=1)
    want = np.asarray(j_resblock_bank_im2col(jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in params],
                                             ks, dil, interpret=True))
    got = t_resblock.resblock_bank(torch.from_numpy(x), _torch_params(params), ks, dil).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-3)


def _bf16_params(params):
    return ([tuple(jnp.asarray(a, jnp.bfloat16) for a in p) for p in params],
            [tuple(torch.from_numpy(a).to(torch.bfloat16) for a in p) for p in params])


@pytest.mark.parametrize("C,L,atol,rtol", [
    (32, 250, 3e-2, 2e-2),  # tapdot: the JAX package's own tapdot bf16 bounds
    (64, 250, 3e-2, 2e-2),
    (16, 200, 3e-2, 1e-3),  # im2col: its im2col bf16 bounds
])
def test_resblock_bank_plain_matches_pallas_in_bf16(C, L, atol, rtol):
    """In bfloat16 the plain version rounds where the Pallas kernels round
    (float32 sums, rounded to bf16, then the bias added in bf16)."""
    x, params, ks, dil = _bank_fixture(C, L, seed=C)
    jparams, tparams = _bf16_params(params)
    bank = j_resblock_bank if C >= 32 else j_resblock_bank_im2col
    want = np.asarray(bank(jnp.asarray(x, jnp.bfloat16), jparams, ks, dil, interpret=True).astype(jnp.float32))
    got = t_resblock.resblock_bank(torch.from_numpy(x).to(torch.bfloat16), tparams, ks, dil)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


def _chain_fixture(rng, B, H, W, cin0, C, n_blocks):
    def conv(ci, co, k=3):
        return (rng.standard_normal((k, k, ci, co)) * 0.15).astype(np.float32)

    blocks = []
    for i in range(n_blocks):
        ci = cin0 if i == 0 else C
        wsc = bsc = None
        if i == 0 and ci != C:
            wsc = conv(ci, C, k=1).reshape(ci, C)
            bsc = (rng.standard_normal(C) * 0.05).astype(np.float32)
        blocks.append((conv(ci, C), (rng.standard_normal(C) * 0.05).astype(np.float32),
                       conv(C, C), (rng.standard_normal(C) * 0.05).astype(np.float32), wsc, bsc))
    x = (rng.standard_normal((B, H, W, cin0)) * 0.3).astype(np.float32)
    return x, blocks


@pytest.mark.parametrize("cin0,C,H,W", [
    (1, 16, 8, 32),    # encoder level 0 geometry (1 -> 16)
    (16, 16, 8, 32),   # identity shortcut
    (32, 16, 4, 16),   # decoder geometry (2C concat -> C)
    (16, 32, 4, 16),   # channel doubling
])
def test_unet_chain_plain_matches_pallas(cin0, C, H, W):
    rng = np.random.default_rng(cin0 * 100 + C)
    x, blocks = _chain_fixture(rng, B=2, H=H, W=W, cin0=cin0, C=C, n_blocks=3)
    jblocks = [tuple(None if a is None else jnp.asarray(a) for a in b) for b in blocks]
    tblocks = [tuple(None if a is None else torch.from_numpy(a) for a in b) for b in blocks]
    want = np.asarray(j_chain(jnp.asarray(x), jblocks, interpret=True))
    got = t_unet.conv_block_res_chain(torch.from_numpy(x), tblocks).numpy()
    assert got.shape == want.shape
    # the f32 bounds of the JAX package's own chain gate (tests/test_pallas_ops.py)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("cin0,C,H,W", [
    (8, 16, 8, 16),    # the JAX package's own bf16 chain case
    (1, 16, 8, 32),    # encoder level 0 geometry
    (16, 32, 4, 16),   # channel doubling
])
def test_unet_chain_plain_matches_pallas_in_bf16(cin0, C, H, W):
    rng = np.random.default_rng(cin0 * 10 + C)
    x, blocks = _chain_fixture(rng, B=1, H=H, W=W, cin0=cin0, C=C, n_blocks=2)
    jblocks = [tuple(None if a is None else jnp.asarray(a, jnp.bfloat16) for a in b) for b in blocks]
    tblocks = [tuple(None if a is None else torch.from_numpy(a).to(torch.bfloat16) for a in b) for b in blocks]
    want = np.asarray(j_chain(jnp.asarray(x, jnp.bfloat16), jblocks, interpret=True).astype(jnp.float32))
    got = t_unet.conv_block_res_chain(torch.from_numpy(x).to(torch.bfloat16), tblocks)
    assert got.dtype == torch.bfloat16
    # the bf16 bounds of the JAX package's own chain gate (tests/test_pallas_ops.py)
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=2e-2)


def test_fold_bn_matches():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(8).astype(np.float32) * 0.1 + o for o in (1.0, 0.0, 0.0))
    var = (1.0 + 0.1 * rng.standard_normal(8) ** 2).astype(np.float32)
    jw, jb = j_fold_bn(*(jnp.asarray(a) for a in (w, scale, bias, mean, var)))
    tw, tb = t_unet.fold_bn(*(torch.from_numpy(a) for a in (w, scale, bias, mean, var)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x, params, ks, dil = _bank_fixture(32, 64)
    before = t_resblock.LAUNCHES
    out = t_resblock.resblock_bank(torch.from_numpy(x), _torch_params(params), ks, dil)
    assert t_resblock.LAUNCHES == before  # the plain version is no launch
    np.testing.assert_array_equal(
        out.numpy(), t_resblock.resblock_bank_plain(torch.from_numpy(x), _torch_params(params), ks, dil).numpy())
    meta = torch.empty((1, 64, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        t_resblock.resblock_bank(meta, _torch_params(params), ks, dil)
    with pytest.raises(ValueError, match="device"):
        t_unet.conv_block_res_chain(torch.empty((1, 4, 8, 16), device="meta"), [])


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """The checks a CUDA launch runs first, exercised without a card."""
    x = torch.zeros((1, 64, 128))
    with pytest.raises(NotImplementedError, match="C up to 64"):
        t_resblock._resblock_bank_cuda(x, [], (3, 7, 11), (1, 3, 5))
    with pytest.raises(ValueError, match="contiguous"):
        t_resblock._resblock_bank_cuda(torch.zeros((1, 32, 64)).transpose(1, 2), [], (3,), (1,))
    with pytest.raises(ValueError, match="dtype"):
        t_resblock._resblock_bank_cuda(torch.zeros((1, 64, 32), dtype=torch.float16), [], (3,), (1,))
    # C=64 and Cin=72, past the resident kernel, now pack for the ring kernel; its limits are C 256, Cin 512
    w = torch.zeros((3, 3, 64, 64))
    packed = t_unet.pack_chain([(w, torch.zeros(64), w, torch.zeros(64), None, None)], torch.float32)
    assert packed.ring and (packed.width, packed.cin_kernel) == (64, 64) and t_unet.kernel_width(64, 64) == 64
    w = torch.zeros((3, 3, 288, 288))
    with pytest.raises(NotImplementedError, match="C up to 256"):
        t_unet.pack_chain([(w, torch.zeros(288), w, torch.zeros(288), None, None)], torch.float32)
    with pytest.raises(NotImplementedError, match="C up to 256"):
        t_unet._chain_cuda(torch.zeros((1, 4, 8, 288)), t_unet.PackedChain(
            torch.float32, torch.device("cpu"), 288, 288, 288, 288, [], None, True))
    w1 = torch.zeros((3, 3, 72, 16))
    packed = t_unet.pack_chain([(w1, torch.zeros(16), torch.zeros((3, 3, 16, 16)), torch.zeros(16),
                                 torch.zeros((72, 16)), torch.zeros(16))], torch.float32)
    assert packed.ring and (packed.width, packed.cin_kernel) == (32, 80) and t_unet.kernel_width(16, 72) == 32
    w1 = torch.zeros((3, 3, 520, 16))
    with pytest.raises(NotImplementedError, match="Cin 1..512"):
        t_unet.pack_chain([(w1, torch.zeros(16), torch.zeros((3, 3, 16, 16)), torch.zeros(16),
                            torch.zeros((520, 16)), torch.zeros(16))], torch.float32)
