"""The chain and bank kernels at every width the models send them, on the
CPU; and the mesh's default devices under NCCL.

The kernels are built for C in {8, 16, 32} (the U-Net chain) and {8, 16,
32, 64} (the resblock bank); any narrower C runs on the next built one with
its weights (and, where needed, its input) zero-padded at pack time. Here:
the padded packs unpack to the weights in the real channels and to zeros
elsewhere; the padded function, sliced, is the unpadded one (the padding is
exact); the plain versions at C=8, C=12, C=48, k=5 and d=11 against the JAX
package's Pallas kernels in interpret mode (float32 at 2e-5, bfloat16 by
``tests/test_pallas_ops.py``'s bounds); the tilings at those shapes; and
``parallel/distributed.py:global_mesh``'s default, which under NCCL names
the rank's own card, so each card appears once across ranks. The kernels
themselves run at these shapes in ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from obs_rvc_tpu.ops.resblock import resblock_bank as j_bank_im2col
from obs_rvc_tpu.ops.resblock import resblock_bank_tapdot as j_bank_tapdot
from obs_rvc_tpu.ops.unet_block import conv_block_res_chain as j_chain

from obs_rvc_tpu_torch.ops import resblock as R
from obs_rvc_tpu_torch.ops import unet_block as U
from obs_rvc_tpu_torch.ops._mma import pad_to

from test_torch_port_kernels import _chain_fixture
from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_packing import unpack_taps


def _bank_fixture(rng, B, L, C, ks, S):
    x = (rng.standard_normal((B, L, C)) * 0.3).astype(np.float32)
    params = [tuple((rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
        ((S, k, C, C), 1 / np.sqrt(k * C)), ((S, C), 0.05), ((S, k, C, C), 1 / np.sqrt(k * C)), ((S, C), 0.05)))
        for k in ks]
    return x, params


def _t(blocks, dtype=torch.float32):
    return [tuple(None if a is None else torch.from_numpy(a).to(dtype) for a in b) for b in blocks]


# --- the padded packs ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,width", [(12, 24, 32), (24, 24, 32), (5, 12, 16), (2, 1, 8), (16, 8, 8)])
def test_padded_pack_chain_unpacks_to_the_weights_and_zeros(cin, C, width, dtype):
    _, blocks = _chain_fixture(np.random.default_rng(cin + C), 1, 2, 16, cin, C, 2)
    packed = U.pack_chain(_t(blocks), dtype)
    # a first block that keeps its channels adds its input: that input is padded to the width as well
    cin_kernel = cin if blocks[0][4] is not None else width
    assert (packed.C, packed.cin, packed.width, packed.cin_kernel) == (C, cin, width, cin_kernel)
    for i, ((w1, b1, w2, b2, wsc, bsc), (f1, c1, f2, c2, fsc, csc)) in enumerate(zip(blocks, packed.blocks)):
        ci = cin_kernel if i == 0 else width
        for w, f, taps, rows in ((w1, f1, 9, ci), (w2, f2, 9, width), (wsc, fsc, 1, ci)):
            if w is None:
                assert f is None
                continue
            got = unpack_taps(f, taps, rows)
            real = torch.from_numpy(w).reshape(taps, -1, C).to(dtype).float()
            assert got.shape == (taps, rows, width)
            torch.testing.assert_close(got[:, : real.shape[1], :C], real, rtol=0, atol=0)
            got[:, : real.shape[1], :C] = 0
            assert not got.any()  # every padded row and column is zero
        for b, c in ((b1, c1), (b2, c2), (bsc, csc)):
            if b is None:
                assert c is None
                continue
            assert c.shape == (width,) and c.dtype == torch.float32
            torch.testing.assert_close(c[:C], torch.from_numpy(b).to(dtype).float(), rtol=0, atol=0)
            assert not c[C:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,width", [(12, 16), (48, 64), (1, 8), (8, 8)])
def test_padded_pack_bank_unpacks_to_the_weights_and_zeros(C, width, dtype):
    ks = (3, 5)
    _, params = _bank_fixture(np.random.default_rng(C), 1, 4, C, ks, S=2)
    packed = R.pack_bank(_t(params), ks, (1, 3), dtype)
    assert (packed.C, packed.width) == (C, width)
    steps = iter(packed.steps)
    for (w1, b1, w2, b2), k in zip(params, ks):
        for s in range(2):
            f1, c1, f2, c2 = next(steps)
            for w, f in ((w1[s], f1), (w2[s], f2)):
                got = unpack_taps(f, k, width)
                assert got.shape == (k, width, width)
                torch.testing.assert_close(got[:, :C, :C], torch.from_numpy(w).to(dtype).float(), rtol=0, atol=0)
                got[:, :C, :C] = 0
                assert not got.any()
            for b, c in ((b1[s], c1), (b2[s], c2)):
                assert c.shape == (width,)
                torch.testing.assert_close(c[:C], torch.from_numpy(b).to(dtype).float(), rtol=0, atol=0)
                assert not c[C:].any()


# --- zero padding is exact ---

def _pad_chain_blocks(blocks, width, cin_kernel):
    out = []
    for i, (w1, b1, w2, b2, wsc, bsc) in enumerate(blocks):
        ci = cin_kernel if i == 0 else width
        out.append((pad_to(w1, (3, 3, ci, width)), pad_to(b1, (width,)), pad_to(w2, (3, 3, width, width)),
                    pad_to(b2, (width,)), None if wsc is None else pad_to(wsc, (ci, width)),
                    None if bsc is None else pad_to(bsc, (width,))))
    return out


@pytest.mark.parametrize("cin,C", [(12, 24), (24, 24), (5, 12)])
def test_the_chain_on_zero_padded_channels_is_the_chain(cin, C):
    """What the wrapper runs on the kernel for a C it is not built for:
    the padded chain on the padded input, cut to C, is the chain."""
    x, blocks = _chain_fixture(np.random.default_rng(cin * C), 2, 6, 20, cin, C, 3)
    packed = U.pack_chain(_t(blocks), torch.float32)
    xt = torch.from_numpy(x)
    got = U.conv_block_res_chain_plain(F.pad(xt, (0, packed.cin_kernel - cin)),
                                       _pad_chain_blocks(_t(blocks), packed.width, packed.cin_kernel))
    assert not got[..., C:].any()  # the padded channels stay zero through every block
    torch.testing.assert_close(got[..., :C], U.conv_block_res_chain_plain(xt, _t(blocks)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C", [12, 48, 1])
def test_the_bank_on_zero_padded_channels_is_the_bank(C):
    ks, dils = (3, 7, 11), (1, 3, 5)
    x, params = _bank_fixture(np.random.default_rng(C + 1), 2, 90, C, ks, S=3)
    width = R.kernel_width(C)
    padded = [tuple(pad_to(t, t.shape[:-2] + (width, width)) if t.dim() == 4 else pad_to(t, (t.shape[0], width))
                    for t in p) for p in _t(params)]
    xt = torch.from_numpy(x)
    got = R.resblock_bank_plain(F.pad(xt, (0, width - C)), padded, ks, dils)
    assert not got[..., C:].any()
    torch.testing.assert_close(got[..., :C], R.resblock_bank_plain(xt, _t(params), ks, dils), rtol=1e-6, atol=1e-6)


# --- the plain versions against the JAX Pallas kernels at the new widths ---

@pytest.mark.parametrize("cin0,C,H,W", [(1, 8, 8, 32), (8, 8, 8, 16), (16, 8, 8, 32), (5, 12, 4, 16)])
def test_unet_chain_plain_matches_pallas_at_new_widths(cin0, C, H, W):
    """The reduced-width RMVPE's C=8 levels (encoder 1 -> 8, identity,
    decoder 16 -> 8) and a C=12 level, float32 at the JAX chain gate's
    bounds and bfloat16 at its bf16 ones (``tests/test_pallas_ops.py``)."""
    x, blocks = _chain_fixture(np.random.default_rng(cin0 * 31 + C), 2, H, W, cin0, C, 2)
    for dtype, jdt, atol, rtol in ((torch.float32, jnp.float32, 2e-5, 1e-4),
                                   (torch.bfloat16, jnp.bfloat16, 5e-2, 2e-2)):
        jblocks = [tuple(None if a is None else jnp.asarray(a, jdt) for a in b) for b in blocks]
        want = np.asarray(j_chain(jnp.asarray(x, jdt), jblocks, interpret=True).astype(jnp.float32))
        got = U.conv_block_res_chain(torch.from_numpy(x).to(dtype), _t(blocks, dtype))
        assert got.dtype == dtype and got.shape == want.shape == (2, H, W, C)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("C,ks,dils", [
    (8, (3, 7, 11), (1, 3, 5)),   # the reduced-width generator's C=8 level
    (12, (3, 7, 11), (1, 3, 5)),
    (48, (3, 7, 11), (1, 3, 5)),
    (32, (5,), (1, 2)),           # k=5
    (16, (3, 5), (11,)),          # d=11 (a halo of 22, inside the Pallas kernel's 32)
])
def test_resblock_bank_plain_matches_pallas_at_new_widths(C, ks, dils):
    """The JAX package sends C < 32 to its im2col form and C >= 32 to its
    tapdot form (``obs_rvc_tpu/models/synthesizer.py``); each at its own
    gate's bounds: float32 2e-5, bfloat16 3e-2 with rtol 2e-2 (tapdot) or
    1e-3 (im2col)."""
    x, params = _bank_fixture(np.random.default_rng(C * 3 + len(ks)), 1, 120, C, ks, S=len(dils))
    bank, bf16_rtol = (j_bank_im2col, 1e-3) if C < 32 else (j_bank_tapdot, 2e-2)
    for dtype, jdt, atol, rtol in ((torch.float32, jnp.float32, 2e-5, 1e-3),
                                   (torch.bfloat16, jnp.bfloat16, 3e-2, bf16_rtol)):
        want = np.asarray(bank(jnp.asarray(x, jdt), [tuple(jnp.asarray(a, jdt) for a in p) for p in params],
                               ks, dils, interpret=True).astype(jnp.float32))
        got = R.resblock_bank(torch.from_numpy(x).to(dtype), _t(params, dtype), ks, dils)
        assert got.dtype == dtype and got.shape == want.shape == (1, 120, C)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


# --- the tilings at the new shapes ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W", [(1, 8, 16, 128), (16, 8, 16, 128), (12, 24, 8, 64), (24, 24, 5, 33)])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_chain_tiling_at_new_widths(B, cin, C, H, W, dtype):
    width = U.kernel_width(C, cin)
    tl = U.chain_tiling(B, H, W, cin, C, dtype)
    assert tl == U.chain_tiling(B, H, W, cin, width, dtype)  # C runs on its width's launch
    assert tl.smem_bytes == U.level_smem(cin, width, dtype, tl.th, tl.tw) <= U.SMEM_CAP
    seen = np.zeros((B, H, W), np.int32)
    for _, b, rows, cols in U.chain_tiles(tl, B, H, W):
        seen[b, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,ks,dils", [(8, (3, 7, 11), (1, 3, 5)), (48, (3, 7, 11), (1, 3, 5)), (32, (5,), (1, 2)),
                                       (32, (11,), (11,)), (64, (3, 7, 11), (1, 11))])
@pytest.mark.parametrize("B,L", [(1, 28000), (8, 7000), (64, 700)])
def test_bank_tiling_at_new_widths(B, L, C, ks, dils, dtype):
    width = R.kernel_width(C)
    tl = R.bank_tiling(B, L, C, dtype, kernel_sizes=ks, dilations=dils)
    assert tl.tile == tl.rows - (max(ks) - 1)  # a tile's positions: its conv rows less conv2's halo
    assert tl.smem_bytes == R.level_smem(width, dtype, tl.rows, max(ks), max(dils), tl.ring) <= R.SMEM_CAP
    assert R.halo_fits(C, dtype, max(ks), max(dils))
    for last in (False, True):
        seen = np.zeros((len(ks), B, L), np.int32)
        for _, b, r, pos in R.bank_tiles(tl, B, L, len(ks), last):
            for j in (range(len(ks)) if r is None else [r]):
                seen[j, b, pos.start:pos.stop] += 1
        assert (seen == 1).all()


def test_bank_shared_memory_at_c8_stages_a_k_step():
    """C=8 in bfloat16 stages 16 channels a row (one k16 step, the 8 past C
    zero), its ring a slab of 16 x 8 weights a tap; float32's k8 step is 8
    channels, C itself."""
    assert R.level_smem(8, torch.bfloat16, 128, 11, 5, 8) == 8 * 16 * 8 * 2 + 178 * (16 * 2 + 16)
    assert R.level_smem(8, torch.float32, 128, 11, 5, 8) == 8 * 8 * 8 * 4 + 178 * (8 * 4 + 16)
    # the halo a launch at C=64 in float32 holds at every tile the wrapper picks: d up to 24 at k=11
    assert R.halo_fits(64, torch.float32, 11, 24) and not R.halo_fits(64, torch.float32, 11, 25)
    assert R.halo_fits(64, torch.bfloat16, 11, 100)


# --- global_mesh's default under NCCL ---

def test_global_mesh_names_each_rank_card_once(monkeypatch):
    """Two ranks under torchrun on a host of two cards (``LOCAL_RANK`` 0
    and 1): ``initialize`` makes each rank's card current, and
    ``global_mesh()`` without ``local_devices`` names that card alone, so
    the gathered mesh holds each card once, rank by rank, as each JAX
    device belongs to one process. Without a group it keeps every visible
    card."""
    from obs_rvc_tpu_torch.parallel import distributed
    from obs_rvc_tpu_torch.parallel import mesh as mesh_mod

    cards = [torch.device("cuda", i) for i in range(2)]
    monkeypatch.setattr(distributed, "visible_devices", lambda: list(cards))
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda device=None: list(cards))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    current = {}
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: current.update(card=i))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["card"])
    group = {}
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, init_method, world_size, rank: group.update(backend=backend, rank=rank))
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: bool(group))
    monkeypatch.setattr(distributed.dist, "get_backend", lambda: group["backend"])
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda: group["rank"])

    sent = {}
    for rank in (0, 1):
        group.clear()
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        distributed.initialize("localhost:0", 2, rank)
        assert group == {"backend": "nccl", "rank": rank} and current["card"] == rank
        monkeypatch.setattr(distributed.dist, "all_gather_object",
                            lambda out, obj: out.__setitem__(slice(None), [obj, obj]))
        distributed.global_mesh()
        sent[rank] = distributed.rank_devices()
    assert sent == {0: [cards[0]], 1: [cards[1]]}

    # the gather as both ranks see it: each card once, rank 0's first
    def gather(out, obj):
        out[:] = [[str(d) for d in sent[r]] for r in (0, 1)]

    monkeypatch.setattr(distributed.dist, "all_gather_object", gather)
    mesh = distributed.global_mesh()
    assert mesh.shape == {"data": 2, "model": 1}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert mesh.processes.tolist() == [[0], [1]]
    # no group (one process): every visible card, as before
    group.clear()
    assert distributed.rank_devices() == cards and distributed.global_mesh().shape == {"data": 2, "model": 1}
