"""The U-Net chain at every level RMVPE can route to it, on the CPU: the
levels past the resident kernel's C=32 and Cin=64, which run on the chain's
ring kernel (``csrc/unet_block.cu``) when ``pallas_unet_max_ch`` is 64 or
more, as the JAX package sends them to its Pallas chain.

Here: the plain version at the six wide levels of the full RMVPE (C = 64,
128 and 256, each with its decoder's 2C concat) and at padded widths,
against the JAX package's Pallas chain in interpret mode (float32 at 2e-5,
bfloat16 at ``tests/test_pallas_ops.py``'s bounds); ``pack_chain`` at these
widths, unpacked, is the folded weights in the real channels and zeros
elsewhere; ``chain_tiling`` at 1, 8 and 64 streams fits shared memory and
covers every output pixel and channel once; the wrapper hands the ring
tiling to the C call; and a four-level RMVPE with ``pallas_unet_max_ch=64``
against the JAX RMVPE with ``pallas_unet=True`` at the same ``max_ch``. The
kernel itself runs at these shapes in ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obs_rvc_tpu.models import RMVPE as JRMVPE
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.ops.unet_block import conv_block_res_chain as j_chain

from obs_rvc_tpu_torch.models import rmvpe as rmvpe_mod
from obs_rvc_tpu_torch.models import weights as Wt
from obs_rvc_tpu_torch.models.rmvpe import RMVPE, RMVPEConfig
from obs_rvc_tpu_torch.ops import unet_block as U
from obs_rvc_tpu_torch.ops._mma import RING_GROUP, pack_ring, slab_channels

from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)
from test_torch_port_packing import unpack_taps

#: (cin, C, H, W): the full RMVPE's levels past the resident kernel (enc2, dec2, enc3, dec1, enc4, dec0 on a
#: 64-frame x 128-mel input), then padded widths (C=48 on 64, an identity first block on 96, C <= 32 with a
#: Cin past 64, a Cin under one slab)
WIDE_LEVELS = [(32, 64, 16, 32), (128, 64, 16, 32), (64, 128, 8, 16), (256, 128, 8, 16), (128, 256, 4, 8),
               (512, 256, 4, 8)]
PADDED = [(24, 48, 16, 32), (96, 96, 8, 16), (100, 16, 4, 16), (3, 40, 4, 8)]


def _blocks(rng, cin, C, n_blocks):
    """Folded blocks with fan-in-scaled weights, so the activations keep
    their scale through the wide levels."""
    out, ci = [], cin
    for _ in range(n_blocks):
        wsc = bsc = None
        if ci != C:
            wsc = (rng.standard_normal((ci, C)) / np.sqrt(ci)).astype(np.float32)
            bsc = (rng.standard_normal(C) * 0.05).astype(np.float32)
        out.append(((rng.standard_normal((3, 3, ci, C)) / np.sqrt(9 * ci)).astype(np.float32),
                    (rng.standard_normal(C) * 0.05).astype(np.float32),
                    (rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32),
                    (rng.standard_normal(C) * 0.05).astype(np.float32), wsc, bsc))
        ci = C
    return out


def _t(blocks, dtype=torch.float32):
    return [tuple(None if a is None else torch.from_numpy(a).to(dtype) for a in b) for b in blocks]


def unpack_ring(frag: torch.Tensor, taps: int, cin: int, C: int, dtype: torch.dtype) -> torch.Tensor:
    """The float32 weight ``[taps, cin, C]`` that ``ops/_mma.py:pack_ring``
    packed (``cin`` a multiple of a slab, ``C`` of 32)."""
    sl = slab_channels(dtype)
    S, G = cin // sl, C // RING_GROUP
    w = unpack_taps(frag, G * S * taps, sl)  # [G * S * taps, sl, 32]
    return w.reshape(G, S, taps, sl, RING_GROUP).permute(2, 1, 3, 0, 4).reshape(taps, cin, C)


# --- the plain version against the JAX Pallas chain ---

@pytest.mark.parametrize("cin,C,H,W", WIDE_LEVELS + PADDED[:1])
def test_unet_chain_plain_matches_pallas_at_wide_levels(cin, C, H, W):
    """Two blocks a level, one stream; float32 at 2e-5 and bfloat16 at the
    JAX chain gate's 5e-2 / 2e-2 (``tests/test_pallas_ops.py``)."""
    rng = np.random.default_rng(cin * 7 + C)
    blocks = _blocks(rng, cin, C, 2)
    x = (rng.standard_normal((1, H, W, cin)) * 0.5).astype(np.float32)
    for dtype, jdt, atol, rtol in ((torch.float32, jnp.float32, 2e-5, 1e-4),
                                   (torch.bfloat16, jnp.bfloat16, 5e-2, 2e-2)):
        jblocks = [tuple(None if a is None else jnp.asarray(a, jdt) for a in b) for b in blocks]
        want = np.asarray(j_chain(jnp.asarray(x, jdt), jblocks, interpret=True).astype(jnp.float32))
        got = U.conv_block_res_chain(torch.from_numpy(x).to(dtype), _t(blocks, dtype))
        assert got.dtype == dtype and got.shape == want.shape == (1, H, W, C)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


# --- the packs ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C", [(c, k) for c, k, _, _ in WIDE_LEVELS + PADDED])
def test_pack_chain_at_wide_widths_unpacks_to_the_weights_and_zeros(cin, C, dtype):
    blocks = _blocks(np.random.default_rng(cin + C), cin, C, 2)
    packed = U.pack_chain(_t(blocks), dtype)
    width, sl = -(-C // RING_GROUP) * RING_GROUP, slab_channels(dtype)
    # the first block's input: a slab's multiple where it has a shortcut, else the width it adds itself to
    cin_kernel = -(-cin // sl) * sl if cin != C else width
    assert packed.ring and U.is_ring(C, cin)
    assert (packed.C, packed.cin, packed.width, packed.cin_kernel) == (C, cin, width, cin_kernel)
    assert U.kernel_width(C, cin) == width and U.kernel_cin(cin, C, dtype) == cin_kernel
    for i, ((w1, b1, w2, b2, wsc, bsc), (f1, c1, f2, c2, fsc, csc)) in enumerate(zip(blocks, packed.blocks)):
        ci = cin_kernel if i == 0 else width
        for w, f, taps, rows in ((w1, f1, 9, ci), (w2, f2, 9, width), (wsc, fsc, 1, ci)):
            if w is None:
                assert f is None
                continue
            got = unpack_ring(f, taps, rows, width, dtype)
            real = torch.from_numpy(w).reshape(taps, -1, C).to(dtype).float()
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


def test_each_ring_stage_is_one_contiguous_block_of_a_group_and_slab():
    """``pack_ring``'s order: the 9 taps of group g (32 output channels)
    and slab s (32 bf16 input channels) are the ``(g * S + s)``-th block of
    ``9 x 2 K steps x 4 n8 tiles`` fragments, which the kernel copies into
    one slot of its ring."""
    w = torch.zeros((9, 64, 96))
    w[:, 32:64, 64:96] = torch.arange(1, 9 * 32 * 32 + 1, dtype=torch.float32).reshape(9, 32, 32)  # s = 1, g = 2
    frag = pack_ring(w, torch.bfloat16)  # [G * S * 9 * 2, 4, 32, 4]
    per = 9 * 2  # K steps of a block
    nonzero = [i for i in range(frag.shape[0] // per) if frag[i * per : (i + 1) * per].float().abs().sum() > 0]
    assert nonzero == [2 * 2 + 1]  # group 2, slab 1 of 2
    torch.testing.assert_close(unpack_ring(frag, 9, 64, 96, torch.bfloat16), w.to(torch.bfloat16).float())


# --- the tilings ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W", WIDE_LEVELS + PADDED)
@pytest.mark.parametrize("B", [1, 8, 64])
def test_ring_tiling_fits_and_covers_every_output_once(B, cin, C, H, W, dtype):
    width, sl = U.kernel_width(C, cin), slab_channels(dtype)
    tl = U.chain_tiling(B, H, W, cin, C, dtype)
    cink = U.kernel_cin(cin, C, dtype)
    assert tl.ring and tl == U.chain_tiling(B, H, W, cink, width, dtype)  # the wrapper's call, on the kernel's sizes
    nw, px = tl.bn // RING_GROUP, tl.th * tl.tw
    # float32 takes one m16 tile a warp (a second set of sums a stage); bfloat16 the table's
    assert (px, nw, 1 if dtype == torch.float32 else tl.wm) in [(p, n, 1 if dtype == torch.float32 else m)
                                                               for p, n, m in U.RING_TILES]
    assert tl.tw == (16 if px >= 128 and W >= 16 else 8) and (tl.wm == 1 or dtype == torch.bfloat16)
    assert tl.kw == (3 if px // (16 * tl.wm) * nw <= U.RING_KW_WARPS else 1)  # warps along K in small blocks
    assert tl.warps == px // (16 * tl.wm) * nw * tl.kw <= U.RING_MAX_WARPS and width % tl.bn == 0
    assert tl.smem_bytes == U.ring_smem(tl.th, tl.tw, nw) <= U.SMEM_CAP
    seen = np.zeros((B, H, W, width), np.int32)
    tiles = list(U.chain_tiles(tl, B, H, W, width))
    assert [t[0] for t in tiles] == list(range(tl.tiles))
    for _, b, rows, cols, chans in tiles:
        assert len(rows) and len(cols) and len(chans) == tl.bn
        seen[b, rows.start:rows.stop, cols.start:cols.stop, chans.start:chans.stop] += 1
    assert (seen == 1).all()
    # K splits only where the tiles leave SMs idle or the convs over C have many stages: up to 4 ways, half a
    # conv's stages, the SMs over the tiles; and the partial sums fit their scratch
    stages = (cink // sl, width // sl)
    cap = max(1, min(U.RING_MAX_SPLIT, U.N_SMS // tl.tiles))
    if tl.splits == (1, 1):
        assert tl.partial == 0
        assert (tl.tiles >= U.RING_FILL * U.N_SMS and stages[1] <= U.RING_SPLIT_STAGES) or \
            all(min(cap, n // 2) <= 1 for n in stages)  # filled without a split, or nothing to split
    else:
        assert tl.tiles < U.RING_FILL * U.N_SMS or stages[1] > U.RING_SPLIT_STAGES
        assert tl.splits == tuple(max(1, min(cap, n // 2)) for n in stages)
        assert tl.partial == tl.tiles * px * tl.bn * max(2 * tl.splits[0], tl.splits[1])
    if tl.th > H:  # a tile taller than the map only where no option is shorter
        assert px == U.RING_TILES[-1][0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_tiling_takes_a_tile_and_refuses_what_no_kernel_is_built_for(dtype):
    tl = U.chain_tiling(8, 16, 32, 128, 64, dtype, tile=(4, 8, 1, 2, 3))
    assert (tl.th, tl.tw, tl.wm, tl.bn, tl.kw, tl.warps) == (4, 8, 1, 64, 3, 12) and tl.tiles == 8 * 4 * 4
    assert tl.splits == (1, 1)  # 128 tiles: nothing to split for
    tl = U.chain_tiling(1, 16, 32, 128, 64, dtype, tile=(2, 16, 1, 1, 1, 2, 1))
    assert tl.splits == (2, 1) and tl.partial == tl.tiles * 32 * 32 * 4
    for bad in [(4, 8, 4, 1, 1), (4, 8, 1, 4, 1), (3, 5, 1, 1, 1), (8, 16, 1, 2, 3), (4, 8, 1, 1, 10),
                (8, 8, 1, 2, 1, 1), (4, 8, 1, 2), (2, 16, 1, 1, 1, 9, 1)]:
        # no such wm or nw, no m16 tiles, 48 warps, kw past 9, not (th, tw, wm, nw, kw[, splits]), 9 splits of 8
        with pytest.raises(ValueError):
            U.chain_tiling(8, 16, 32, 128, 64, dtype, tile=bad)
    with pytest.raises(ValueError, match="no ring kernel"):  # 96 channels take no 64-channel tile
        U.chain_tiling(1, 8, 16, 96, 96, dtype, tile=(4, 16, 2, 2, 1))
    with pytest.raises(NotImplementedError, match="C up to 256"):
        U.chain_tiling(1, 4, 8, 512, 288, dtype)
    with pytest.raises(NotImplementedError, match="Cin 1..512"):
        U.chain_tiling(1, 4, 8, 520, 256, dtype)


def test_ring_shared_memory_counts_three_slots_of_weights_and_a_halo():
    # 64 streams' enc2: two groups' 10 taps of 2 K steps x 4 n8 tiles x 256 B, a 10 x 18 tile of 80-byte pixels
    assert U.ring_smem(8, 16, 2) == 3 * (2 * 10 * 2048 + 10 * 18 * 80) + 16 == 166096
    # one stream's enc4: one group, a 6 x 10 tile
    assert U.ring_smem(4, 8, 1) == 3 * (10 * 2048 + 6 * 10 * 80) + 16


@pytest.mark.parametrize("B,cin,C,H,W", [(1, 512, 256, 4, 8), (64, 32, 64, 16, 32), (2, 24, 48, 5, 12)])
def test_wrapper_hands_the_ring_tiling_to_the_c_call_and_counts_it(monkeypatch, B, cin, C, H, W):
    calls = []

    def function(name, symbol, argtypes):
        assert (name, symbol, len(argtypes)) == ("unet_block", "rvc_conv_block_res_chain_ring", 21)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(U._cuda, "function", function)
    monkeypatch.setattr(U._cuda, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(U, "_sms", lambda device: U.N_SMS)
    dtype = torch.bfloat16
    packed = U.pack_chain(_t(_blocks(np.random.default_rng(0), cin, C, 2)), dtype)
    x = torch.zeros((B, H, W, cin), dtype=dtype)
    before = U.LAUNCHES
    out = U._chain_cuda(x, packed)
    assert U.LAUNCHES == before + 1 and out.shape == (B, H, W, C) and out.dtype == dtype
    tl = U.chain_tiling(B, H, W, cin, C, dtype)
    (args,) = calls
    partial, counters = args[3], args[4]
    assert (partial.value is None) == (counters.value is None) == (tl.partial == 0)
    assert list(args[6:20]) == [2, B, H, W, packed.cin_kernel, packed.width, 1, tl.th, tl.tw, tl.wm,
                                tl.bn // RING_GROUP, tl.kw, *tl.splits]


# --- the network ---

def _rmvpe_pair(max_ch):
    cfg = dict(en_de_layers=4, inter_layers=1, n_blocks=2, en_out_channels=8, gru_hidden=32)
    jm = JRMVPE(JRMVPEConfig(**cfg, pallas_unet=True, pallas_unet_max_ch=max_ch))
    mel = np.random.default_rng(4).standard_normal((1, 128, 32)).astype(np.float32)
    variables = randomize(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(mel)))
    tm = Wt.load_state_dict(RMVPE(RMVPEConfig(**cfg, pallas_unet_max_ch=max_ch)), Wt.rmvpe_state_dict(
        variables, cfg["n_blocks"], cfg["en_de_layers"], cfg["inter_layers"]))
    return jm, variables, tm, mel


@pytest.mark.parametrize("max_ch", [64, 1024])
def test_rmvpe_with_every_level_on_the_chain_matches_the_pallas_rmvpe(monkeypatch, max_ch):
    """A four-level RMVPE (levels of 8, 16, 32 and 64 channels, its
    decoder's C=64 level reading 128; an intermediate level of 128) with
    ``pallas_unet_max_ch`` 64 or 1024 against the JAX RMVPE with
    ``pallas_unet=True`` at the same ``max_ch`` (its Pallas chain in
    interpret mode), on the same weights, within 2e-4: all 8 encoder and
    decoder levels through the chain, the intermediate one through its
    modules' own convolutions at every ``max_ch``, as in the JAX package."""
    jm, variables, tm, mel = _rmvpe_pair(max_ch)
    unet = tm.unet
    assert all(layer.conv.fused for layer in unet.encoder.layers)
    assert all(layer.conv2.fused for layer in unet.decoder.layers)
    assert not any(layer.conv.fused for layer in unet.intermediate.layers)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(mel)))
    calls = []
    real = U.conv_block_res_chain

    def counted(x, blocks, tile=None):
        calls.append((x.shape[-1], blocks[0][0].shape[-1]))
        return real(x, blocks, tile)

    monkeypatch.setattr(rmvpe_mod, "conv_block_res_chain", counted)
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
    assert calls == [(1, 8), (8, 16), (16, 32), (32, 64), (128, 64), (64, 32), (32, 16), (16, 8)]
    assert got.shape == want.shape == (1, 32, 360)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
