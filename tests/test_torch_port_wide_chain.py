"""The U-Net chain at every level RMVPE can route to it, on the CPU: the
levels past the resident kernel's C=32 and Cin=64, which run on the chain's
ring kernel (``csrc/unet_block.cu``) when ``pallas_unet_max_ch`` is 64 or
more, as the JAX package sends them to its Pallas chain.

Here: the plain version at the six wide levels of the full RMVPE (C = 64,
128 and 256, each with its decoder's 2C concat) and at padded widths,
against the JAX package's Pallas chain in interpret mode (float32 at 2e-5,
bfloat16 at ``tests/test_pallas_ops.py``'s bounds); ``pack_chain`` at these
widths, unpacked, is the folded weights in the real channels and zeros
elsewhere (bfloat16 in ``wgmma``'s core matrices, float32 in ``mma.sync``'s
fragments); ``chain_tiling`` at 1, 3, 5, 8, 63 and 64 streams fits shared
memory and its tiles of S streams cover every output pixel and channel
once; a model of the kernel's staging addresses shows that each pixel reads
its own stream's neighbours and zeros at that stream's edges; the wrapper
hands the ring tiling to the C call; and a four-level RMVPE with ``pallas_unet_max_ch=64``
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
from obs_rvc_tpu_torch.ops._mma import RING_GROUP, pack_ring, pack_ring_wgmma, slab_channels

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


def unpack_ring_wgmma(packed: torch.Tensor, taps: int, cin: int, C: int) -> torch.Tensor:
    """The float32 weight ``[taps, cin, C]`` that ``ops/_mma.py:
    pack_ring_wgmma`` packed: blocks of ``[taps, 2 K steps, 4 n8, 2 K
    halves, 8 n, 8 k]`` bfloat16."""
    S, G = cin // 32, C // RING_GROUP
    # [.., kk, j, h, r, e] -> [.., k = 16 kk + 8 h + e, n = 8 j + r]
    w = packed.float().reshape(G * S * taps, 2, 4, 2, 8, 8).permute(0, 1, 3, 5, 2, 4).reshape(-1, 32, RING_GROUP)
    return w.reshape(G, S, taps, 32, RING_GROUP).permute(2, 1, 3, 0, 4).reshape(taps, cin, C)


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
    # bfloat16 packs for mma.sync, and for the batch kernel's wgmma at its first launch there; float32 once
    forms = [(packed.blocks, lambda f, taps, rows: unpack_ring(f, taps, rows, width, dtype))]
    if dtype == torch.bfloat16:
        assert packed.wgmma == [] and packed.folded is not None
        wg_blocks, wg_params = U.wgmma_pack(packed)
        assert U.wgmma_pack(packed)[0] is wg_blocks  # made once
        forms.append((wg_blocks, lambda f, taps, rows: unpack_ring_wgmma(f, taps, rows, width)))
        assert len(wg_params) == len(packed.params) == 6 * len(blocks)
        assert list(wg_params) == [None if t is None else t.data_ptr() for b in wg_blocks for t in b]
    else:
        assert packed.wgmma is None and packed.folded is None
        with pytest.raises(ValueError, match="only a bfloat16 ring level"):
            U.wgmma_pack(packed)
    for (w1, b1, w2, b2, wsc, bsc), (f1, c1, f2, c2, fsc, csc), unpack, i in [
            (blk, pk, unpack, i) for pks, unpack in forms for i, (blk, pk) in enumerate(zip(blocks, pks))]:
        ci = cin_kernel if i == 0 else width
        for w, f, taps, rows in ((w1, f1, 9, ci), (w2, f2, 9, width), (wsc, fsc, 1, ci)):
            if w is None:
                assert f is None
                continue
            got = unpack(f, taps, rows)
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


def _one_block_of_group_2_slab_1():
    w = torch.zeros((9, 64, 96))
    w[:, 32:64, 64:96] = torch.arange(1, 9 * 32 * 32 + 1, dtype=torch.float32).reshape(9, 32, 32)  # s = 1, g = 2
    return w


def _nonzero_blocks(packed):
    blocks = packed.reshape(-1).view(torch.int16).reshape(-1, 9 * 1024)  # 9 taps x 2048 bytes a block
    return [i for i in range(blocks.shape[0]) if blocks[i].any()]


def test_each_ring_stage_is_one_contiguous_block_of_a_group_and_slab():
    """``pack_ring``'s order: the 9 taps of group g (32 output channels)
    and slab s (32 bf16 input channels) are the ``(g * S + s)``-th block of
    ``9 x 2048`` bytes, which the kernels bring into one slot of their
    ring."""
    w = _one_block_of_group_2_slab_1()
    frag = pack_ring(w, torch.bfloat16)
    assert _nonzero_blocks(frag) == [2 * 2 + 1]  # group 2, slab 1 of 2
    torch.testing.assert_close(unpack_ring(frag, 9, 64, 96, torch.bfloat16), w.to(torch.bfloat16).float())


def test_each_wgmma_ring_stage_is_the_same_block():
    """``pack_ring_wgmma`` keeps ``pack_ring``'s blocks: the batch kernel
    copies a group's stage in one bulk copy."""
    w = _one_block_of_group_2_slab_1()
    packed = pack_ring_wgmma(w)
    assert _nonzero_blocks(packed) == [2 * 2 + 1]
    torch.testing.assert_close(unpack_ring_wgmma(packed, 9, 64, 96), w.to(torch.bfloat16).float())


def test_bf16_ring_pack_is_wgmmas_k_major_core_matrices():
    """Each K step of a bf16 tap is 4 n8 tiles x 2 K halves of 8 x 8 core
    matrices, 128 contiguous bytes each (8 output channels' rows of 8 input
    channels, 16 bytes a row), 128 bytes apart along K and 256 along N: the
    layout the batch kernel's ``wgmma`` descriptors name."""
    taps, cin, C = 9, 64, 64
    w = torch.arange(taps * cin * C, dtype=torch.float32).reshape(taps, cin, C) % 251 - 125
    packed = pack_ring_wgmma(w)
    assert packed.dtype == torch.bfloat16 and packed.numel() * 2 == (C // 32) * (cin // 32) * taps * 2048
    flat = packed.reshape(-1).float()
    for g, s, tap, kk, j, h, r, e in [(0, 0, 0, 0, 0, 0, 0, 0), (1, 1, 8, 1, 3, 1, 7, 7), (0, 1, 4, 0, 2, 1, 5, 3),
                                      (1, 0, 2, 1, 1, 0, 6, 1)]:
        byte = (((g * (cin // 32) + s) * taps + tap) * 2048 + kk * 1024 + j * 256 + h * 128 + r * 16 + e * 2)
        assert flat[byte // 2] == w[tap, s * 32 + 16 * kk + 8 * h + e, g * 32 + 8 * j + r]


# --- the tilings ---

def _covers(tl, B, H, W, width):
    """Every output pixel and channel of the level in exactly one tile; each
    tile's streams its own, S at most, cut at B."""
    seen = np.zeros((B, H, W, width), np.int32)
    tiles = list(U.chain_tiles(tl, B, H, W, width))
    assert [t[0] for t in tiles] == list(range(tl.tiles))
    for _, streams, rows, cols, chans in tiles:
        assert len(streams) and len(rows) and len(cols) and len(chans) == tl.bn
        assert streams.start % tl.streams == 0 and len(streams) == min(tl.streams, B - streams.start)
        seen[streams.start:streams.stop, rows.start:rows.stop, cols.start:cols.stop, chans.start:chans.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W", WIDE_LEVELS + PADDED)
@pytest.mark.parametrize("B", [1, 3, 5, 8, 63, 64])
def test_ring_tiling_fits_and_covers_every_output_once(B, cin, C, H, W, dtype):
    width, sl = U.kernel_width(C, cin), slab_channels(dtype)
    tl = U.chain_tiling(B, H, W, cin, C, dtype)
    cink = U.kernel_cin(cin, C, dtype)
    assert tl.ring and tl == U.chain_tiling(B, H, W, cink, width, dtype)  # the wrapper's call, on the kernel's sizes
    nw, m = tl.bn // RING_GROUP, tl.streams * tl.th * tl.tw
    # the rule's tables; float32 takes one m16 tile a warp (a second set of sums a stage)
    batch = tl.streams > 1 or tl.wgmma
    px, n = U.RING_BATCH_M, U.RING_BATCH_NW
    if tl.streams > 1:  # the batch kernel's whole maps of S streams, where a stream's map has fewer pixels
        assert (m, nw) == (px, n) and (tl.th, tl.tw) == (H, W) and m == tl.streams * H * W
        assert 2 <= tl.streams <= B and tl.splits == (1, 1) and tl.tiles >= U.RING_FILL * U.N_SMS
    else:
        assert (m, nw) in [(p, g) for p, g, _ in U.RING_TILES]
        assert tl.tw == (16 if m >= 128 and W >= 16 else 8) and not tl.wgmma
        # the batch kernel's tile where it fills the card, else the one-stream kernel's
        assert not (px > H * W and px % (H * W) == 0 and 2 <= px // (H * W) <= B and width % (32 * n) == 0
                    and -(-B // (px // (H * W))) * (width // (32 * n)) >= U.RING_FILL * U.N_SMS)
    # the batch kernel: wgmma in bfloat16, mma.sync in float32, one m16 tile a warp; the one-stream kernel the
    # table's m16 tiles (one in float32)
    assert tl.wgmma == (batch and dtype == torch.bfloat16)
    assert tl.wm == (1 if dtype == torch.float32 or batch else next(wm for px, n, wm in U.RING_TILES
                                                                    if (px, n) == (m, nw)))
    if batch:  # one warp (on wgmma, one warpgroup) along K
        assert tl.kw == 1
    else:
        assert tl.kw == (3 if m // (16 * tl.wm) * nw <= U.RING_KW_WARPS else 1)  # warps along K in small blocks
    assert tl.warps == m // (16 * tl.wm) * nw * tl.kw <= U.RING_MAX_WARPS and width % tl.bn == 0
    assert tl.smem_bytes == U.ring_smem(tl.th, tl.tw, nw, tl.streams) <= U.SMEM_CAP
    _covers(tl, B, H, W, width)
    # K splits only where the tiles leave SMs idle or the convs over C have many stages: up to 4 ways, half a
    # conv's stages, the SMs over the tiles; and the partial sums fit their scratch
    stages = (cink // sl, width // sl)
    cap = max(1, min(U.RING_MAX_SPLIT, U.N_SMS // tl.tiles))
    if tl.splits == (1, 1):  # filled without a split (a long conv only on a tile of several streams), or no split
        assert tl.partial == 0
        assert (tl.tiles >= U.RING_FILL * U.N_SMS and (stages[1] <= U.RING_SPLIT_STAGES or tl.streams > 1)) or \
            all(min(cap, n // 2) <= 1 for n in stages)
    else:
        assert tl.tiles < U.RING_FILL * U.N_SMS or stages[1] > U.RING_SPLIT_STAGES
        assert tl.splits == tuple(max(1, min(cap, n // 2)) for n in stages)
        assert tl.partial == tl.tiles * m * tl.bn * max(2 * tl.splits[0], tl.splits[1])
    if tl.th > H:  # a tile taller than the map only where no option is shorter
        assert m == min(px for px, *_ in U.RING_TILES)


#: tilings whose tiles span streams (the batch kernel's 64 pixels as 2, 4 or 8 streams' tiles), each against a
#: level it does not divide evenly: (B, H, W, tile)
SPANNING = [(3, 4, 8, (4, 8, 1, 2, 1, 2, True)), (5, 4, 8, (2, 8, 1, 2, 1, 4, True)),
            (63, 4, 8, (4, 8, 1, 2, 1, 2, True)), (7, 5, 9, (2, 8, 1, 2, 1, 4, True)),
            (5, 8, 16, (2, 16, 1, 2, 1, 2, True)), (3, 11, 21, (1, 8, 1, 2, 1, 8, True)),
            (2, 1, 8, (1, 8, 1, 2, 1, 8, True))]


@pytest.mark.parametrize("B,H,W,tile", SPANNING)
def test_ring_tiles_of_several_streams_cover_every_output_once(B, H, W, tile):
    tl = U.chain_tiling(B, H, W, 128, 64, torch.bfloat16, tile=tile)
    assert tl.streams == tile[5] and tl.tiles == -(-B // tile[5]) * -(-H // tile[0]) * -(-W // tile[1]) * (64 // tl.bn)
    _covers(tl, B, H, W, 64)


@pytest.mark.parametrize("B,H,W,tile", SPANNING + [(64, 4, 8, None), (63, 4, 8, None), (5, 8, 16, None),
                                                    (3, 16, 32, None)])
def test_ring_staging_reads_each_streams_own_pixels_and_zeros_at_its_edges(B, H, W, tile):
    """The model of the kernel's addresses (``ops/unet_block.py:ring_staging``
    for what ``load_tile`` copies where, ``ring_reads`` for what a row of
    the M tile reads at a tap): every output pixel reads at tap (dy, dx) its
    own stream's pixel (h + dy - 1, w + dx - 1), and a zero where that lies
    outside its map; never a neighbouring stream's pixel. Rows past B read
    zeros and write nothing."""
    tl = U.chain_tiling(B, H, W, 128, 64, torch.bfloat16, tile=tile)
    m, sub = tl.streams * tl.th * tl.tw, tl.th * tl.tw
    tiles_w, tiles_h = -(-W // tl.tw), -(-H // tl.th)
    n_px = -(-B // tl.streams) * tiles_h * tiles_w
    for x in range(n_px):
        staged = U.ring_staging(tl, B, H, W, x)
        assert len(staged) == tl.streams * (tl.th + 2) * (tl.tw + 2)
        tx, ty, b0 = x % tiles_w, x // tiles_w % tiles_h, x // (tiles_w * tiles_h) * tl.streams
        for p in range(m):
            s, q = divmod(p, sub)
            b, oh, ow = b0 + s, ty * tl.th + q // tl.tw, tx * tl.tw + q % tl.tw
            for tap in range(9):
                h, w = oh + tap // 3 - 1, ow + tap % 3 - 1
                want = (b, h, w) if b < B and 0 <= h < H and 0 <= w < W else None
                assert staged[U.ring_reads(tl, p, tap)] == want, (x, p, tap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_tiling_takes_a_tile_and_refuses_what_no_kernel_is_built_for(dtype):
    tl = U.chain_tiling(8, 16, 32, 128, 64, dtype, tile=(4, 8, 1, 2, 3, 1, False))
    assert (tl.th, tl.tw, tl.wm, tl.bn, tl.kw, tl.warps, tl.streams) == (4, 8, 1, 64, 3, 12, 1)
    assert tl.tiles == 8 * 4 * 4 and tl.splits == (1, 1)  # 128 tiles: nothing to split for
    tl = U.chain_tiling(1, 16, 32, 128, 64, dtype, tile=(2, 16, 1, 1, 1, 1, False, 2, 1))
    assert tl.splits == (2, 1) and tl.partial == tl.tiles * 32 * 32 * 4
    wg = dtype == torch.bfloat16  # tiles of several streams: wgmma in bfloat16, mma.sync in float32
    tl = U.chain_tiling(6, 4, 8, 128, 64, dtype, tile=(2, 8, 1, 2, 1, 4, wg))  # streams 0-3, 4-5
    assert (tl.streams, tl.tiles, tl.warps, tl.wgmma) == (4, 2 * 2, 8, wg)
    assert tl.smem_bytes == U.ring_smem(2, 8, 2, 4)
    for bad in [(4, 8, 4, 1, 1, 1, False), (4, 8, 1, 4, 1, 1, False), (3, 5, 1, 1, 1, 1, False),
                (8, 16, 1, 2, 3, 1, False), (4, 8, 1, 1, 10, 1, False), (8, 8, 1, 2, 1, 1, False, 1),
                (4, 8, 1, 2, 3), (2, 16, 1, 1, 1, 1, False, 9, 1), (4, 8, 1, 1, 1, 0, False),
                (4, 8, 1, 2, 1, 16, wg), (4, 8, 1, 2, 1, 1, True), (4, 8, 2, 2, 1, 2, wg),
                (4, 8, 1, 2, 2, 2, wg), (4, 8, 1, 1, 1, 2, wg), (4, 8, 1, 2, 1, 2, not wg),
                (4, 8, 1, 2, 1, 4, wg)]:
        # no such wm or nw, no m16 tiles, 48 warps, kw past 9, not (th, tw, wm, nw, kw, S, wgmma[, splits]),
        # 9 splits of 8, no streams; on the batch kernel, whose one tile is 64 pixels x 2 groups with one warp
        # along K: 512 pixels, wgmma on 32 pixels, two m16 tiles a warp, warps along K, one group, several
        # streams on the other dtype's path, 128 pixels
        with pytest.raises(ValueError):
            U.chain_tiling(8, 16, 32, 128, 64, dtype, tile=bad)
    if dtype == torch.float32:  # wgmma is bfloat16's
        with pytest.raises(ValueError, match="no ring kernel"):
            U.chain_tiling(8, 4, 8, 128, 64, dtype, tile=(4, 8, 1, 2, 1, 2, True))
    with pytest.raises(ValueError, match="no ring kernel"):  # 96 channels take no 64-channel tile
        U.chain_tiling(1, 8, 16, 96, 96, dtype, tile=(4, 16, 2, 2, 1, 1, False))
    with pytest.raises(NotImplementedError, match="C up to 256"):
        U.chain_tiling(1, 4, 8, 512, 288, dtype)
    with pytest.raises(NotImplementedError, match="Cin 1..512"):
        U.chain_tiling(1, 4, 8, 520, 256, dtype)


def test_ring_shared_memory_counts_three_slots_of_weights_and_a_halo():
    # 64 streams' enc2: two groups' 10 taps of 2 K steps x 4 n8 tiles x 256 B, a 10 x 18 tile of 80-byte pixels,
    # and 32 bytes for the slots' mbarriers and the last block's flag
    assert U.ring_smem(8, 16, 2) == 3 * (2 * 10 * 2048 + 10 * 18 * 80) + 32 == 166112
    # one stream's enc4: one group, a 6 x 10 tile
    assert U.ring_smem(4, 8, 1) == 3 * (10 * 2048 + 6 * 10 * 80) + 32
    # 64 streams' enc4 on the batch kernel: two streams' halos a slot
    assert U.ring_smem(4, 8, 2, 2) == 3 * (2 * 10 * 2048 + 2 * 6 * 10 * 80) + 32


@pytest.mark.parametrize("B,cin,C,H,W", [(1, 512, 256, 4, 8), (64, 32, 64, 16, 32), (2, 24, 48, 5, 12),
                                         (63, 128, 256, 4, 8)])
def test_wrapper_hands_the_ring_tiling_to_the_c_call_and_counts_it(monkeypatch, B, cin, C, H, W):
    calls = []

    def function(name, symbol, argtypes):
        assert (name, symbol, len(argtypes)) == ("unet_block", "rvc_conv_block_res_chain_ring", 23)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(U._cuda, "function", function)
    monkeypatch.setattr(U._cuda, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(U, "_sms", lambda device: U.N_SMS)
    dtype = torch.bfloat16
    packed = U.pack_chain(_t(_blocks(np.random.default_rng(0), cin, C, 2)), dtype)
    x = torch.zeros((B, H, W, cin), dtype=dtype)
    before = U.LAUNCHES
    assert packed.wgmma == []
    out = U._chain_cuda(x, packed)
    assert U.LAUNCHES == before + 1 and out.shape == (B, H, W, C) and out.dtype == dtype
    tl = U.chain_tiling(B, H, W, cin, C, dtype)
    (args,) = calls
    partial, counters = args[3], args[4]
    assert (partial.value is None) == (counters.value is None) == (tl.partial == 0)
    assert list(args[6:22]) == [2, B, H, W, packed.cin_kernel, packed.width, 1, tl.th, tl.tw, tl.wm,
                                tl.bn // RING_GROUP, tl.kw, tl.streams, int(tl.wgmma), *tl.splits]
    # wgmma reads the weights packed for it, made at its first launch; mma.sync leaves them unmade
    assert tl.wgmma == (B == 63) == bool(packed.wgmma)  # 63 streams' enc4: tiles of two streams
    params = U.wgmma_pack(packed)[1] if tl.wgmma else packed.params
    assert args[5].value == ctypes.cast(params, ctypes.c_void_p).value


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
