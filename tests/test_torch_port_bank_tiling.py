"""The NSF resblock bank kernel's launch shape, chosen on the host and checked
on the CPU (``ops/resblock.py:bank_tiling`` and ``bank_tiles``).

The wrapper picks a tile (warps a block, m16 tiles a warp, so 16 wm warps
conv rows and that less the largest kernel's halo of output positions) from
the batch and the level's size and hands it to the C call, which launches
one grid per dilation in the order ``bank_tiles`` mirrors: before the last,
a block a bank and tile; in the last, a block a tile for every bank. Here,
at 1, 8 and 64 streams on the main path's two levels, the C=16 level and
ragged ones: every output position of every bank is computed by exactly one
block of each launch; the tile grows with the positions an SM and fits
shared memory; the refusals; the wrapper hands the tiling to the C call (a
stand-in for the library records its arguments). The kernel itself runs
only on a card (``test_torch_port_cuda.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from obs_rvc_tpu_torch.ops import resblock as R

KS, DILS = (3, 7, 11), (1, 3, 5)
# (L, C): the 40 kHz generator's C=64 and C=32 levels at T=35 frames, a C=16 level, then ragged ones
LEVELS = [(7000, 64), (14000, 32), (28000, 16), (5, 16), (1000, 64), (247, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,C", LEVELS)
@pytest.mark.parametrize("B", [1, 8, 64])
def test_tiles_cover_every_position_once_per_bank(B, L, C, dtype):
    tl = R.bank_tiling(B, L, C, dtype)
    assert (tl.warps, tl.wm, tl.ring) in R.TILES and tl.rows == 16 * tl.warps * tl.wm
    assert tl.tile == tl.rows - (max(KS) - 1)  # conv1 computes the tile and conv2's halo of 10 rows
    assert tl.smem_bytes == R.level_smem(C, dtype, tl.rows, max(KS), max(DILS), tl.ring) <= R.SMEM_CAP
    assert tl.tiles == -(-L // tl.tile) and tl.blocks == len(KS) * B * tl.tiles
    # the last step splits into a block a bank and tile where a block a tile would not fill the card twice
    assert tl.split == (B * tl.tiles < 2 * R.N_SMS)
    for last in (False, True):
        fused = last and not tl.split
        seen = np.zeros((B, 1 if fused else len(KS), L), np.int32)
        blocks, ranks = [], []
        for blk, b, r, pos in R.bank_tiles(tl, B, L, len(KS), last):
            assert len(pos)  # no block falls wholly past L
            seen[b, 0 if fused else r, pos.start:pos.stop] += 1
            blocks.append(blk)
            ranks.append(r)
        assert (seen == 1).all()
        assert blocks == list(range(tl.blocks // (len(KS) if fused else 1)))
        assert fused or ranks == sorted(ranks)  # the largest k's blocks first
    # longer tiles as the positions an SM grow: 256 conv rows from 256 positions an SM (8 and 64
    # streams), so the halo recomputed falls from 10/118 of a tile to 10/246, and a ring of 3 taps, not 8
    per_sm = B * L / R.N_SMS
    assert (tl.rows, tl.ring) == ((128, 8) if per_sm < 256 else (256, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiling_takes_a_tile_and_refuses_what_no_kernel_is_built_for(dtype, monkeypatch):
    tl = R.bank_tiling(8, 7000, 64, dtype, tile=(2, 1))
    assert (tl.warps, tl.wm, tl.rows, tl.tile, tl.ring) == (2, 1, 32, 22, R.RING) and tl.tiles == -(-7000 // 22)
    tl = R.bank_tiling(1, 7000, 64, dtype, tile=(4, 2, 5, False))  # a ring of 5, the last step not split
    assert (tl.ring, tl.split) == (5, False) and R.bank_tiling(1, 7000, 64, dtype).split
    assert R.bank_tiling(8, 7000, 64, dtype, n_sms=1024).rows == 128  # fewer positions an SM, shorter tiles
    assert R.bank_tiling(1, 7000, 64, dtype, kernel_sizes=(3,)).tile == 126  # the halo of the largest k
    for bad in [(1, 3), (9, 1), (0, 2), (1, 0), (4, 2, 1), (4, 2, 9)]:  # no such wm, 9 warps, no warp, rings
        with pytest.raises(ValueError, match="no kernel"):
            R.bank_tiling(1, 7000, 64, dtype, tile=bad)
    with pytest.raises(ValueError, match="no kernel"):  # 16 rows leave 6 positions of a k=11 tile, 13 of k=3
        R.bank_tiling(1, 7000, 64, dtype, tile=(1, 1), kernel_sizes=(3, 7, 19))
    for C in (65, 128):  # past the widest instance, 64 (a narrower C runs on the next instance up)
        with pytest.raises(ValueError, match="C="):
            R.bank_tiling(1, 7000, C, dtype)
    for B, L in ((0, 7000), (1, 0)):
        with pytest.raises(ValueError, match="empty"):
            R.bank_tiling(B, L, 64, dtype)
    monkeypatch.setattr(R, "SMEM_CAP", 60_000)  # a smaller card's block: 256 rows of C=64 do not fit
    with pytest.raises(ValueError, match="shared memory"):
        R.bank_tiling(64, 7000, 64, dtype)


def test_level_smem_counts_the_ring_and_one_plane():
    assert isinstance(R.LAUNCHES, int)  # the wrapper's launch count, which chip_smoke.py reads
    # bf16 C=64, 128 rows at d=5: 6 tap slabs of 64 x 64 bf16 (48 KB); one plane of 128 + 10 * 5 rows
    # of 64 * 2 + 16 bytes (lrelu(x) for conv1, then conv1's output)
    assert R.level_smem(64, torch.bfloat16, 128, 11, 5, 6) == 6 * 64 * 64 * 2 + 178 * 144
    # float32 C=64, 128 rows at d=5, 3 slabs: under half a block's 227 KB, so two blocks an SM
    assert R.level_smem(64, torch.float32, 128, 11, 5, 3) == 3 * 64 * 64 * 4 + 178 * 272 < R.SMEM_CAP // 2
    # float32 C=64, 256 rows at d=5, the most slabs: every tile fits a block
    assert R.level_smem(64, torch.float32, 256, 11, 5, R.MAX_RING) == 8 * 64 * 64 * 4 + 306 * 272 <= R.SMEM_CAP
    # float32 C=16, 64 rows at d=1
    assert R.level_smem(16, torch.float32, 64, 11, 1, 8) == 8 * 16 * 16 * 4 + 74 * 80


@pytest.mark.parametrize("dils", [(1, 3, 5), (2,)])
@pytest.mark.parametrize("tile", [None, (4, 1), (4, 1, 3, False)])
def test_wrapper_hands_the_tiling_to_the_c_call_and_counts_it(monkeypatch, tile, dils):
    calls = []

    def function(name, symbol, argtypes):
        assert (name, symbol, len(argtypes)) == ("resblock", "rvc_resblock_bank", 17)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(R._cuda, "function", function)
    monkeypatch.setattr(R._cuda, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(R, "_sms", lambda device: R.N_SMS)
    rng = np.random.default_rng(5)
    S = len(dils)

    def w(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    params = [(w(S, k, 32, 32), w(S, 32), w(S, k, 32, 32), w(S, 32)) for k in KS]
    x = torch.zeros((8, 1000, 32), dtype=torch.bfloat16)
    before = R.LAUNCHES
    out = R._resblock_bank_cuda(x, R.pack_bank(params, KS, dils, torch.bfloat16), KS, dils, tile)
    assert R.LAUNCHES == before + 1 and out.shape == (8, 1000, 32) and out.dtype == torch.bfloat16
    tl = R.bank_tiling(8, 1000, 32, torch.bfloat16, kernel_sizes=KS, dilations=dils, tile=tile)
    (args,) = calls
    assert list(args[5:7]) == [3, S] and list(args[9:16]) == [8, 1000, 32, 1, tl.warps, tl.wm, tl.ring]
    assert (args[2].value is None) == (S == 1)  # one launch needs no buffer between steps
    assert (args[3].value is None) == (not tl.split)  # a split last step's float32 outputs
