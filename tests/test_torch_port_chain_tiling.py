"""The U-Net chain kernel's launch shape, chosen on the host and checked on
the CPU (``ops/unet_block.py:chain_tiling`` and ``chain_tiles``).

The wrapper picks a tile (rows x columns of output pixels, m16 tiles a warp)
from the batch and the level's size and hands it to the C call, which
launches a block a tile in the order ``chain_tiles`` mirrors. Here, at 1, 3,
8 and 64 streams on the four main levels and on ragged ones: every output
pixel is computed by exactly one block; the blocks fill the SMs wherever the
level has a tile of the smallest shape for each SM; the tile grows with the
pixels an SM and fits shared memory. The wrapper hands the tiling to the C
call (a stand-in for the library records its arguments). The kernel itself
runs only on a card (``test_torch_port_cuda.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from obs_rvc_tpu_torch.ops import unet_block as U

# (cin, C, H, W): the four main-path levels of the full RMVPE, then levels off the tile grids
LEVELS = [(1, 16, 64, 128), (32, 16, 64, 128), (16, 32, 32, 64), (64, 32, 32, 64),
          (1, 16, 13, 37), (64, 32, 7, 50), (3, 32, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W", LEVELS)
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_tiles_cover_every_pixel_once_and_fill_the_card(B, cin, C, H, W, dtype):
    tl = U.chain_tiling(B, H, W, cin, C, dtype)
    assert tl.tw % 16 == 0 and tl.th * tl.tw == tl.warps * 16 * tl.wm and 1 <= tl.warps <= U.CUDA_MAX_WARPS
    assert tl.wm in U.CUDA_WM and (tl.th, tl.tw, tl.wm) in U.TILES
    assert tl.smem_bytes == U.level_smem(cin, C, dtype, tl.th, tl.tw) <= U.SMEM_CAP
    assert tl.tiles == B * -(-H // tl.th) * -(-W // tl.tw)
    seen = np.zeros((B, H, W), np.int32)
    blocks = []
    for blk, b, rows, cols in U.chain_tiles(tl, B, H, W):
        assert len(rows) and len(cols)  # no block falls wholly outside the image
        seen[b, rows.start:rows.stop, cols.start:cols.stop] += 1
        blocks.append(blk)
    assert (seen == 1).all()
    assert blocks == list(range(tl.tiles))
    th, tw, _ = U.TILES[0]
    if B * -(-H // th) * -(-W // tw) >= U.N_SMS:  # the level has a tile of the smallest shape for every SM
        assert tl.tiles >= U.N_SMS
    # larger tiles as the pixels an SM grow: 8-row tiles from 128 pixels an SM (8 streams at 64x128), two
    # m16 tiles a warp from 1024 (64 streams)
    px = B * H * W / U.N_SMS
    assert (tl.th, tl.wm) == ((4, 1) if px < 128 else (8, 1) if px < 1024 else (8, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiling_takes_a_tile_and_refuses_what_no_kernel_is_built_for(dtype):
    tl = U.chain_tiling(8, 64, 128, 32, 16, dtype, tile=(2, 32, 1))
    assert (tl.th, tl.tw, tl.wm, tl.warps) == (2, 32, 1, 4) and tl.tiles == 8 * 32 * 4
    assert U.chain_tiling(8, 64, 128, 32, 16, dtype, n_sms=1024).th == 4  # fewer pixels an SM, smaller tiles
    for bad in [(1, 24, 1), (1, 16, 4), (8, 64, 1), (1, 16, 2)]:  # ragged width, no such wm, 32 warps, 1/2 warp
        with pytest.raises(ValueError, match="no kernel"):
            U.chain_tiling(1, 64, 128, 32, 16, dtype, tile=bad)
    if dtype == torch.float32:  # 10 x 64 x 32 float32 weights and a 3 x 258 tile do not fit
        with pytest.raises(ValueError, match="shared memory"):
            U.chain_tiling(1, 32, 64, 64, 32, dtype, tile=(1, 256, 2))


def test_level_smem_counts_the_weights_and_two_haloed_tiles():
    assert isinstance(U.LAUNCHES, int)  # the wrapper's launch count, which chip_smoke.py reads
    # bf16 dec3: conv1 9 taps (+1 shortcut) x 4 K steps x 4 n8 tiles x 256 B, a 6 x 34 tile of 64 channels
    assert U.level_smem(64, 32, torch.bfloat16, 4, 32) == 10 * 4 * 4 * 256 + 6 * 34 * (64 * 2 + 16)
    # float32 enc0: Cin 1 pads to one k8 step; conv2 over C = 16 (two steps) is the larger
    assert U.level_smem(1, 16, torch.float32, 2, 32) == 9 * 2 * 2 * 256 + 4 * 34 * (16 * 4 + 16)


@pytest.mark.parametrize("tile", [None, (2, 32, 1)])
def test_wrapper_hands_the_tiling_to_the_c_call_and_counts_it(monkeypatch, tile):
    calls = []

    def function(name, symbol, argtypes):
        assert (name, symbol, len(argtypes)) == ("unet_block", "rvc_conv_block_res_chain", 15)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(U._cuda, "function", function)
    monkeypatch.setattr(U._cuda, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(U, "_sms", lambda device: U.N_SMS)
    rng = np.random.default_rng(5)
    blocks, ci = [], 16
    for _ in range(2):
        w = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        blocks.append((w(3, 3, ci, 32), w(32), w(3, 3, 32, 32), w(32), w(ci, 32) if ci != 32 else None,
                       w(32) if ci != 32 else None))
        ci = 32
    x = torch.zeros((8, 32, 64, 16), dtype=torch.bfloat16)
    before = U.LAUNCHES
    out = U._chain_cuda(x, U.pack_chain(blocks, torch.bfloat16), tile)
    assert U.LAUNCHES == before + 1 and out.shape == (8, 32, 64, 32) and out.dtype == torch.bfloat16
    tl = U.chain_tiling(8, 32, 64, 16, 32, torch.bfloat16, tile=tile)
    (args,) = calls
    assert list(args[4:14]) == [2, 8, 32, 64, 16, 32, 1, tl.th, tl.tw, tl.wm]
