"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These run only where a CUDA card is present; elsewhere each test skips with
the reason (the kernels have no CPU mode, and their plain versions are held
against the JAX package's Pallas kernels in ``test_torch_port_kernels.py``).
They cover what ``chip_smoke.py``'s main-path shapes do not: batches, ragged
tile edges, every channel count the kernels are built for and widths padded
to one, other kernel sizes and dilations, what is still refused, and the
launch counters; the log-mel kernel on FCPE's Slaney basis; and, at reduced
widths, the step's CUDA graphs against the eager step (with each pitch
algorithm), replayed from two threads, captured again after a weight
reload, and a capture that fails; retrieval's edge cases on the card (a
union with fewer valid rows than k, a slab length that is no multiple of
8, a bfloat16 table's float32 scores, the blend graphed, a second table
loaded into a graphed step); the weights check before each staged step, and
its host cost at RVC v2 40k (printed). On a machine with a card, run them as::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up for a CPU mesh, which
these tests do not need.)

Float32 bounds 1e-4 abs / 1e-3 rel: the kernels sum the same products as
cuDNN in another order, over up to 11 * 64 * 2 terms per output. bfloat16
bounds are the JAX package's own for these kernels (bank 3e-2/2e-2, chain
5e-2/2e-2). TF32 is off for the plain versions. The log-mel kernel is held
to the JAX package's own bound for its Pallas kernel (2e-4 abs / 1e-4 rel):
its FFT sums each bin in another order than the plain version's DFT
matmul, and the log turns that relative error into an absolute one. The
chain's float32 products run as 3xTF32 on the tensor cores, which keeps
float32's accuracy; its bf16 ones as one bf16 product with float32
accumulation.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram
from obs_rvc_tpu_torch.models.layers import GroupNorm, VitsLayerNorm
from obs_rvc_tpu_torch.ops import crepe_conv, resblock, stft_mel, unet_block

pytestmark = pytest.mark.cuda

BOUNDS = {
    "bank": {torch.float32: (1e-4, 1e-3), torch.bfloat16: (3e-2, 2e-2)},
    "chain": {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 2e-2)},
    "mel": (2e-4, 1e-4),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol, rtol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    assert not bad.any(), f"{int(bad.sum())} elements off, max abs err {float(err.max()):.3e}"


def norm_rule_mismatch(device) -> dict:
    """For each kind of norm the networks use (PyTorch's LayerNorm,
    BatchNorm2d and BatchNorm1d, the port's GroupNorm and VitsLayerNorm), in bfloat16 on
    ``device``: ``(share of outputs that differ, largest difference in bf16
    steps)`` between it and flax's rule (statistics and affine map in
    float32 over the bf16 input and parameters, the result rounded once).
    A step is one bf16 step at the output's magnitude, floored at 2^-8 of
    the largest output: near zero a float32 sum in another order moves the
    result by more than a step of its own tiny magnitude, while bf16
    intermediates would move it by steps of the operands' size."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen) * scale + shift

    cases = {
        "LayerNorm": (nn.LayerNorm(64), rnd(2, 40, 64, scale=3.0, shift=1.0)),
        "GroupNorm": (GroupNorm(16, 16), rnd(1, 16, 700, scale=3.0, shift=1.0)),
        "BatchNorm2d": (nn.BatchNorm2d(16).eval(), rnd(1, 16, 8, 32, scale=3.0, shift=1.0)),
        "BatchNorm1d": (nn.BatchNorm1d(16, eps=1e-3).eval(), rnd(4, 16, 64, scale=3.0, shift=1.0)),
        "VitsLayerNorm": (VitsLayerNorm(32), rnd(1, 32, 40, scale=3.0, shift=1.0)),
    }
    out = {}
    for name, (m, x) in cases.items():
        with torch.no_grad():
            for pname, t in list(m.named_parameters()) + list(m.named_buffers()):
                if t.is_floating_point():
                    t.copy_(rnd(*t.shape).abs() + 0.5 if "var" in pname else rnd(*t.shape, scale=0.5,
                                                                                  shift=1.0 if pname in ("weight", "gamma") else 0.0))
            m = m.to(device, torch.bfloat16)
            x = x.to(device, torch.bfloat16)
            got = m(x).float()
            want = copy.deepcopy(m).float()(x.float()).to(torch.bfloat16).float()
        mag = want.abs().clamp_min(float(want.abs().max()) * 2**-8)
        step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        steps = ((got - want).abs() / step).max()
        out[name] = (float((got != want).float().mean()), float(steps))
    return out


def test_bf16_norms_follow_flax_rule(cuda):
    """The networks' norms on the card, with a bfloat16 input and bfloat16
    parameters, compute as flax's norms with ``dtype`` do: float32 inside,
    one rounding at the output (a sum in another order may round the other
    way by one bf16 step). PyTorch's own GroupNorm does not on the card,
    which is why the port has its own."""
    for name, (share, steps) in norm_rule_mismatch(cuda).items():
        assert share <= 1e-2 and steps <= 1.0, (name, share, steps)


def _bank(rng, B, L, C, ks, device, S=3):
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    params = [tuple(t(a) for a in (
        rng.standard_normal((S, k, C, C)) / np.sqrt(k * C), rng.standard_normal((S, C)) * 0.05,
        rng.standard_normal((S, k, C, C)) / np.sqrt(k * C), rng.standard_normal((S, C)) * 0.05))
        for k in ks]
    return t(rng.standard_normal((B, L, C)) * 0.5), params


def _length(L, B, C, dtype, tile=None):
    """``L``, or for "TL-1" / "TL" / "TL+1" the length of the tile that
    :func:`resblock.bank_tiling` picks (or ``tile``'s) plus the offset."""
    if isinstance(L, int):
        return L
    tl = resblock.bank_tiling(B, 1, C, dtype, torch.cuda.get_device_properties(0).multi_processor_count, tile=tile)
    n = tl.tile + int(L[2:] or 0)
    assert resblock.bank_tiling(B, n, C, dtype, tile=tile).tile == tl.tile  # the same tile at that length
    return n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,L,B,dil", [
    # one tile less one, one tile, one tile and one position, at each channel count
    *[(C, L, B, dil) for C, B, dil in ((16, 1, (1, 3, 5)), (32, 2, (1, 2, 4)), (64, 1, (1, 3, 5)))
      for L in ("TL-1", "TL", "TL+1")],
    (64, 1, 1, (1, 3, 5)),     # one position: every tap but the centre reads padding
    (16, 1, 3, (1, 2, 4)),
    (16, 37, 3, (1, 3, 5)),    # a batch of 3
    (32, 300, 3, (1, 2, 4)),
    (64, 1000, 3, (1, 2, 4)),
    (64, 7000, 1, (1, 3, 5)),  # the main path's two levels, at 1 and 8 streams, and one at 64
    (32, 14000, 1, (1, 3, 5)),
    (64, 7000, 8, (1, 3, 5)),
    (32, 14000, 8, (1, 3, 5)),
    (32, 14000, 64, (1, 3, 5)),
    (16, 28000, 1, (1, 3, 5)),  # C=16 (the JAX package's im2col range)
    (64, 500, 2, (3,)),        # one dilation: the first launch is the last
    (32, 400, 2, (1, 5)),      # two
    (32, 2000, 40, (1, 3, 5)),  # 40 streams: the last step a block a tile, not split
])
def test_resblock_bank_kernel_matches_plain(cuda, C, L, B, dil, dtype):
    ks = (3, 7, 11)
    L = _length(L, B, C, dtype)
    x, params = _bank(np.random.default_rng(C + L), B, L, C, ks, cuda, S=len(dil))
    x = x.to(dtype)
    packed = resblock.pack_bank(params, ks, dil, dtype)  # as GeneratorNSF caches it per weight version
    before = resblock.LAUNCHES
    got = resblock.resblock_bank(x, packed, ks, dil)
    assert resblock.LAUNCHES == before + 1  # one C call runs the whole bank
    want = resblock.resblock_bank_plain(x, params, ks, dil)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, L, C) and got.dtype == dtype
    _close(got, want, *BOUNDS["bank"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,L,B,ks,dil", [
    (8, 700, 2, (3, 7, 11), (1, 3, 5)),      # the C=8 instance (bf16: the plane's rows padded to 16 channels)
    (8, 28000, 1, (3, 7, 11), (1, 3, 5)),    # a reduced-width generator's C=8 level
    (48, 1000, 2, (3, 7, 11), (1, 3, 5)),    # padded to C=64
    (12, 333, 3, (3, 7, 11), (1, 2, 4)),     # padded to 16
    (1, 300, 2, (3,), (1,)),                 # one channel, padded to 8
    (40, 500, 1, (3, 7, 11), (1, 3, 5)),     # padded to 64, one stream
    (32, 700, 2, (5,), (1, 2)),              # k=5
    (24, 400, 2, (5,), (1, 2)),
    (32, 1000, 2, (11,), (11,)),             # d=11 at k=11: conv1's halo of 110 rows
    (64, 1000, 1, (3, 7, 11), (1, 11)),
    (16, 500, 2, (1, 9), (2,)),              # k=1 and k=9
    (32, 800, 2, (3, 5, 7, 9), (1, 3)),      # four banks
])
def test_resblock_bank_kernel_at_every_width(cuda, C, L, B, ks, dil, dtype):
    """Widths, kernel sizes and dilations past the main path's: C=8 on its
    own instance, other C zero-padded to the next one (exact), any odd k,
    a dilation as far as its halo fits shared memory, four banks."""
    x, params = _bank(np.random.default_rng(C * 7 + L), B, L, C, ks, cuda, S=len(dil))
    x = x.to(dtype)
    packed = resblock.pack_bank(params, ks, dil, dtype)
    assert packed.width == min(w for w in resblock.CUDA_CHANNELS if w >= C)
    before = resblock.LAUNCHES
    got = resblock.resblock_bank(x, packed, ks, dil)
    assert resblock.LAUNCHES == before + 1
    want = resblock.resblock_bank_plain(x, params, ks, dil)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, L, C) and got.dtype == dtype and got.is_contiguous()
    _close(got, want, *BOUNDS["bank"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [*resblock.SWEEP_TILES, (4, 2, 2, True), (4, 2, 8, False), (8, 2, 3, True)])
def test_resblock_bank_kernel_at_every_tile(cuda, tile, dtype):
    """Each tile the kernel takes, at its own edges (TL-1 and TL+1) on a
    batch of 2, and ragged at C=16; banks of other kernel sizes; the ring's
    least and largest depth, the last step split and not."""
    for C, L, B, ks in [(64, "TL-1", 2, (3, 7, 11)), (32, "TL+1", 2, (3, 7, 11)), (16, 333, 3, (11, 3)),
                        (32, 129, 1, (7,))]:
        L = _length(L, B, C, dtype, tile)
        x, params = _bank(np.random.default_rng(C + L + tile[0]), B, L, C, ks, cuda)
        x = x.to(dtype)
        got = resblock.resblock_bank(x, resblock.pack_bank(params, ks, (1, 3, 5), dtype), ks, (1, 3, 5), tile=tile)
        want = resblock.resblock_bank_plain(x, params, ks, (1, 3, 5))
        torch.cuda.synchronize()
        _close(got, want, *BOUNDS["bank"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resblock_bank_kernel_repeats_bit_for_bit(cuda, dtype):
    """Two calls on the same input give the same bits (the banks' sum is
    taken in a fixed order, with no atomics), and so does a stream taken
    alone: a position's arithmetic does not depend on the tile it falls in."""
    x, params = _bank(np.random.default_rng(9), 8, 7000, 64, (3, 7, 11), cuda)
    x = x.to(dtype)
    packed = resblock.pack_bank(params, (3, 7, 11), (1, 3, 5), dtype)
    first = resblock.resblock_bank(x, packed, (3, 7, 11), (1, 3, 5))
    again = resblock.resblock_bank(x, packed, (3, 7, 11), (1, 3, 5))
    alone = resblock.resblock_bank(x[5:6].contiguous(), packed, (3, 7, 11), (1, 3, 5))
    # the last step a block a tile for every bank, or split into a block a bank and a sum kernel that adds
    # the banks in the same order
    fused = resblock.resblock_bank(x, packed, (3, 7, 11), (1, 3, 5), tile=(8, 2, 3, False))
    split = resblock.resblock_bank(x, packed, (3, 7, 11), (1, 3, 5), tile=(4, 2, 4, True))
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first[5:6], alone)
    assert torch.equal(first, fused) and torch.equal(first, split)


def _chain(rng, B, H, W, cin, C, n_blocks, device):
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    blocks, ci = [], cin
    for _ in range(n_blocks):
        wsc = bsc = None
        if ci != C:
            wsc, bsc = t(rng.standard_normal((ci, C)) / np.sqrt(ci)), t(rng.standard_normal(C) * 0.05)
        blocks.append((t(rng.standard_normal((3, 3, ci, C)) / np.sqrt(9 * ci)), t(rng.standard_normal(C) * 0.05),
                       t(rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)), t(rng.standard_normal(C) * 0.05),
                       wsc, bsc))
        ci = C
    return t(rng.standard_normal((B, H, W, cin)) * 0.5), blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W,B", [
    (1, 16, 8, 32, 2),     # encoder level 0
    (16, 16, 8, 32, 2),    # identity shortcut from the first block
    (32, 16, 20, 36, 1),   # a decoder level, H and W off the tile grid
    (16, 32, 4, 16, 3),    # channel doubling
    (64, 32, 7, 50, 2),    # the widest input the kernel takes, ragged edges
    (3, 32, 1, 1, 1),      # one pixel, an input width off the float4 grid
    (1, 8, 16, 40, 2),     # the C=8 instance: a reduced-width RMVPE's first level
    (8, 8, 9, 33, 2),      # identity shortcut at C=8
    (16, 8, 16, 40, 2),    # its decoder level (the 2C concat)
    (64, 8, 10, 20, 2),
    (12, 24, 7, 30, 2),    # C=24 padded to 32
    (24, 24, 5, 20, 1),    # identity shortcut on a padded width: the input padded too
    (5, 12, 8, 16, 3),     # C=12 padded to 16, Cin off the 16-byte grid
    (2, 1, 4, 16, 1),      # one channel, padded to 8
    (48, 20, 6, 18, 2),
])
def test_unet_chain_kernel_matches_plain(cuda, cin, C, H, W, B, dtype):
    x, blocks = _chain(np.random.default_rng(cin * 100 + C), B, H, W, cin, C, 3, cuda)
    x = x.to(dtype)
    got = unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, dtype))
    want = unet_block.conv_block_res_chain_plain(x, blocks)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, H, W, C) and got.dtype == dtype and got.is_contiguous()
    _close(got, want, *BOUNDS["chain"][dtype])


# the four main-path levels of the full RMVPE (64 frames x 128 mels), four blocks each
MAIN_LEVELS = [(1, 16, 64, 128), (32, 16, 64, 128), (16, 32, 32, 64), (64, 32, 32, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W,B,n", [
    (1, 16, 13, 37, 3, 2),    # Cin 1, off the 2x16 tile grid, a batch of 3
    (3, 32, 5, 19, 3, 2),     # Cin 3: K = 27, padded to 32
    (16, 32, 9, 33, 1, 2),
    (32, 32, 3, 17, 2, 3),    # identity shortcut from the first block
    (64, 16, 6, 40, 2, 2),    # the widest input at C = 16
    *[(cin, C, H, W, 1, 4) for cin, C, H, W in MAIN_LEVELS],
    # the batched step's 8 and 64 streams: 8-row tiles, one and two m16 tiles a warp
    *[(cin, C, H, W, 8, 4) for cin, C, H, W in MAIN_LEVELS],
    *[(cin, C, H, W, 64, 4) for cin, C, H, W in MAIN_LEVELS],
    (32, 16, 61, 125, 8, 2),  # 8 streams off the tile grid in both directions
    (16, 32, 29, 61, 64, 2),  # 64 streams off the tile grid, a wave of blocks cut short
    (1, 16, 63, 127, 64, 1),  # Cin 1 (plain stores) at 64 streams, ragged
])
def test_unet_chain_kernel_at_edges_and_main_levels(cuda, cin, C, H, W, B, n, dtype):
    x, blocks = _chain(np.random.default_rng(cin * 1000 + H * W), B, H, W, cin, C, n, cuda)
    x = x.to(dtype)
    packed = unet_block.pack_chain(blocks, dtype)
    before = unet_block.LAUNCHES
    got = unet_block.conv_block_res_chain(x, packed)
    assert unet_block.LAUNCHES == before + 1  # one C call runs the whole level
    want = unet_block.conv_block_res_chain_plain(x, blocks)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, H, W, C) and got.dtype == dtype
    _close(got, want, *BOUNDS["chain"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", unet_block.TILES)
def test_unet_chain_kernel_at_every_tile(cuda, tile, dtype):
    """Each tile shape the wrapper may choose, on a ragged batched level,
    and Cin 1 for the plain-store staging."""
    for cin, C, H, W, B in [(16, 32, 11, 45, 3), (1, 16, 9, 35, 2)]:
        x, blocks = _chain(np.random.default_rng(cin + H), B, H, W, cin, C, 2, cuda)
        x = x.to(dtype)
        if unet_block.level_smem(cin, C, dtype, *tile[:2]) > unet_block.SMEM_CAP:
            continue
        got = unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, dtype), tile=tile)
        want = unet_block.conv_block_res_chain_plain(x, blocks)
        torch.cuda.synchronize()
        _close(got, want, *BOUNDS["chain"][dtype])


#: the six levels of the full RMVPE past the resident kernel (C = 64, 128, 256; the decoder's 2C concat),
#: which run on the ring kernel at pallas_unet_max_ch 64 and above: (cin, C, H, W)
WIDE_LEVELS = [(32, 64, 16, 32), (128, 64, 16, 32), (64, 128, 8, 16), (256, 128, 8, 16), (128, 256, 4, 8),
               (512, 256, 4, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C,H,W,B,n", [
    # one stream (K split across blocks), the batched step's 8 streams and 64 (one block a tile)
    *[(cin, C, H, W, B, 4) for cin, C, H, W in WIDE_LEVELS for B in (1, 8, 64)],
    (24, 48, 16, 32, 1, 2),   # C padded to 64, Cin to a slab
    (96, 96, 8, 16, 2, 2),    # identity first block on a width of three groups (no 64-channel tile)
    (100, 16, 6, 20, 2, 2),   # C <= 32 with Cin past the resident kernel's 64
    (3, 40, 5, 11, 3, 2),     # Cin under a slab, ragged in both directions
    (64, 64, 7, 9, 2, 2),     # identity first block, ragged
    (512, 256, 1, 8, 1, 1),   # one row: tiles taller than the map
    (256, 256, 3, 5, 1, 2),   # W under 8
    # enc4 and dec0 with a last tile of fewer streams than the tile takes
    *[(cin, C, H, W, B, 2) for cin, C, H, W in WIDE_LEVELS[4:] for B in (3, 5, 63)],
])
def test_unet_chain_ring_kernel_matches_plain(cuda, cin, C, H, W, B, n, dtype):
    x, blocks = _chain(np.random.default_rng(cin * 7 + C + B), B, H, W, cin, C, n, cuda)
    x = x.to(dtype)
    packed = unet_block.pack_chain(blocks, dtype)
    assert packed.ring and packed.width == -(-C // 32) * 32
    before = unet_block.LAUNCHES
    got = unet_block.conv_block_res_chain(x, packed)
    assert unet_block.LAUNCHES == before + 1  # one C call runs the whole level
    want = unet_block.conv_block_res_chain_plain(x, blocks)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, H, W, C) and got.dtype == dtype and got.is_contiguous()
    _close(got, want, *BOUNDS["chain"][dtype])


#: one-stream tiles (th, tw, wm, nw, kw, 1, False[, split_in, split_c]): every RING_TILES block at 1 and 3 warps
#: along K, and others with 1 to 9 warps along K and K split as the tile sets it; each in both dtypes
RING_ONE_STREAM_TILES = [(px // 8, 8, wm, nw, kw, 1, False) for px, nw, wm in unet_block.RING_TILES for kw in (1, 3)
                         if px // (16 * wm) * nw * kw <= unet_block.RING_MAX_WARPS] + [
    (8, 16, 2, 2, 1, 1, False), (4, 16, 1, 1, 1, 1, False), (16, 8, 2, 2, 1, 1, False), (1, 32, 2, 1, 9, 1, False),
    (4, 8, 2, 2, 2, 1, False), (4, 8, 1, 2, 3, 1, False, 3, 2), (2, 16, 1, 1, 1, 1, False, 3, 1)]


def _ring_tiles():
    """RING_ONE_STREAM_TILES in both dtypes (ids ``tile{i}-dtype{j}``); every further tile the rule can pick
    at the six wide levels from 1 to 64 streams; and the batch kernel's tile as 1 (wgmma), 2, 4 and 8
    streams' tiles, one with K split."""
    dtypes = (torch.float32, torch.bfloat16)
    out = [pytest.param(t, dt, id=f"tile{i}-dtype{j}") for i, t in enumerate(RING_ONE_STREAM_TILES)
           for j, dt in enumerate(dtypes)]
    seen = {(p.values[0], p.values[1]) for p in out}
    for j, dtype in enumerate(dtypes):
        wg = dtype == torch.bfloat16
        more = [o for B in (1, 3, 5, 8, 63, 64) for cin, C, H, W in WIDE_LEVELS
                for o in unet_block.ring_options(B, H, W, C, dtype)]
        more += [(4, 8, 1, 2, 1, 2, wg), (2, 8, 1, 2, 1, 4, wg), (1, 8, 1, 2, 1, 8, wg), (4, 8, 1, 2, 1, 2, wg, 3, 2)]
        more += [(4, 16, 1, 2, 1, 1, True)] if wg else []
        for t in dict.fromkeys(more):
            if (t, dtype) not in seen:
                seen.add((t, dtype))
                out.append(pytest.param(t, dtype, id="x".join(map(str, t)).replace("True", "wgmma")
                                        .replace("False", "mma") + f"-dtype{j}"))
    return out


@pytest.mark.parametrize("tile,dtype", _ring_tiles())
def test_unet_chain_ring_kernel_at_every_tile(cuda, tile, dtype):
    """Each tile the ring kernel's rule can pick (tiles of one stream and of
    several, mma.sync and wgmma), and others with 1 to 9 warps along K, on a
    ragged batched level with a shortcut and one without, with K split
    across blocks by the rule and as the tile sets it; a tile of several
    streams takes tiles of its th x tw from each of S streams, the last
    group short of S."""
    for cin, C, H, W, B in [(96, 64, 11, 21, 3), (128, 128, 5, 9, 1), (96, 128, 4, 8, 7)]:
        x, blocks = _chain(np.random.default_rng(cin + H), B, H, W, cin, C, 2, cuda)
        x = x.to(dtype)
        got = unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, dtype), tile=tile)
        want = unet_block.conv_block_res_chain_plain(x, blocks)
        torch.cuda.synchronize()
        _close(got, want, *BOUNDS["chain"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 64])
def test_unet_chain_ring_kernel_repeats_bit_for_bit(cuda, B, dtype):
    """The split K sums its partials in split order, the warps along K
    theirs in warp order, with no float atomics: the same bits at every
    call, captured in a graph too; at one stream (K split) and at 64 (tiles
    of several streams)."""
    x, blocks = _chain(np.random.default_rng(3), B, 4, 8, 512, 256, 4, cuda)
    x = x.to(dtype)
    packed = unet_block.pack_chain(blocks, dtype)
    tl = unet_block.chain_tiling(B, 4, 8, 512, 256, dtype, unet_block._sms(x.device))
    assert max(tl.splits) > 1 if B == 1 else tl.streams > 1
    first = unet_block.conv_block_res_chain(x, packed)
    for _ in range(5):
        assert torch.equal(unet_block.conv_block_res_chain(x, packed), first)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        unet_block.conv_block_res_chain(x, packed)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = unet_block.conv_block_res_chain(x, packed)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


def test_wrappers_count_one_launch_per_call(cuda):
    rng = np.random.default_rng(0)
    x, params = _bank(rng, 1, 64, 32, (3, 7, 11), cuda)
    before = resblock.LAUNCHES
    resblock.resblock_bank(x, resblock.pack_bank(params, (3, 7, 11), (1, 3, 5), x.dtype), (3, 7, 11), (1, 3, 5))
    assert resblock.LAUNCHES == before + 1
    x, blocks = _chain(rng, 1, 8, 16, 1, 16, 4, cuda)
    before = unet_block.LAUNCHES
    unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, x.dtype))
    assert unet_block.LAUNCHES == before + 1


def test_wrappers_refuse_what_no_kernel_is_built_for(cuda):
    """Past the kernels' coverage each wrapper raises, naming the limit; it
    never falls back to cuDNN or to the plain version."""
    rng = np.random.default_rng(1)
    x, params = _bank(rng, 1, 64, 72, (3, 7, 11), cuda)
    with pytest.raises(NotImplementedError, match="C up to 64.*registers"):
        resblock.pack_bank(params, (3, 7, 11), (1, 3, 5), x.dtype)
    with pytest.raises(NotImplementedError, match="C up to 64"):
        resblock.resblock_bank(x, params, (3, 7, 11), (1, 3, 5))
    x, params = _bank(rng, 1, 64, 16, (4,), cuda)
    with pytest.raises(NotImplementedError, match="odd"):
        resblock.pack_bank(params, (4,), (1, 3, 5), x.dtype)
    x, params = _bank(rng, 1, 64, 64, (11,), cuda, S=1)
    with pytest.raises(NotImplementedError, match="shared memory"):
        resblock.pack_bank(params, (11,), (30,), torch.float32)
    x, params = _bank(rng, 1, 64, 16, (3, 7, 11), cuda)
    with pytest.raises(ValueError, match="pack_bank"):  # on a card the kernel takes only the pack
        resblock.resblock_bank(x, params, (3, 7, 11), (1, 3, 5))
    x, blocks = _chain(rng, 1, 8, 16, 8, 288, 1, cuda)
    with pytest.raises(NotImplementedError, match="C up to 256.*widest level"):
        unet_block.pack_chain(blocks, x.dtype)
    with pytest.raises(NotImplementedError, match="C up to 256"):
        unet_block.conv_block_res_chain(x, unet_block.PackedChain(
            x.dtype, x.device, 288, 8, 288, 8, [], None, True))
    x, blocks = _chain(rng, 1, 8, 16, 520, 32, 1, cuda)
    with pytest.raises(NotImplementedError, match="Cin 1..512"):
        unet_block.pack_chain(blocks, x.dtype)
    x, blocks = _chain(rng, 1, 8, 16, 8, 16, 1, cuda)
    with pytest.raises(ValueError, match="pack_chain"):  # on a card the kernel takes only the pack
        unet_block.conv_block_res_chain(x, blocks)


def _voiced_16k(n, seed=0):
    t = np.arange(n) / 16000
    f = 180.0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("L,kind", [
    (100, "normal"),     # shorter than one hop: T=1, the padding reflects more than once
    (320, "voiced"),     # T=3
    (9920, "voiced"),    # T=63
    (10080, "voiced"),   # T=64, the main path's shape
    (10080, "normal"),
    (10400, "voiced"),   # T=66
    (48000, "voiced"),   # T=301, an offline length
    (10080, "silence"),
    (10080, "loud"),     # x1e3 amplitude
])
def test_log_mel_kernel_matches_plain(cuda, L, kind):
    rng = np.random.default_rng(L)
    x = {"normal": rng.standard_normal(L).astype(np.float32), "voiced": _voiced_16k(L),
         "silence": np.zeros(L, np.float32), "loud": 1e3 * _voiced_16k(L)}[kind]
    sig = torch.from_numpy(x).to(cuda)
    mel = MelSpectrogram(device=cuda)
    basis, win = mel.mel_basis, mel.window
    before = stft_mel.LAUNCHES
    got = stft_mel.log_mel(sig, mel.log_mel_basis, win)
    assert stft_mel.LAUNCHES == before + 1
    want = stft_mel.log_mel_plain(sig, basis, win)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (128, 1 + L // 160)
    if kind == "silence":
        torch.testing.assert_close(got, torch.full_like(got, float(np.log(1e-5))), atol=1e-5, rtol=0)
    _close(got, want, *BOUNDS["mel"])


@pytest.mark.parametrize("basis_kind", ["dense", "mels80", "slaney"])
@pytest.mark.parametrize("kind", ["voiced", "silence", "loud"])
def test_log_mel_kernel_takes_any_basis(cuda, basis_kind, kind):
    """A dense random basis (many shared-memory pieces), 80 rows, the
    Slaney-scale filters: the same kernel, from the basis's packed form."""
    from obs_rvc_tpu_torch.dsp.mel import mel_filterbank

    rng = np.random.default_rng(7)
    basis = {"dense": np.abs(rng.standard_normal((128, 513))).astype(np.float32) / 64,
             "mels80": mel_filterbank(16000, 1024, 80, 40.0, 7600.0),
             "slaney": mel_filterbank(16000, 1024, 128, 30.0, 8000.0, htk=False)}[basis_kind]
    basis = torch.from_numpy(basis).to(cuda)
    L = 10080
    x = {"voiced": _voiced_16k(L), "silence": np.zeros(L, np.float32), "loud": 1e3 * _voiced_16k(L)}[kind]
    sig = torch.from_numpy(x).to(cuda)
    win = MelSpectrogram(device=cuda).window
    got = stft_mel.log_mel(sig, stft_mel.pack_mel_basis(basis), win)
    want = stft_mel.log_mel_plain(sig, basis, win)
    torch.cuda.synchronize()
    assert got.shape == (basis.shape[0], 64)
    if kind == "silence":
        torch.testing.assert_close(got, torch.full_like(got, float(np.log(1e-5))), atol=1e-5, rtol=0)
    _close(got, want, *BOUNDS["mel"])


@pytest.mark.parametrize("L,kind", [
    (10080, "voiced"),   # T=64, the FCPE path's shape
    (10080, "silence"),
    (10080, "loud"),
    (9920, "voiced"),    # T=63, ragged
    (10400, "normal"),   # T=66
    (100, "normal"),     # T=1
])
def test_log_mel_kernel_on_the_fcpe_basis(cuda, L, kind):
    """FCPE's frontend: the Slaney scale with fmin 0, whose first triangle
    starts at bin 0 (RMVPE's HTK basis starts at 30 Hz), through the same
    kernel from ``MelSpectrogram``'s packed basis."""
    rng = np.random.default_rng(L + 1)
    x = {"normal": rng.standard_normal(L).astype(np.float32), "voiced": _voiced_16k(L),
         "silence": np.zeros(L, np.float32), "loud": 1e3 * _voiced_16k(L)}[kind]
    sig = torch.from_numpy(x).to(cuda)
    mel = MelSpectrogram(f_min=0.0, htk=False, device=cuda)
    assert float(mel.mel_basis[0, 0]) == 0.0 and float(mel.mel_basis[0, 1]) > 0.0
    before = stft_mel.LAUNCHES
    got = mel(sig)
    assert stft_mel.LAUNCHES == before + 1
    want = stft_mel.log_mel_plain(sig, mel.mel_basis, mel.window)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (128, 1 + L // 160)
    if kind == "silence":
        torch.testing.assert_close(got, torch.full_like(got, float(np.log(1e-5))), atol=1e-5, rtol=0)
    _close(got, want, *BOUNDS["mel"])


def test_log_mel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    mel = MelSpectrogram(device=cuda)
    basis, win = mel.log_mel_basis, mel.window
    x = torch.zeros(2 * 10080, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mel.log_mel(x[::2], basis, win)
    with pytest.raises(ValueError, match="dtype"):
        stft_mel.log_mel(torch.zeros(10080, dtype=torch.float64, device=cuda), basis, win)
    with pytest.raises(NotImplementedError, match="1024"):
        stft_mel.log_mel(x, torch.zeros(128, 257, device=cuda), torch.ones(512, device=cuda))
    with pytest.raises(ValueError, match="pack_mel_basis"):  # on a card the kernel takes only the packed basis
        stft_mel.log_mel(x[:10080], mel.mel_basis, win)
    # the CPU takes the plain version, whatever the layout or type
    cpu = MelSpectrogram(device="cpu")
    assert stft_mel.log_mel(torch.zeros(20160, dtype=torch.float64)[::2], cpu.mel_basis,
                            cpu.window).shape == (128, 64)


# --- the compiled step: CUDA graphs of the whole step and of each stage ---

#: reduced widths that keep every hand kernel on the path, the CPU tests' (tests/test_torch_port_pipeline.py):
#: RMVPE levels of 8, 16 and 32 channels (the chain), generator levels of 64, 32, 16 and 8 (the bank)
GRAPH_WIDTHS = dict(
    contentvec=dict(dim=64, num_layers=2, tap_layer=2, num_heads=4, ffn_dim=128, out_dim=64),
    rmvpe=dict(en_de_layers=3, inter_layers=1, n_blocks=2, en_out_channels=8, gru_hidden=32),
    synth=dict(feature_dim=64, inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=2,
               upsample_initial_channel=128, gin_channels=16, spk_embed_dim=4))


@pytest.fixture
def deterministic_cudnn():
    """cuDNN picks float32 convolution algorithms whose sums are not bitwise
    repeatable run to run (the eager float32 step run twice differs by ~6e-5
    of max|audio| at full width); held to its deterministic ones, the graphs
    must equal the eager step bit for bit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


def _graph_pipe(device, dtype=torch.float32, seed=0, pitch_algorithm="rmvpe", retrieval_index=None,
                pallas_resblocks=None, rmvpe=None):
    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
    from obs_rvc_tpu_torch.models.crepe import CrepeConfig
    from obs_rvc_tpu_torch.models.fcpe import FcpeConfig
    from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
    from obs_rvc_tpu_torch.stream import RvcPipeline

    pipe = RvcPipeline(ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50),
                       contentvec_cfg=ContentVecConfig(**GRAPH_WIDTHS["contentvec"]),
                       rmvpe_cfg=RMVPEConfig(**{**GRAPH_WIDTHS["rmvpe"], **(rmvpe or {})}),
                       synth_cfg=SynthesizerConfig(**GRAPH_WIDTHS["synth"]), device=device, compute_dtype=dtype,
                       pitch_algorithm=pitch_algorithm, crepe_cfg=CrepeConfig("tiny"),
                       fcpe_cfg=FcpeConfig(hidden=64, n_layers=2), retrieval_index=retrieval_index,
                       pallas_resblocks=pallas_resblocks)
    pipe.init_params(seed, std=None)
    if dtype == torch.bfloat16:
        cast_params_for_serving(pipe)
    return pipe


def _chunks(pipe, n, seed=0):
    cfg = pipe.cfg
    t = np.arange(n * cfg.sample_frame_size) / cfg.sample_rate
    x = 0.3 * np.sin(2 * np.pi * 180.0 * t) + 0.01 * np.random.default_rng(seed).standard_normal(t.size)
    wav = torch.from_numpy(x.astype(np.float32))
    return [wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size] for i in range(n)]


def _stream(step, pipe, chunks, controls):
    from obs_rvc_tpu_torch.stream import StepControls

    state, outs = pipe.new_state(), []
    for i, chunk in enumerate(chunks):
        st, mix = controls[min(i, len(controls) - 1)]
        state, out = step(state, chunk.to(pipe.device), StepControls.default(pitch_shift=st, rms_mix_rate=mix))
        outs.append(out)
    return torch.cat(outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_steps_equal_the_eager_step(cuda, deterministic_cudnn, dtype):
    """The graphs run the eager step's kernels in its order: bit for bit,
    with the controls changed mid-stream and no capture after the first."""
    pipe = _graph_pipe(cuda, dtype)
    chunks = _chunks(pipe, 6)
    controls = [(0.0, 1.0), (0.0, 1.0), (12.0, 1.0), (12.0, 0.5), (-5.0, 0.5)]
    want = _stream(pipe.step, pipe, chunks, controls)
    for step, holder in ((pipe.jit_step, pipe.jit_step), (pipe.staged_step, pipe.staged_graphs)):
        got = _stream(step, pipe, chunks, controls)
        assert torch.equal(got, want)
        captures = holder.captures
        assert torch.equal(_stream(step, pipe, chunks, controls[::-1]), _stream(pipe.step, pipe, chunks, controls[::-1]))
        assert holder.captures == captures


def test_the_kernels_at_reduced_widths_and_the_switch_off(cuda, deterministic_cudnn):
    """At the CPU tests' reduced widths (chain levels of 8, 16 and 32
    channels, bank levels of 64, 32, 16 and 8) every chain and bank level
    runs on the kernels: 6 and 4 wrapper calls a step. With
    ``pallas_resblocks=False`` none does (the log-mel kernel stays), the
    levels run on cuDNN, and the audio holds the kernel step's within 1e-3
    of max|audio| (float32, TF32 off)."""
    on, off = _graph_pipe(cuda), _graph_pipe(cuda, pallas_resblocks=False)
    chunks = _chunks(on, 5)
    controls = [(0.0, 1.0), (12.0, 0.5)]
    audio, launches = {}, {}
    for name, pipe in (("on", on), ("off", off)):
        before = (stft_mel.LAUNCHES, unet_block.LAUNCHES, resblock.LAUNCHES)
        audio[name] = _stream(pipe.step, pipe, chunks, controls)
        launches[name] = (stft_mel.LAUNCHES - before[0], unet_block.LAUNCHES - before[1],
                          resblock.LAUNCHES - before[2])
    assert launches == {"on": (5, 30, 20), "off": (5, 0, 0)}
    want = audio["on"]
    assert torch.isfinite(want).all() and float(want.abs().max()) > 1e-3
    assert float((audio["off"] - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert torch.equal(_stream(off.jit_step, off, chunks, controls), audio["off"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_unet_level_on_the_chain_kernel_at_reduced_widths(cuda, deterministic_cudnn, dtype):
    """``pallas_unet_max_ch=64`` on a four-level RMVPE (levels of 8, 16, 32
    and 64 channels, the decoder's C=64 level reading 128): all 8 encoder
    and decoder levels on the chain kernel, the C=64 ones on its ring
    kernel, 8 wrapper calls a step; the eager step repeats and ``jit_step``
    equals it bit for bit; in float32 the audio holds the default
    ``max_ch=32`` step's (6 calls a step) within 1e-3 of max|audio|."""
    wide = dict(en_de_layers=4, pallas_unet_max_ch=64)
    pipe = _graph_pipe(cuda, dtype, rmvpe=wide)
    chunks = _chunks(pipe, 5)
    controls = [(0.0, 1.0), (12.0, 0.5)]
    before = unet_block.LAUNCHES
    want = _stream(pipe.step, pipe, chunks, controls)
    assert unet_block.LAUNCHES - before == 8 * len(chunks)
    assert torch.isfinite(want).all() and float(want.abs().max()) > 1e-3
    assert torch.equal(_stream(pipe.step, pipe, chunks, controls), want)
    assert torch.equal(_stream(pipe.jit_step, pipe, chunks, controls), want)
    if dtype == torch.float32:
        narrow = _graph_pipe(cuda, dtype, rmvpe=dict(en_de_layers=4))
        before = unet_block.LAUNCHES
        other = _stream(narrow.step, narrow, chunks, controls)
        assert unet_block.LAUNCHES - before == 6 * len(chunks)
        assert float((other - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_one_row_cumsum_takes_the_batched_rows_bits(cuda):
    """A one-stream scan on a card runs as PyTorch's row-by-row kernel: the
    bits of that stream's row in a batched scan, at every call."""
    from obs_rvc_tpu_torch.dsp.scan import cumsum_rows

    x = torch.rand(3, 140_000, generator=torch.Generator().manual_seed(0)).to(cuda)
    want = torch.cumsum(x, dim=1)[0]
    for _ in range(20):
        assert torch.equal(cumsum_rows(x[:1], dim=1)[0], want)
        assert torch.equal(cumsum_rows(x[0], dim=-1), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_pipeline_on_a_card_repeats_its_eager_step_bit_for_bit(cuda, dtype):
    """Building a pipeline on a card holds cuDNN to its deterministic
    engines, so the eager step gives the same bits at every run."""
    torch.backends.cudnn.deterministic = False
    pipe = _graph_pipe(cuda, dtype)
    assert torch.backends.cudnn.deterministic
    chunks = _chunks(pipe, 4)
    controls = [(0.0, 1.0), (12.0, 0.5)]
    assert torch.equal(_stream(pipe.step, pipe, chunks, controls), _stream(pipe.step, pipe, chunks, controls))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("algo", ["crepe", "fcpe"])
def test_pitch_graphed_steps_equal_the_eager_step(cuda, deterministic_cudnn, algo, dtype):
    """The CREPE and FCPE steps: both graphs bit for bit against the eager
    step, the controls changed mid-stream; FCPE's step launches the log-mel
    kernel (on its Slaney basis), neither launches the U-Net chain."""
    pipe = _graph_pipe(cuda, dtype, pitch_algorithm=algo)
    chunks = _chunks(pipe, 5)
    controls = [(0.0, 1.0), (0.0, 1.0), (12.0, 0.5), (-5.0, 0.5)]
    before = (stft_mel.LAUNCHES, unet_block.LAUNCHES, resblock.LAUNCHES)
    want = _stream(pipe.step, pipe, chunks, controls)
    launched = (stft_mel.LAUNCHES - before[0], unet_block.LAUNCHES - before[1], resblock.LAUNCHES - before[2])
    assert launched[:2] == ((5, 0) if algo == "fcpe" else (0, 0)) and launched[2] > 0
    assert torch.isfinite(want).all() and float(want.abs().max()) > 1e-3
    for step, holder in ((pipe.jit_step, pipe.jit_step), (pipe.staged_step, pipe.staged_graphs)):
        assert torch.equal(_stream(step, pipe, chunks, controls), want)
        captures = holder.captures
        assert torch.equal(_stream(step, pipe, chunks, controls[::-1]), _stream(pipe.step, pipe, chunks, controls[::-1]))
        assert holder.captures == captures


def test_fcpe_depthwise_conv_in_bf16_on_cudnn_is_within_the_rounding_budget(cuda):
    """FCPE's depthwise conv (k31, a channel a group) runs through
    ``conv_rounded`` on every device; cuDNN's own bf16 depthwise conv on the
    card is held here to the bf16 budget against float32 (its error at most
    twice ``conv_rounded``'s plus 1e-4 of max|float32|), the evidence for a
    card-only route."""
    import torch.nn.functional as F

    from obs_rvc_tpu_torch.ops import conv_rounded

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 1024, 64, generator=gen).to(cuda)
    w = (torch.randn(1024, 1, 31, generator=gen) / np.sqrt(31)).to(cuda)
    b = (0.1 * torch.randn(1024, generator=gen)).to(cuda)
    bf = torch.bfloat16
    want = F.conv1d(x.to(bf).float(), w.to(bf).float(), b.to(bf).float(), padding=15, groups=1024)
    rounded = conv_rounded(F.conv1d, x.to(bf), w, b, padding=15, groups=1024)
    cudnn = F.conv1d(x.to(bf), w.to(bf), b.to(bf), padding=15, groups=1024)
    scale = float(want.abs().max())
    e_rounded = float((rounded.float() - want).abs().max()) / scale
    e_cudnn = float((cudnn.float() - want).abs().max()) / scale
    assert rounded.dtype == cudnn.dtype == bf and e_rounded > 0
    assert e_cudnn <= 2 * e_rounded + 1e-4, (e_cudnn, e_rounded)


def test_graphed_sessions_replay_from_two_threads(cuda, deterministic_cudnn):
    """Two sessions per mode over one pipeline, stepping at once on two
    threads, each equal to its run alone."""
    import threading

    from obs_rvc_tpu_torch.stream import StepControls, StreamSession

    pipe = _graph_pipe(cuda)
    chunk = pipe.cfg.sample_frame_size
    signals = [torch.cat(_chunks(pipe, 5, seed=s)).numpy() for s in (1, 2)]

    def run(session, wav, out):
        with torch.no_grad():
            for i in range(0, wav.size, chunk):
                session.push_audio(wav[i : i + chunk])
                session.process_pending()
                out.append(session.pull_audio(chunk))

    for mode in ("staged", "fused"):
        alone = []
        for wav in signals:
            out = []
            run(StreamSession(pipe, StepControls.default(pitch_shift=2.0), mode=mode), wav, out)
            alone.append(np.concatenate(out))
        outs = [[], []]
        sessions = [StreamSession(pipe, StepControls.default(pitch_shift=2.0), mode=mode) for _ in signals]
        for s in sessions:
            s.prepare()
        threads = [threading.Thread(target=run, args=(s, w, o)) for s, w, o in zip(sessions, signals, outs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for a, o in zip(alone, outs):
            np.testing.assert_array_equal(np.concatenate(o), a)


def test_graphs_are_captured_again_after_a_weight_reload(cuda, deterministic_cudnn):
    pipe = _graph_pipe(cuda)
    chunks = _chunks(pipe, 2)
    controls = [(3.0, 0.5)]
    before = _stream(pipe.jit_step, pipe, chunks, controls)
    _stream(pipe.staged_step, pipe, chunks, controls)
    captures = pipe.jit_step.captures, pipe.staged_graphs.captures
    pipe.init_params(seed=1, std=None)  # load_state_dict: in place, the versions bumped
    want = _stream(pipe.step, pipe, chunks, controls)
    assert not torch.equal(want, before)
    assert torch.equal(_stream(pipe.jit_step, pipe, chunks, controls), want)
    assert torch.equal(_stream(pipe.staged_step, pipe, chunks, controls), want)
    assert (pipe.jit_step.captures, pipe.staged_graphs.captures) == (captures[0] + 1, captures[1] + 7)


def test_a_weight_change_between_two_staged_steps_recaptures_and_the_next_chunk_is_the_eager_steps(
        cuda, deterministic_cudnn):
    """The weights check before each staged step: a reload, then a raw write
    to one parameter, each between two chunks of one stream; the staged step
    captures its seven graphs again, and its next chunk equals an eager
    step's bit for bit."""
    from obs_rvc_tpu_torch.serve import metrics
    from obs_rvc_tpu_torch.stream import StepControls

    pipe = _graph_pipe(cuda)
    chunks = [c.to(cuda) for c in _chunks(pipe, 3)]
    controls = StepControls.default(pitch_shift=3.0, rms_mix_rate=0.5)
    metrics.reset()
    with torch.no_grad():
        eager, graphed = pipe.new_state(), pipe.new_state()
        eager, want = pipe.step(eager, chunks[0], controls)
        graphed, got = pipe.staged_step(graphed, chunks[0], controls)
        assert torch.equal(got, want)
        changes = (lambda: pipe.init_params(seed=1, std=None), lambda: next(pipe.synthesizer.parameters()).mul_(1.5))
        for chunk, change in zip(chunks[1:], changes):
            captures = pipe.staged_graphs.captures
            change()
            eager, want = pipe.step(eager, chunk, controls)
            graphed, got = pipe.staged_step(graphed, chunk, controls)
            assert pipe.staged_graphs.captures == captures + 7
            assert torch.equal(got, want)
    assert metrics.process_counter("weights.changes") == 2


def test_the_weights_check_at_rvc_v2_40k_with_rmvpe_prints_its_host_cost(cuda):
    """The weights check's host time a call over RVC v2 40k's networks with
    ContentVec and RMVPE at published widths, beside the Python tuple of every
    tensor it replaces: printed, not asserted (run with ``-s``)."""
    import itertools
    import time

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.stream import RvcPipeline
    from obs_rvc_tpu_torch.stream.graphs import WeightsVersion

    pipe = RvcPipeline(ChunkConfig.build(model_sample_rate=40000), device=cuda, compute_dtype=torch.bfloat16)
    version = WeightsVersion(pipe._weight_modules)
    key = version.key()
    tensors = [t for m in pipe._weight_modules() for t in itertools.chain(m.parameters(), m.buffers())]
    assert version.tensors == len(tensors)

    def per_call_us(fn, n=200):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best

    native = per_call_us(version.key)
    python = per_call_us(lambda: tuple((t.data_ptr(), t._version) for t in tensors))
    assert version.key() == key
    parts = ", ".join(f"{name} {sum(1 for _ in itertools.chain(m.parameters(), m.buffers()))}"
                      for name, m in pipe.modules().items())
    print(f"\nthe weights check over {len(tensors)} tensors ({parts}): WeightsVersion.key() {native:.1f} us a call, "
          f"the Python tuple {python:.1f} us (best of 5 x 200 calls)")


def test_stage_events_time_the_staged_step_without_a_synchronize(cuda, monkeypatch):
    """Events at every stage boundary call ``torch.cuda.synchronize`` no more
    often than a step without them, and give each stage's device ms and the
    waits between stages once the step's output is read."""
    from obs_rvc_tpu_torch.serve import metrics
    from obs_rvc_tpu_torch.stream import StepControls, pipeline

    pipe = _graph_pipe(cuda)
    chunks = [c.to(cuda) for c in _chunks(pipe, 3)]
    state, controls = pipe.new_state(), StepControls.default()
    pipe.staged_step(state, chunks[0], controls)  # the capture
    calls = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (calls.append(1), sync(*a, **k))[1])

    def synchronizes(**kw):
        calls.clear()
        for c in chunks:
            pipe.staged_step(state, c, controls, **kw)[1].cpu()
        return len(calls)

    metrics.reset()
    timed = synchronizes(timed=True)
    times = {}
    with_dict = synchronizes(stage_times=times)
    with monkeypatch.context() as m:
        m.setattr(pipeline, "stage_clock", lambda *a, **k: None)
        untimed = synchronizes()
    assert timed <= untimed and with_dict <= untimed
    assert set(times) == {"pre", "features", "mel", "salience", "pitch_post", "synth", "post"}
    assert all(v > 0 for v in times.values())
    pipeline.resolve_stages()
    snap = metrics.process_snapshot()["spans"]
    assert all(snap[f"stage.{s}"]["count"] >= 2 * len(chunks) for s in times)
    assert snap["stage_gap"]["count"] >= 2 * len(chunks) and snap["stage_gap"]["p50_ms"] >= 0


CREPE_SPANS = tuple(f"crepe.conv{i}" for i in range(1, 7)) + ("crepe.head",)


def test_crepe_marks_time_its_blocks_inside_the_salience_graph(cuda, monkeypatch):
    """The ``salience`` graph's capture bakes in CREPE's eight events; after
    a timed replay its seven spans are positive and sum to no more than the
    stage's own time. A timed step's spans are read at the graph's next
    launch (or at once with ``stage_times``), an untimed step's never."""
    from obs_rvc_tpu_torch.serve import metrics
    from obs_rvc_tpu_torch.stream import StepControls, pipeline

    pipe = _graph_pipe(cuda, torch.bfloat16, pitch_algorithm="crepe")
    chunks = [c.to(cuda) for c in _chunks(pipe, 4)]
    state, controls = pipe.new_state(), StepControls.default()
    metrics.reset()
    launches = crepe_conv.LAUNCHES
    with monkeypatch.context() as m:
        m.setattr(pipeline, "stage_clock", lambda *a, **k: None)
        for c in chunks:  # the first captures
            pipe.staged_step(state, c, controls)[1].cpu()
    assert crepe_conv.LAUNCHES > launches  # tiny's conv1 block runs on the conv kernel, between the marks
    inner = pipe.staged_graphs.graphs["salience"].inner
    assert [name for name, _ in inner.points] == ["crepe", *CREPE_SPANS]
    assert all(g.inner is None for name, g in pipe.staged_graphs.graphs.items() if name != "salience")
    assert not any(n.startswith("crepe") for n in metrics.process_snapshot()["spans"])
    times = {}
    pipe.staged_step(state, chunks[1], controls, stage_times=times)
    spans = {n: metrics.process_samples(n) for n in CREPE_SPANS}
    assert all(len(v) == 1 and v[0] > 0 for v in spans.values()), spans
    assert sum(v[0] for v in spans.values()) <= times["salience"], (spans, times)
    pipe.staged_step(state, chunks[2], controls, timed=True)[1].cpu()
    assert len(metrics.process_samples("crepe.head")) == 1  # held until the graph's next launch
    pipe.staged_step(state, chunks[3], controls)[1].cpu()
    assert all(len(metrics.process_samples(n)) == 2 for n in CREPE_SPANS)


# --- CREPE's conv kernel (ops/crepe_conv.py): conv1 and conv2 with their ReLU, BatchNorm and pool ---

#: the kernel's error off the float32 block of the same bfloat16 operands, against cuDNN bf16's: e <= 2 e_cudnn + tol
CREPE_CONV_TOL = 1e-3


def _crepe(capacity, device, dtype=torch.bfloat16, seed=0):
    """CREPE on ``device`` in ``dtype`` (eval): fan-in weights, each conv's bias and norm drawn too (norm weights of
    either sign), so every term of the kernel's epilogue counts."""
    from obs_rvc_tpu_torch.models.crepe import Crepe, CrepeConfig

    gen = torch.Generator().manual_seed(seed)
    model = Crepe(CrepeConfig(capacity)).eval()
    with torch.no_grad():
        for i in range(1, 7):
            conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
            C = conv.out_channels
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / (conv.in_channels * conv.kernel_size[0]) ** 0.5)
            conv.bias.copy_(torch.randn(C, generator=gen) * 0.1)
            bn.weight.copy_(torch.randn(C, generator=gen))
            bn.bias.copy_(torch.randn(C, generator=gen) * 0.1)
            bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(C, generator=gen) * 1.5 + 0.5)
    return model.to(device, dtype)


def _crepe_frames(N, device, seed=0):
    """``N`` normalised frames of a gliding tone in noise, bfloat16."""
    from obs_rvc_tpu_torch.models.crepe import extract_crepe_frames

    t = torch.arange(160 * (N - 1) + 1) / 16000.0
    x = 0.3 * torch.sin(2 * torch.pi * torch.cumsum(190.0 * 2 ** torch.sin(2 * torch.pi * 0.7 * t), 0) / 16000.0)
    x = x + 0.02 * torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))
    return extract_crepe_frames(x[None].to(device), N)[0].to(torch.bfloat16).contiguous()


def _crepe_block(model, block, N, device):
    """Block ``block`` (1 or 2) at ``N`` frames: ``(kernel call, cuDNN's bf16 block as the module computes it,
    the float32 block of the same bf16 operands, the kernel's output as [N, C, L])``. conv2's input is conv1's
    plain block."""
    import torch.nn.functional as F

    from obs_rvc_tpu_torch.models.crepe import _PADS

    frames = _crepe_frames(N, device, seed=N)
    if block == 1:
        x, x_ncl, kind = frames, frames[:, None], "frames"
    else:
        x = crepe_conv.block_frames_plain(frames, crepe_conv.fold(model.conv1, model.conv1_BN))
        x_ncl, kind = crepe_conv.from_blocked(x), "taps"
    conv, bn = getattr(model, f"conv{block}"), getattr(model, f"conv{block}_BN")
    folded = crepe_conv.fold(conv, bn)
    packed = crepe_conv.pack(folded, kind)
    call = crepe_conv.block_frames if block == 1 else crepe_conv.block_taps
    with torch.no_grad():
        cudnn = F.max_pool1d(bn(F.relu(conv(F.pad(x_ncl, _PADS[block - 1])[..., None])[..., 0])), 2, 2)
        y = F.conv1d(F.pad(x_ncl.float(), _PADS[block - 1]), folded.w, stride=conv.stride[0])
        ref = F.max_pool1d(torch.relu(y + folded.bias[:, None]) * folded.scale[:, None] + folded.shift[:, None], 2, 2)
    as_ncl = crepe_conv.from_blocked if block == 1 else (lambda t: t)
    return (lambda: call(x, packed)), cudnn, ref, as_ncl


@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("block", [1, 2])
def test_crepe_conv_kernel_against_the_float32_block(cuda, deterministic_cudnn, block, N):
    """``full``'s conv1 and conv2 blocks at one stream's 64 frames and two streams' 128 (conv2 splits K in 4 and
    2 parts): off the float32 block of the same bf16 operands by at most ``2 e_cudnn + tol``, cuDNN's bf16 block
    the yardstick; two launches bit for bit (a fixed-order sum of the split parts, no atomics); one launch
    counted a call."""
    model = _crepe("full", cuda)
    call, cudnn, ref, as_ncl = _crepe_block(model, block, N, cuda)
    before = crepe_conv.LAUNCHES
    with torch.no_grad():
        got, again = call(), call()
    torch.cuda.synchronize()
    assert crepe_conv.LAUNCHES == before + 2
    assert torch.equal(got, again)
    got = as_ncl(got).float()
    assert torch.isfinite(got).all() and got.shape == ref.shape
    scale = float(ref.abs().max())
    e_k, e_c = float((got - ref).abs().max()) / scale, float((cudnn.float() - ref).abs().max()) / scale
    assert e_k <= 2 * e_c + CREPE_CONV_TOL, (e_k, e_c)


@pytest.mark.parametrize("N", [1, 65, 301])
def test_crepe_conv_kernel_at_odd_and_offline_frame_counts(cuda, deterministic_cudnn, N):
    """conv2 at one frame (K in 16 parts), an odd count (the last block's second frame absent) and an offline
    clip's 301 frames (no split: the epilogue in the GEMM kernel), by the same rule."""
    model = _crepe("full", cuda, seed=1)
    call, cudnn, ref, as_ncl = _crepe_block(model, 2, N, cuda)
    with torch.no_grad():
        got = as_ncl(call()).float()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    e_k, e_c = float((got - ref).abs().max()) / scale, float((cudnn.float() - ref).abs().max()) / scale
    assert e_k <= 2 * e_c + CREPE_CONV_TOL, (N, e_k, e_c)


def test_crepe_conv_kernel_inside_a_cuda_graph(cuda):
    """Both blocks captured in one CUDA graph: each replay equals the eager launches bit for bit."""
    model = _crepe("full", cuda, seed=2)
    call1, _, _, _ = _crepe_block(model, 1, 64, cuda)
    call2, _, _, _ = _crepe_block(model, 2, 64, cuda)
    with torch.no_grad():
        want1, want2 = call1(), call2()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call1(), call2()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got1, got2 = call1(), call2()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got1, want1) and torch.equal(got2, want2)


def test_crepe_packs_follow_a_weight_reload(cuda, deterministic_cudnn):
    """The network folds and packs its kernel blocks once per weight version: a ``load_state_dict`` (which
    ``WeightsVersion`` sees) packs again, and the forward equals a fresh network's on the new weights."""
    from obs_rvc_tpu_torch.stream.graphs import WeightsVersion

    model = _crepe("full", cuda, seed=3)
    version = WeightsVersion(lambda: [model])
    frames = _crepe_frames(8, cuda)
    with torch.no_grad():
        model(frames)
        key0, packs0 = version.key(), {i: e[2].w.data_ptr() for i, e in model._kernel_params.items()}
        model(frames)
        assert version.key() == key0 and {i: e[2].w.data_ptr() for i, e in model._kernel_params.items()} == packs0
        new = _crepe("full", cuda, seed=4)
        model.load_state_dict(new.state_dict())
        assert version.key() != key0
        got = model(frames)
        want = new(frames)
    assert sorted(model._kernel_params) == [0, 1]
    assert all(e[2].w.data_ptr() != packs0[i] for i, e in model._kernel_params.items())
    assert torch.equal(got, want)


def test_crepe_bf16_salience_through_the_kernel_against_cudnns(cuda, deterministic_cudnn, monkeypatch):
    """``full`` in bfloat16 with conv1 and conv2 on the kernel (two launches a forward) against the same network
    with every block on cuDNN, both held to the float32 network on the same bf16 weights (TF32 off):
    ``e <= 2 e_cudnn + 2e-4``, the salience's budget in ``test_torch_port_bf16.py``."""
    model = _crepe("full", cuda, seed=5)
    ref_model = _crepe("full", cuda, seed=5)
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.float()
    frames = _crepe_frames(64, cuda, seed=6)
    with torch.no_grad():
        before = crepe_conv.LAUNCHES
        got = model(frames)
        assert crepe_conv.LAUNCHES == before + 2
        with monkeypatch.context() as m:
            m.setattr(crepe_conv, "takes_kernel", lambda *a: "")
            on_cudnn = model(frames)
        want = ref_model(frames.float())
    scale = float(want.abs().max())
    e_k, e_c = float((got - want).abs().max()) / scale, float((on_cudnn - want).abs().max()) / scale
    assert e_k <= 2 * e_c + 2e-4, (e_k, e_c)


def test_float32_crepe_stays_on_cudnn(cuda):
    model = _crepe("full", cuda, dtype=torch.float32, seed=7)
    before = crepe_conv.LAUNCHES
    with torch.no_grad():
        out = model(_crepe_frames(4, cuda).float())
    assert crepe_conv.LAUNCHES == before and model._kernel_params == {} and out.dtype == torch.float32


def test_spans_leave_no_device_event_in_a_trace(cuda):
    from torch.profiler import ProfilerActivity, profile

    from obs_rvc_tpu_torch.stream import StepControls, StreamSession

    pipe = _graph_pipe(cuda)
    sess = StreamSession(pipe, StepControls.default(), mode="staged")
    sess.prepare()
    chunk = torch.cat(_chunks(pipe, 1)).numpy()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, torch.no_grad():
        for _ in range(3):
            sess.push_audio(chunk)
            sess.process_pending()
        torch.cuda.synchronize()
    ours = [e for e in prof.events() if e.name.startswith(("session.", "stage", "pool."))]
    assert {e.name for e in ours} >= {"session.chunk", "session.enqueue", "session.wait"}
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def test_a_weight_reload_while_serving_counts_serving_captures(cuda, deterministic_cudnn):
    from obs_rvc_tpu_torch.serve import metrics
    from obs_rvc_tpu_torch.stream import StepControls, StreamSession

    metrics.reset()
    pipe = _graph_pipe(cuda)
    sess = StreamSession(pipe, StepControls.default(), mode="staged")
    sess.prepare()
    chunks = [c.numpy() for c in _chunks(pipe, 3)]

    def serve(cs):
        with torch.no_grad():
            for c in cs:
                sess.push_audio(c)
                assert sess.process_pending() == 1

    serve(chunks[:2])
    assert (metrics.process_counter("captures"), metrics.process_counter("serving_captures")) == (7, 0)
    pipe.init_params(seed=1, std=None)
    serve(chunks[2:])
    assert (metrics.process_counter("captures"), metrics.process_counter("serving_captures")) == (14, 7)
    counters = sess.metrics.snapshot().counters
    assert (counters["captures"], counters["serving_captures"]) == (14, 7)
    assert counters["graph.replays"] == 7 * 4  # prepare's step of silence, then the three chunks


def test_a_capture_that_fails_raises(cuda):
    """A function the card cannot capture (it reads a value on the host)
    raises; nothing runs it eagerly instead."""
    from obs_rvc_tpu_torch.stream.graphs import GraphedFunction

    graphed = GraphedFunction(lambda x: x * float(x.sum()), (torch.ones(3, device=cuda),), device=cuda,
                              name="host_read")
    with pytest.raises(RuntimeError, match="capture of host_read failed"):
        graphed(torch.ones(3, device=cuda))
    assert graphed.captures == 0
    torch.cuda.synchronize()
    # the card goes on working, and a capturable function captures
    ok = GraphedFunction(lambda x: x * 2.0, (torch.ones(3, device=cuda),), device=cuda, name="double")
    torch.testing.assert_close(ok(torch.arange(3.0, device=cuda)), torch.tensor([0.0, 2.0, 4.0], device=cuda))
    assert ok.captures == 1


# --- the batched step and the pool ---

@pytest.mark.parametrize("B,L,kind", [
    (1, 10080, "voiced"),   # the one-stream step's window as a batch of one
    (3, 10080, "mixed"),    # voiced, normal and silent streams in one launch
    (3, 9920, "mixed"),     # T=63, ragged
    (3, 100, "normal"),     # T=1
    (3, 10080, "silence"),
])
def test_log_mel_kernel_takes_a_stream_axis(cuda, B, L, kind):
    """One launch for ``B`` streams, each row the kernel's one-stream result
    bit for bit and the plain version's within the log-mel bound; rows may
    lie a stride apart."""
    rng = np.random.default_rng(L + B)
    rows = {"voiced": [_voiced_16k(L, seed=b) for b in range(B)],
            "normal": [rng.standard_normal(L).astype(np.float32) for _ in range(B)],
            "silence": [np.zeros(L, np.float32)] * B,
            "mixed": [_voiced_16k(L), rng.standard_normal(L).astype(np.float32), np.zeros(L, np.float32)]}[kind]
    sig = torch.from_numpy(np.stack(rows)).to(cuda)
    mel = MelSpectrogram(device=cuda)
    before = stft_mel.LAUNCHES
    got = stft_mel.log_mel(sig, mel.log_mel_basis, mel.window)
    assert stft_mel.LAUNCHES == before + 1
    want = stft_mel.log_mel_plain(sig, mel.mel_basis, mel.window)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, 128, 1 + L // 160)
    _close(got, want, *BOUNDS["mel"])
    for b in range(B):
        assert torch.equal(got[b], stft_mel.log_mel(sig[b], mel.log_mel_basis, mel.window))
    # the step's windows are the tails of its rings: rows a stride apart
    wide = torch.cat([torch.ones(B, 37, device=cuda), sig], dim=1)
    assert torch.equal(stft_mel.log_mel(wide[:, 37:], mel.log_mel_basis, mel.window), got)
    if kind == "silence":
        torch.testing.assert_close(got, torch.full_like(got, float(np.log(1e-5))), atol=1e-5, rtol=0)


def _batch_inputs(pipe, n, controls):
    from obs_rvc_tpu_torch.stream import StepControls

    chunks = torch.stack([torch.stack(_chunks(pipe, n, seed=s)) for s in range(len(controls))], dim=1)
    return chunks.to(pipe.device), StepControls.stack([StepControls.default(**c) for c in controls], pipe.device)


def _stream_batch(step, pipe, chunks, controls):
    from obs_rvc_tpu_torch.stream import StreamState

    state, outs = StreamState.init_batch(pipe.cfg, chunks.shape[1], device=pipe.device), []
    for chunk in chunks:
        state, out = step(state, chunk, controls)
        outs.append(out)
    return torch.cat(outs, dim=1)


BATCH_CONTROLS = [dict(pitch_shift=0.0, rms_mix_rate=1.0, sid=0), dict(pitch_shift=7.0, rms_mix_rate=0.3, sid=2),
                  dict(pitch_shift=-4.5, rms_mix_rate=0.6, sid=3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_graphed_steps_equal_the_eager_batched_step(cuda, deterministic_cudnn, dtype):
    """Three streams with their own controls: ``jit_step_batch`` and the
    batched stage graphs against the eager batched step, which calls each
    kernel's wrapper as often as the one-stream step does. bfloat16 bit for
    bit; float32 within 1e-5 of max|audio|: cuBLAS computes the phone
    projection (a float32 ``Linear`` of [3, 15, 64]) in another order under
    capture than eagerly, 4.2e-7 apart (every other module of the
    synthesizer, and every module at one stream, bit for bit)."""
    from obs_rvc_tpu_torch.stream import StepControls

    pipe = _graph_pipe(cuda, dtype)
    chunks, controls = _batch_inputs(pipe, 4, BATCH_CONTROLS)
    counters = (stft_mel, unet_block, resblock)
    before = [m.LAUNCHES for m in counters]
    pipe.step(pipe.new_state(), chunks[0, 0], StepControls.default())
    single = [m.LAUNCHES - b for m, b in zip(counters, before)]
    before = [m.LAUNCHES for m in counters]
    want = _stream_batch(lambda s, c, k: pipe.step(s, c, k, batched=True), pipe, chunks, controls)
    assert [m.LAUNCHES - b for m, b in zip(counters, before)] == [4 * n for n in single]
    assert torch.isfinite(want).all() and (want.abs().amax(dim=1) > 1e-3).all()
    def same(got, want):
        if dtype == torch.bfloat16:
            return torch.equal(got, want)
        return float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    for step in (pipe.jit_step_batch, lambda s, c, k: pipe.staged_step(s, c, k, batched=True)):
        assert same(_stream_batch(step, pipe, chunks, controls), want)
    captures = pipe.batch_graph(3).captures
    assert same(_stream_batch(pipe.jit_step_batch, pipe, chunks.flip(0), controls),
                _stream_batch(lambda s, c, k: pipe.step(s, c, k, batched=True), pipe, chunks.flip(0), controls))
    assert pipe.batch_graph(3).captures == captures


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convert_scan_graph_equals_convert_offline(cuda, deterministic_cudnn, dtype):
    """``jit_convert_scan`` captures every chunk's step of a clip as one
    graph; on 4 chunks it equals ``convert_offline`` (a ``jit_step`` replay
    a chunk) bit for bit, and a second clip of the same count replays it."""
    from obs_rvc_tpu_torch.stream import StepControls

    pipe = _graph_pipe(cuda, dtype)
    controls = StepControls.default(pitch_shift=3.0, rms_mix_rate=0.5)
    for seed in (0, 1):
        wav = torch.cat(_chunks(pipe, 4, seed=seed)).to(cuda)
        want = pipe.convert_offline(wav, controls)
        got = pipe.jit_convert_scan(wav.reshape(4, -1), controls)
        assert got.shape == want.shape == (4 * pipe.cfg.sample_frame_size,)
        assert torch.isfinite(want).all() and float(want.abs().max()) > 1e-3
        assert torch.equal(got, want), float((got - want).abs().max())
    assert list(pipe._graphs["jit_convert_scan"]) == [4]
    assert pipe._graphs["jit_convert_scan"][4].captures == 1


def _pool_run(pipe, wavs, n, **pool_kw):
    """Three slots; slot 1 starves for two ticks mid-stream."""
    from obs_rvc_tpu_torch.stream import StreamPool

    chunk = pipe.cfg.sample_frame_size
    pool = StreamPool(pipe, capacity=3, **pool_kw)
    slots = [pool.attach() for _ in wavs]
    fed, ticks = [0] * len(wavs), 0
    while min(fed) < n:
        for k, s in enumerate(slots):
            if not (k == 1 and fed[1] == 2 and ticks in (2, 3)) and fed[k] < n:
                pool.push_audio(s, wavs[k][fed[k] * chunk : (fed[k] + 1) * chunk])
                fed[k] += 1
        ticks += 1
        pool.process_pending()
    pool.stop()
    assert pool.metrics.snapshot().errors == 0
    return [pool.pull_audio(s, n * chunk) for s in slots]


def test_pool_fused_tick_matches_staged(cuda, deterministic_cudnn):
    """A pool of three on the card in bfloat16, the server's dtype: the
    fused tick (one graph, the merge inside) and the staged one bit for bit,
    across a starved slot; pipelined ticks the same audio; the int16 wire
    within half an LSB of the fused pool fed the same int16-rounded input,
    clipped to int16's range (random weights reach |audio| > 1). (In float32
    the fused and staged ticks differ by 1.6e-6 of audio near 0.86: cuBLAS
    sums the phone projection in another order in the two captures, as in
    ``test_batched_graphed_steps_equal_the_eager_batched_step``.)"""
    pipe = _graph_pipe(cuda, torch.bfloat16)
    n = 5
    wavs = [torch.cat(_chunks(pipe, n, seed=s)).numpy() for s in range(3)]
    staged = _pool_run(pipe, wavs, n)
    fused = _pool_run(pipe, wavs, n, mode="fused")
    pipelined = _pool_run(pipe, wavs, n, mode="fused", pipelined=True)
    int16 = _pool_run(pipe, wavs, n, mode="fused", io_dtype="int16")
    rounded = _pool_run(pipe, [np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.float32) / 32768.0
                               for w in wavs], n, mode="fused")
    for k, (s, f, p, i, r) in enumerate(zip(staged, fused, pipelined, int16, rounded)):
        assert s.size == n * pipe.cfg.sample_frame_size and np.abs(s).max() > 1e-3
        # the int16 wire's output is the float32 wire's, clipped to int16's range and rounded
        clipped = np.clip(r, -1.0, 32767 / 32768)
        diffs = {name: float(np.abs(a - b).max()) for name, a, b in
                 (("fused-staged", f, s), ("pipelined-staged", p, s), ("int16-rounded", i, clipped))}
        assert diffs["fused-staged"] == diffs["pipelined-staged"] == 0.0, (k, diffs)
        assert diffs["int16-rounded"] <= 0.5 / 32768 + 1e-7, (k, diffs)


# --- retrieval ---

def _clustered_table(n, c, seed=0, nclust=32):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nclust, c)).astype(np.float32) * 2.0
    table = centers[rng.integers(0, nclust, n)] + 0.6 * rng.standard_t(4, (n, c)).astype(np.float32)
    walk = table[rng.integers(0, n, 3)][:, None, :] + np.cumsum(0.2 * rng.standard_normal((3, 12, c)), axis=1)
    return table.astype(np.float32), walk.astype(np.float32)


def _ivf_table(table, lcap, nlist=32, dtype=torch.float32):
    from obs_rvc_tpu_torch.retrieval import IvfFlatIndex, RetrievalIndex
    from obs_rvc_tpu_torch.retrieval.build import train_ivf

    cent, assign = train_ivf(table, nlist=nlist, iters=4, seed=0, device="cpu")
    return RetrievalIndex(mode="ivf").make_ivf_params(IvfFlatIndex(table, cent, assign), dtype=dtype, lcap=lcap)


@pytest.mark.parametrize("mode,dtype,lcap", [
    ("exact", torch.float32, None), ("exact", torch.bfloat16, None),
    ("ivf", torch.float32, 20),   # a slab length that is no multiple of 8
    ("ivf", torch.bfloat16, 64),
])
def test_retrieval_blend_on_the_card_matches_the_cpu(cuda, mode, dtype, lcap):
    """The blend of three streams on the card against the same function on
    the CPU, on the same table and queries: 1e-4 (TF32 off); scores are
    float32 whatever the table's dtype."""
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.retrieval.index import table_products

    table, walk = _clustered_table(3000, 64)
    if mode == "exact":
        params = RetrievalIndex.make_params(table, dtype=dtype)
    else:
        params = _ivf_table(table, lcap, dtype=dtype)
    card = RetrievalIndex(mode=mode, probes=8).load(params, cuda)
    cpu = RetrievalIndex(mode=mode, probes=8).load(params, "cpu")
    rate = torch.tensor([0.75, 0.3, 1.0])
    want = cpu.blend(torch.from_numpy(walk), rate)
    got = card.blend(torch.from_numpy(walk).to(cuda), rate.to(cuda))
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert table_products(torch.from_numpy(walk[0]).to(cuda), card.vectors).dtype == torch.float32


def test_ivf_search_with_k_above_the_unions_valid_rows(cuda):
    """Lists of 3 rows, one probed list, k=8: five of the eight are masked
    rows (weight 0). The blend is finite and equals the CPU's; the valid
    rows found are the CPU's."""
    from obs_rvc_tpu_torch.retrieval import IvfFlatIndex, RetrievalIndex
    from obs_rvc_tpu_torch.retrieval.index import ivf_search

    rng = np.random.default_rng(3)
    cent = rng.standard_normal((10, 16)).astype(np.float32) * 5.0
    table = np.repeat(cent, 3, axis=0) + 0.1 * rng.standard_normal((30, 16)).astype(np.float32)
    params = RetrievalIndex(mode="ivf").make_ivf_params(IvfFlatIndex(table, cent, np.repeat(np.arange(10), 3)))
    q = torch.from_numpy(cent[4:5] + 0.05 * rng.standard_normal((1, 16)).astype(np.float32))
    tables = {dev: [params[k].to(dev) for k in ("vectors", "norms", "lengths", "offsets", "centroids", "cnorms")]
              for dev in ("cpu", cuda)}
    (_, ws, wr), (_, gs, gr) = (ivf_search(*tables[d], q.to(d), k=8, probes=1, lcap=8) for d in ("cpu", cuda))
    valid = ws > -1e29
    assert int(valid.sum()) == 3
    assert torch.equal(gs.cpu() > -1e29, valid)
    assert set(gr.cpu()[valid].tolist()) == set(wr[valid].tolist())
    card = RetrievalIndex(mode="ivf", probes=1).load(params, cuda)
    cpu = RetrievalIndex(mode="ivf", probes=1).load(params, "cpu")
    got, want = card.blend(q[None].to(cuda), 1.0).cpu(), cpu.blend(q[None], 1.0)
    assert torch.isfinite(got).all() and float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_graphed_blend_equals_eager(cuda, mode):
    """The blend alone as a CUDA graph: nothing in it waits for the host,
    and its replays equal the eager blend bit for bit, whatever the rates."""
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.stream.graphs import GraphedFunction

    table, walk = _clustered_table(3000, 64, seed=1)
    params = RetrievalIndex.make_params(table) if mode == "exact" else _ivf_table(table, 24)
    idx = RetrievalIndex(mode=mode).load(params, cuda)
    phone, rate = torch.from_numpy(walk).to(cuda), torch.tensor([0.75, 0.3, 1.0], device=cuda)
    graphed = GraphedFunction(idx.blend, (phone, rate), device=cuda, name=f"blend_{mode}", weights=lambda: [idx])
    for r in (rate, rate.flip(0)):
        assert torch.equal(graphed(phone, r), idx.blend(phone, r))
    assert graphed.captures == 1


def test_loading_a_second_index_recaptures(cuda, deterministic_cudnn):
    """A graphed step reads the table it was captured over: loading another
    table into the pipeline's index captures jit_step again (once), and the
    step then blends with the new table, as the eager step does."""
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.stream import StepControls

    idx = RetrievalIndex()
    pipe = _graph_pipe(cuda, retrieval_index=idx)
    first, _ = _clustered_table(2048, 64, seed=2)
    second, _ = _clustered_table(4096, 64, seed=3)
    idx.load(RetrievalIndex.make_params(first), cuda)
    chunks = _chunks(pipe, 3)

    def run(step):
        state, outs = pipe.new_state(), []
        for chunk in chunks:
            state, out = step(state, chunk.to(cuda), StepControls.default(index_rate=0.75))
            outs.append(out)
        return torch.cat(outs)

    before = run(pipe.jit_step)
    assert torch.equal(before, run(pipe.step))
    captures = pipe.jit_step.captures
    idx.load(RetrievalIndex.make_params(second), cuda)
    want = run(pipe.step)
    assert torch.equal(run(pipe.jit_step), want)
    assert pipe.jit_step.captures == captures + 1
    assert not torch.equal(want, before)


# --- the mesh: a row's features as per-device graph segments ---

@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a row that spans cards, a launch on the second card")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _kernel_on(kernel, device, rng):
    """``(kernel output, plain output, bounds)`` of one wrapper call on ``device``, at a main-path shape."""
    if kernel == "log_mel":
        mel = MelSpectrogram(device=device)
        sig = torch.from_numpy(_voiced_16k(10080)).to(device)
        return stft_mel.log_mel(sig, mel.log_mel_basis, mel.window), stft_mel.log_mel_plain(
            sig, mel.mel_basis, mel.window), BOUNDS["mel"]
    if kernel == "chain":
        x, blocks = _chain(rng, 1, 32, 64, 16, 32, 4, device)
        return (unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, torch.float32)),
                unet_block.conv_block_res_chain_plain(x, blocks), BOUNDS["chain"][torch.float32])
    ks, dil = (3, 7, 11), (1, 3, 5)
    x, params = _bank(rng, 1, 7000, 64, ks, device, S=3)
    return (resblock.resblock_bank(x, resblock.pack_bank(params, ks, dil, torch.float32), ks, dil),
            resblock.resblock_bank_plain(x, params, ks, dil), BOUNDS["bank"][torch.float32])


@pytest.mark.parametrize("kernel", ["log_mel", "chain", "bank"])
def test_kernels_launch_on_their_tensors_card(two_cards, kernel):
    """Each wrapper on tensors of ``cuda:1`` while ``cuda:0`` is current
    (after a launch on ``cuda:0``, so the chain's and the bank's shared
    memory cap is set on the second card by its own first launch there):
    launched on ``cuda:1``, against its plain version there, and
    ``cuda:0`` current again after the call."""
    c0, c1 = two_cards
    with torch.cuda.device(c0):
        for dev in (c0, c1):
            got, want, (atol, rtol) = _kernel_on(kernel, dev, np.random.default_rng(7))
            torch.cuda.synchronize(dev)
            assert got.device == dev and torch.cuda.current_device() == 0
            _close(got, want, atol, rtol)


def _one_card_row(device, dtype):
    from obs_rvc_tpu_torch.parallel import make_mesh, shard_params

    pipe = _graph_pipe(device, dtype)
    row = shard_params(pipe, make_mesh(n_data=1, n_model=2, devices=[device, device]))[0]
    assert row.segmented and not pipe.segmented
    return pipe, row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmented_row_on_one_card_equals_its_eager_step(cuda, deterministic_cudnn, dtype):
    """``cuda:0`` named twice along ``model``: the row's graphed forms, its
    features as per-device segments (``jit_step``, the stage graphs,
    ``jit_convert_scan``), bit for bit with the row's eager step, with the
    controls changed mid-stream and no capture after the first."""
    from obs_rvc_tpu_torch.stream import StepControls
    from obs_rvc_tpu_torch.stream.graphs import SegmentedFunction

    dev = torch.device("cuda", 0)
    _, row = _one_card_row(dev, dtype)
    chunks = _chunks(row, 5)
    controls = [(0.0, 1.0), (0.0, 1.0), (12.0, 1.0), (12.0, 0.5), (-5.0, 0.5)]
    want = _stream(row.step, row, chunks, controls)
    assert torch.isfinite(want).all() and float(want.abs().max()) > 1e-3
    for step, holder in ((row.jit_step, row.jit_step), (row.staged_step, row.staged_graphs)):
        assert torch.equal(_stream(step, row, chunks, controls), want)
        captures = holder.captures
        assert torch.equal(_stream(step, row, chunks, controls[::-1]), _stream(row.step, row, chunks, controls[::-1]))
        assert holder.captures == captures
    assert isinstance(row.jit_step.graph, SegmentedFunction)
    wav = torch.cat(chunks[:4]).to(dev)
    scan_controls = StepControls.default(pitch_shift=3.0, rms_mix_rate=0.5)
    assert torch.equal(row.jit_convert_scan(wav.reshape(4, -1), scan_controls),
                       _stream(row.step, row, chunks[:4], [(3.0, 0.5)]))


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_spanning_pool_matches_one_card(two_cards, deterministic_cudnn, mode):
    """A pool of three on a data=1 x model=2 row over ``cuda:0`` and
    ``cuda:1``, bfloat16, a slot starved mid-stream: bit for bit with the
    same row named on ``cuda:0`` twice (the same kernels and sums) and with
    the row over ``cuda:1`` and ``cuda:0`` (its networks copied to the
    second card), and in float32 within 1e-3 of max|audio| of the
    one-device pool."""
    from obs_rvc_tpu_torch.parallel import make_mesh

    c0, c1 = two_cards
    n = 4
    for dtype in (torch.bfloat16, torch.float32):
        pipe = _graph_pipe(c0, dtype)
        wavs = [torch.cat(_chunks(pipe, n, seed=s)).numpy() for s in range(3)]
        spanning = _pool_run(pipe, wavs, n, mode=mode, mesh=make_mesh(n_data=1, n_model=2, devices=[c0, c1]))
        if dtype == torch.bfloat16:
            twice = _pool_run(pipe, wavs, n, mode=mode, mesh=make_mesh(n_data=1, n_model=2, devices=[c0, c0]))
            # the row's first card the second: its networks copied there after their packs were made
            swapped = _pool_run(pipe, wavs, n, mode=mode, mesh=make_mesh(n_data=1, n_model=2, devices=[c1, c0]))
            for k, (a, b, c) in enumerate(zip(spanning, twice, swapped)):
                assert np.abs(a).max() > 1e-3 and np.array_equal(a, b), (k, float(np.abs(a - b).max()))
                assert np.array_equal(c, b), (k, float(np.abs(c - b).max()))
        else:
            one = _pool_run(pipe, wavs, n, mode=mode)
            for k, (a, b) in enumerate(zip(spanning, one)):
                assert float(np.abs(a - b).max()) <= 1e-3 * float(np.abs(b).max()), k
