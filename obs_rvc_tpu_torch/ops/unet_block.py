"""One RMVPE U-Net level's ConvBlockRes chain (counterpart of
``obs_rvc_tpu/ops/unet_block.py:conv_block_res_chain``).

Each block: 3x3 conv + folded BatchNorm → ReLU → 3x3 conv + folded BN →
ReLU → + shortcut, the shortcut a 1x1 conv with bias on a channel-changing
first block and the identity otherwise; zero SAME padding. Activations are
NHWC ``[B, H, W, Cin] → [B, H, W, C]`` (the JAX package's layout); weights
per block ``(W1 [3, 3, Cin_b, C], b1 [C], W2 [3, 3, C, C], b2 [C], Wsc
[Cin_b, C] or None, bsc [C] or None)`` with BN already folded by
:func:`fold_bn`.

:func:`conv_block_res_chain` takes the plain PyTorch version for a tensor on
the CPU and runs the CUDA kernel (``csrc/unet_block.cu``: implicit GEMMs on
the tensor cores, 3xTF32 in float32 and bf16 in bfloat16; one C call per
level, two launches per block) for a tensor on a card; it never falls back
from one to the other. The plain version takes the folded blocks; the kernel
takes only their :func:`pack_chain` (the weights in its mma fragments'
order), which ``models/rmvpe.py:_Chain`` makes once per weight version, and
a tiling that :func:`chain_tiling` chooses from the batch and the level's
size (plain arithmetic, so the CPU tests check it).

Widths: two kernels in one source. The resident kernel stages a conv's whole
weight in shared memory; it is built for C in :data:`CUDA_CHANNELS` and any
Cin up to :data:`RESIDENT_MAX_CIN`, and any other C up to 32 runs on the
next built one. Every other level, up to :data:`CUDA_MAX_C` output and
:data:`CUDA_MAX_CIN` input channels (the widest levels any
``pallas_unet_max_ch`` routes), runs on the ring kernel, which streams the
weights through shared memory a slab of input channels at a time and tiles C
across warps and blocks (:func:`is_ring`); where a stream's map is smaller
than a tile and many streams fill the card, its batch kernel lets a block
take several streams' pixels, so a weight byte in shared memory serves them
all, on ``wgmma`` in bfloat16. C is padded to a multiple of 32 and the
first block's Cin to a slab. :func:`pack_chain` zero-pads the
weights (and the wrapper the input where the kernel reads more channels
than it has), exact as ``ops/_mma.py`` says. What lies outside raises
``NotImplementedError`` naming its limit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.ops._mma import (RING_GROUP, built_width, conv_rounded, k_step, pack_ring, pack_ring_wgmma,
                                        pack_taps, pad_to, slab_channels)

#: output channel counts the resident kernel is built for (its template instances); a narrower C runs on the
#: next one up. Past 32 it would not fit: it stages a conv's whole weight in shared memory, and the C=64
#: levels' (Cin up to 128: 9 x 128 x 64 float32, 295 KB) pass a block's 227 KB
CUDA_CHANNELS = (8, 16, 32)
#: input channels the resident kernel takes at most (its stage of the input tile, the weights beside it)
RESIDENT_MAX_CIN = 64
#: output and input channels the ring kernel takes at most: the full RMVPE's widest routable levels (dec0,
#: 512 -> 256; its intermediate levels, 256 -> 512, run their modules at every pallas_unet_max_ch, as in the
#: JAX package), and the widest the card tests hold the kernel to
CUDA_MAX_C = 256
CUDA_MAX_CIN = 512
#: wrapper calls that launched a CUDA kernel (either)
LAUNCHES = 0

#: the kernel's m16 tiles a warp (its template instances), and warps a block at most
CUDA_WM = (1, 2)
CUDA_MAX_WARPS = 8
#: shared memory a block may take on Hopper
SMEM_CAP = 232448
#: the H100 SXM's SMs (a card reports its own count)
N_SMS = 132
#: tile shapes (rows, columns, m16 tiles a warp) by the level's output pixels an SM, B·H·W / SMs: below
#: TILE_STEPS[0] (one stream's levels) 4 warps of one m16 tile over 4 rows; below TILE_STEPS[1] (8
#: streams) 8 warps over 8 rows; beyond (64 streams) 4 warps of two m16 tiles each. Chosen from a sweep of
#: every tile the kernel takes at 1, 8 and 64 streams (scripts/torch_chain_probe.py --sweep, PERF.md)
TILES = ((4, 16, 1), (8, 16, 1), (8, 16, 2))
TILE_STEPS = (128, 1024)
#: the one-stream ring kernel's block shapes, (output pixels, groups of 32 channels (a warp each along N), m16
#: tiles a warp), largest first, 16 pixels a row from 128 pixels (where the map is 16 wide) and 8 below; a
#: block of at most RING_KW_WARPS warps along M and N takes 3 warps along K; in float32 a warp takes one m16
#: tile (its sums of each stage are kept apart from the conv's, twice the registers). :func:`chain_tiling`
#: takes the first whose tiles fill RING_FILL of the SMs, unless the convs over C have more than
#: RING_SPLIT_STAGES K stages; then, or where none fills them, the first that does with K split across
#: blocks (up to RING_MAX_SPLIT ways, half a conv's stages, and the SMs over the tiles), else the first of
#: the least pixels with that split. Chosen from a sweep of every tile, warps along K and split at 1, 8 and
#: 64 streams (scripts/torch_chain_probe.py --levels wide --sweep, PERF.md)
RING_TILES = ((128, 2, 2), (64, 2, 2), (32, 2, 1), (32, 1, 1), (16, 2, 1), (16, 1, 1))
#: the batch kernel's one tile, taken before them: RING_BATCH_M output pixels, whole maps of RING_BATCH_M /
#: (H W) streams a block where a stream's map has fewer pixels (enc4 and dec0's 4 x 8 maps: 2 streams a
#: block), x RING_BATCH_NW groups, one warp (on wgmma in bfloat16, one warpgroup) along K, wherever such tiles
#: fill RING_FILL of the SMs without a K split (from 60 streams at enc4 and dec0). Chosen from the same sweep
#: at 8 and 64 streams, over 64 and 128 pixels, 1 and 2 groups and 1 to 3 warpgroups along K
RING_BATCH_M = 64
RING_BATCH_NW = 2
RING_KW_WARPS = 4
RING_FILL = 0.9
RING_SPLIT_STAGES = 4
RING_MAX_SPLIT = 4
#: the ring kernels' slots of shared memory
RING_STAGES = 3
#: the ring kernels' warps a block at most
RING_MAX_WARPS = 16


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an inference-mode BatchNorm into the preceding bias-free conv with
    the output channel last: ``W' = W * s``, ``b' = bias - mean * s``,
    ``s = scale / sqrt(var + eps)``."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s, bias - mean * s


def conv_block_res_chain_plain(x, blocks) -> torch.Tensor:
    """The chain as ``F.conv2d`` calls on the folded weights, in ``x``'s
    dtype, each conv rounded where the Pallas kernel rounds it
    (:func:`~obs_rvc_tpu_torch.ops._mma.conv_rounded`)."""
    h = x.permute(0, 3, 1, 2)  # NCHW
    for w1, b1, w2, b2, wsc, bsc in blocks:
        y = F.relu(conv_rounded(F.conv2d, h, w1.permute(3, 2, 0, 1), b1, padding=1))
        y = F.relu(conv_rounded(F.conv2d, y, w2.permute(3, 2, 0, 1), b2, padding=1))
        if wsc is not None:
            cin, c = wsc.shape[-2:]
            h = conv_rounded(F.conv2d, h, wsc.reshape(cin, c).T[:, :, None, None], bsc)
        h = h + y
    return h.permute(0, 2, 3, 1)


class PackedChain(NamedTuple):
    """A level's folded weights as the CUDA kernel reads them (see
    :func:`pack_chain`), for one activation dtype."""

    dtype: torch.dtype
    device: torch.device
    C: int
    cin: int
    #: the kernel's output channels: C, or the next built count up (the weights zero-padded to it)
    width: int
    #: the first block's input channels as the kernel reads them: cin, or ``width`` where that block keeps
    #: its channels (no shortcut) and C is padded, the input then padded too
    cin_kernel: int
    #: per block ``(W1, b1, W2, b2, Wsc | None, bsc | None)``, weights as mma fragments
    blocks: list
    #: the blocks' pointers, six per block, as the C entry point takes them
    params: ctypes.Array
    #: packed for the ring kernels (:func:`is_ring`), by ``ops/_mma.py:pack_ring``; else for the resident one
    ring: bool = False
    #: a bfloat16 ring level's folded blocks, and (once :func:`wgmma_pack` has made them, at the level's first
    #: launch on wgmma) their pack for the batch kernel's wgmma and its pointers
    folded: Optional[list] = None
    wgmma: Optional[list] = None


def is_ring(C: int, cin: int) -> bool:
    """Whether a level ``cin → C`` runs on the ring kernel: past the
    resident kernel's C of 32 or Cin of :data:`RESIDENT_MAX_CIN`."""
    return C > CUDA_CHANNELS[-1] or cin > RESIDENT_MAX_CIN


def kernel_width(C: int, cin: int) -> int:
    """The kernel's output channels for a level ``cin → C``: on the resident
    kernel the least of :data:`CUDA_CHANNELS` that holds C, on the ring
    kernel C rounded up to a multiple of 32. Raises ``NotImplementedError``
    past :data:`CUDA_MAX_C` or :data:`CUDA_MAX_CIN`."""
    if not 1 <= C <= CUDA_MAX_C:
        raise NotImplementedError(f"conv_block_res_chain: the CUDA kernels take C up to {CUDA_MAX_C}, got {C} "
                                  "(the widest level RMVPE routes to the chain; the card tests stop there)")
    if not 1 <= cin <= CUDA_MAX_CIN:
        raise NotImplementedError(f"conv_block_res_chain: the CUDA kernels take Cin 1..{CUDA_MAX_CIN}, got {cin} "
                                  "(the widest level RMVPE routes to the chain; the card tests stop there)")
    if is_ring(C, cin):
        return -(-C // RING_GROUP) * RING_GROUP
    return built_width(C, CUDA_CHANNELS)


def kernel_cin(cin: int, C: int, dtype: torch.dtype, shortcut: Optional[bool] = None) -> int:
    """The first block's input channels as the kernel reads them: on the
    resident kernel ``cin``, on the ring kernel ``cin`` rounded up to a
    slab (``ops/_mma.py:slab_channels``); either way the kernel's width
    where the block adds its input (no shortcut: ``shortcut`` false, by
    default where ``cin == C``), since that input is padded to the width."""
    width = kernel_width(C, cin)
    if not (cin != C if shortcut is None else shortcut):
        return width
    if not is_ring(C, cin):
        return cin
    sl = slab_channels(dtype)
    return -(-cin // sl) * sl


def pack_chain(blocks, dtype: torch.dtype) -> PackedChain:
    """Check a level's folded blocks and pack them for the kernel in the
    activation ``dtype`` (:func:`pack_taps`), zero-padded to the kernel's
    width (:func:`kernel_width`); the biases are rounded to ``dtype`` as the
    plain version rounds them, and kept in float32. A bfloat16 ring level
    keeps its folded blocks for :func:`wgmma_pack`."""
    C = blocks[0][0].shape[-1]
    cin = cin0 = blocks[0][0].shape[2]
    width, ring = kernel_width(C, cin0), is_ring(C, cin0)
    # a first block without a shortcut adds its input: that input is padded to the width too
    cin_kernel = kernel_cin(cin0, C, dtype, blocks[0][4] is not None)
    for i, (w1, b1, w2, b2, wsc, bsc) in enumerate(blocks):
        if w1.shape != (3, 3, cin, C) or w2.shape != (3, 3, C, C):
            raise ValueError(f"conv_block_res_chain: block {i} weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}")
        if b1.shape != (C,) or b2.shape != (C,):
            raise ValueError(f"conv_block_res_chain: block {i} bias shapes")
        if wsc is None and cin != C:
            raise ValueError(f"conv_block_res_chain: block {i} changes channels without a shortcut")
        if wsc is not None and (bsc is None or bsc.shape != (C,)):
            raise ValueError(f"conv_block_res_chain: block {i} shortcut bias shape")
        if any(t is not None and t.device != blocks[0][0].device for t in (w1, b1, w2, b2, wsc, bsc)):
            raise ValueError(f"conv_block_res_chain: block {i} weights on more than one device")
        cin = C
    out, params = _pack_blocks(blocks, dtype, pack_ring if ring else pack_taps, width, cin_kernel)
    wgmma = ring and dtype == torch.bfloat16
    return PackedChain(dtype, blocks[0][0].device, C, cin0, width, cin_kernel, out, params, ring,
                       blocks if wgmma else None, [] if wgmma else None)


def _pack_blocks(blocks, dtype, pack, width: int, cin_kernel: int):
    """Each block's weights zero-padded to ``width`` (the first block's
    input channels to ``cin_kernel``) and packed by ``pack``, its biases as
    the kernel takes them; the packed blocks, and their pointers in the C
    entry's order, six a block."""
    out, ptrs = [], []
    for i, (w1, b1, w2, b2, wsc, bsc) in enumerate(blocks):
        cin, C = w1.shape[2], w1.shape[3]
        ci = cin_kernel if i == 0 else width
        packed = (pack(pad_to(w1.reshape(9, cin, C), (9, ci, width)), dtype), _kernel_weight(b1, dtype, width),
                  pack(pad_to(w2.reshape(9, C, C), (9, width, width)), dtype), _kernel_weight(b2, dtype, width),
                  None if wsc is None else pack(pad_to(wsc.reshape(1, cin, C), (1, ci, width)), dtype),
                  _kernel_weight(bsc, dtype, width))
        out.append(packed)
        ptrs += [0 if t is None else t.data_ptr() for t in packed]
    return out, (ctypes.c_void_p * len(ptrs))(*ptrs)


_WGMMA_LOCK = threading.Lock()


def wgmma_pack(packed: PackedChain) -> tuple:
    """A bfloat16 ring level's blocks packed for the batch kernel's
    ``wgmma`` (``ops/_mma.py:pack_ring_wgmma``) and their pointers, as
    :func:`pack_chain` packs them for ``mma.sync``: made at the first call
    and kept with ``packed``, so that only the levels the rule sends there
    hold both packs. That first call comes before any graph capture of the
    level: a capture's warm-up call makes it."""
    if packed.wgmma is None:
        raise ValueError("wgmma_pack: only a bfloat16 ring level has a wgmma pack")
    with _WGMMA_LOCK:  # sessions' threads may launch one level at once
        if not packed.wgmma:
            if packed.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("wgmma_pack: the level's first wgmma launch is inside a graph capture; "
                                   "launch it once before the capture")
            with torch.no_grad():
                packed.wgmma.extend(_pack_blocks(packed.folded, torch.bfloat16,
                                                 lambda w, dtype: pack_ring_wgmma(w), packed.width,
                                                 packed.cin_kernel))
        return tuple(packed.wgmma)


class ChainTiling(NamedTuple):
    """A level's launch shape: a tile of ``th`` x ``tw`` output pixels and
    ``bn`` channels a block, ``warps`` warps of ``wm`` m16 tiles (16
    consecutive pixels of the tile) each, ``tiles`` such tiles in all; the
    shared memory of the level's largest launch. On the resident kernel
    ``bn`` is the whole width and a block takes a tile. On the ring kernel
    (``ring``) a block takes ``streams`` streams' tiles at the same place
    in each map, ``bn`` 32 or 64 channels, a warp each 32 (on ``wgmma``,
    four warps together), ``kw`` warps (warpgroups on ``wgmma``) along K
    share each stage's taps, and the K stages of the first conv (over Cin)
    and of the others (over C) split ``splits`` ways across blocks, a block
    a tile and split, with ``partial`` float32 of scratch for the splits'
    partial sums (0 where nothing splits)."""

    th: int
    tw: int
    wm: int
    warps: int
    tiles: int
    smem_bytes: int
    ring: bool = False
    bn: int = 0
    splits: tuple = (1, 1)
    partial: int = 0
    #: the ring kernel's warps along K, each taking 9 / kw of the taps of a stage (``warps`` counts them)
    kw: int = 1
    #: the ring kernel's streams a tile
    streams: int = 1
    #: the ring kernel's products on wgmma (bfloat16) rather than mma.sync
    wgmma: bool = False


def level_smem(cin: int, C: int, dtype: torch.dtype, th: int, tw: int) -> int:
    """Shared memory of the level's largest launch (``csrc/unet_block.cu:
    conv_smem``): conv1 over Cin with the shortcut's weights, or conv2 over
    C. A launch holds its conv's B fragments (9 taps, 10 with the
    shortcut's, of Cinp / ks K steps of C / 8 n8 tiles of 32 lanes x 8
    bytes) and its input tile of (th + 2) x (tw + 2) pixels of Cinp
    channels and 16 bytes of padding."""
    ks, elem = k_step(dtype), 4 if dtype == torch.float32 else 2

    def conv(ci, shortcut):
        cinp = -(-ci // ks) * ks
        return (10 if shortcut else 9) * (cinp // ks) * (C // 8) * 256 + (th + 2) * (tw + 2) * (cinp * elem + 16)

    return max(conv(cin, True), conv(C, False))


def ring_smem(th: int, tw: int, nw: int, streams: int = 1) -> int:
    """Shared memory of the ring kernels' largest launch (``csrc/unet_block.cu:
    ring_smem``, conv1 with the shortcut): :data:`RING_STAGES` slots, each
    the block's ``nw`` groups' 10 taps (2 K steps x 4 n8 tiles x 32 lanes x
    8 bytes a tap) and ``streams`` halo tiles of one 64-byte slab (and 16
    bytes of padding) a pixel, and 32 bytes for a slot's mbarrier each and
    the last block's flag. The same in both dtypes: a slab is 64 bytes
    either way."""
    return RING_STAGES * (nw * 10 * 2048 + streams * (th + 2) * (tw + 2) * 80) + 32


def ring_options(B, H, W, width, dtype):
    """The rule's candidate tiles ``(th, tw, wm, nw, kw, streams, wgmma)``,
    preferred first: the batch kernel's (:data:`RING_BATCH_M`), then the
    one-stream kernel's (:data:`RING_TILES`)."""
    px, options = RING_BATCH_M, []
    batch = [(H, W, 1, RING_BATCH_NW, 1, px // (H * W), dtype == torch.bfloat16)] if (
        B > 1 and width % (RING_GROUP * RING_BATCH_NW) == 0 and px > H * W and px % (H * W) == 0
        and px // (H * W) <= B) else []
    for px, nw, wm in RING_TILES:
        if width % (RING_GROUP * nw) == 0:
            wm = 1 if dtype == torch.float32 else wm  # float32 keeps a second set of sums a stage: one m16 tile
            tw = 16 if px >= 128 and W >= 16 else 8
            options.append((px // tw, tw, wm, nw, 3 if px // (16 * wm) * nw <= RING_KW_WARPS else 1, 1, False))
    # no tile taller than the map, but the least
    return batch + ([o for o in options if o[0] <= H] or options[-1:])


def _ring_tiling(B, H, W, cin, C, width, dtype, n_sms, tile) -> ChainTiling:
    cink = kernel_cin(cin, C, dtype)
    sl = slab_channels(dtype)
    stages = (cink // sl, width // sl)

    def tiles(th, tw, nw, streams):
        return -(-B // streams) * -(-H // th) * -(-W // tw) * (width // (RING_GROUP * nw))

    def split(o):
        """K split across blocks: up to RING_MAX_SPLIT ways, half the conv's stages, the SMs over the tiles."""
        cap = max(1, min(RING_MAX_SPLIT, n_sms // tiles(o[0], o[1], o[3], o[5])))
        return tuple(max(1, min(cap, n // 2)) for n in stages)

    if tile is None:
        options = ring_options(B, H, W, width, dtype)
        fill = RING_FILL * n_sms
        whole = next((o for o in options if tiles(o[0], o[1], o[3], o[5]) >= fill), None)
        if whole is not None and (whole[5] > 1 or stages[1] <= RING_SPLIT_STAGES):
            tile = (*whole, 1, 1)
        else:  # the one-stream kernel's rule: K split
            options = [o for o in options if o[5] == 1]
            least = next(o for o in options if o[0] * o[1] == options[-1][0] * options[-1][1])
            tile = next((o for o in options if tiles(o[0], o[1], o[3], 1) * max(split(o)) >= fill), least)
            tile = (*tile, *split(tile))
    th, tw, wm, nw, kw, streams, wg, *forced = tile
    m = streams * th * tw
    warps = m // (16 * wm) * nw * kw
    batch = streams > 1 or bool(wg)  # the batch kernel's one tile: wgmma in bfloat16, mma.sync in float32
    if wm not in CUDA_WM or nw not in (1, 2) or streams < 1 or m % (16 * wm) or \
            not 1 <= kw <= 9 or not 1 <= warps <= RING_MAX_WARPS or width % (RING_GROUP * nw) or \
            len(forced) not in (0, 2) or not all(1 <= f <= n for f, n in zip(forced, stages)) or \
            (batch and ((m, nw, wm, kw) != (RING_BATCH_M, RING_BATCH_NW, 1, 1) or
                        bool(wg) != (dtype == torch.bfloat16))):
        raise ValueError(f"chain_tiling: no ring kernel for tile {tuple(tile)} at C={width} in {dtype}")
    smem = ring_smem(th, tw, nw, streams)
    # the ring also holds the sums the warps along K hand over: (kw - 1) x S th tw x 32 nw floats, x 2 with
    # the shortcut, within its slots as a conv without the shortcut sizes them
    if smem > SMEM_CAP or (kw - 1) * 2 * m * RING_GROUP * nw * 4 > \
            RING_STAGES * (nw * 9 * 2048 + streams * (th + 2) * (tw + 2) * 80):
        raise ValueError(f"chain_tiling: tile {tuple(tile)} takes {smem} bytes of shared memory")
    n = tiles(th, tw, nw, streams)
    splits = tuple(forced) or split((th, tw, wm, nw, kw, streams))
    bn = RING_GROUP * nw
    partial = n * m * bn * max(2 * splits[0], splits[1]) if max(splits) > 1 else 0
    return ChainTiling(th, tw, wm, warps, n, smem, True, bn, splits, partial, kw, streams, bool(wg))


def chain_tiling(B: int, H: int, W: int, cin: int, C: int, dtype: torch.dtype, n_sms: int = N_SMS,
                 tile: Optional[tuple] = None) -> ChainTiling:
    """The launch shape of a level ``[B, H, W, Cin] → C`` (on the kernel's
    width for C and input channels for Cin). On the resident kernel the tile
    of :data:`TILES` for its pixels an SM, or ``tile``, a ``(th, tw, wm)``.
    On the ring kernels (:func:`is_ring`) the batch kernel's tile
    (:data:`RING_BATCH_M`) or the tile of :data:`RING_TILES` that the rule
    there picks; or ``tile``, a ``(th, tw, wm, nw, kw, streams, wgmma)`` (K split
    where its tiles leave SMs idle), or ``(th, tw, wm, nw, kw, streams,
    wgmma, split_in, split_c)`` to set the splits too."""
    width = kernel_width(C, cin)
    if is_ring(C, cin):
        return _ring_tiling(B, H, W, cin, C, width, dtype, n_sms, tile)
    if tile is None:
        tile = TILES[sum(B * H * W >= step * n_sms for step in TILE_STEPS)]
    th, tw, wm = tile
    warps = th * tw // (16 * wm)
    if tw % 16 or wm not in CUDA_WM or warps * 16 * wm != th * tw or not 1 <= warps <= CUDA_MAX_WARPS:
        raise ValueError(f"chain_tiling: no kernel for tile {tuple(tile)}")
    smem = level_smem(cin, width, dtype, th, tw)
    if smem > SMEM_CAP:
        raise ValueError(f"chain_tiling: tile {tuple(tile)} takes {smem} bytes of shared memory")
    return ChainTiling(th, tw, wm, warps, B * -(-H // th) * -(-W // tw), smem, False, width)


def chain_tiles(tiling: ChainTiling, B: int, H: int, W: int, C: Optional[int] = None):
    """The output tiles, in the kernel's order: tile ``blk = y *
    pixel_tiles + x``, pixel tile ``x = (sg * ceil(H/th) + ty) *
    ceil(W/tw) + tx`` (a block's ``blockIdx.x``; ``sg`` the tile's group of
    ``streams`` streams, one on the resident kernel) and channel tile ``y``
    (its ``blockIdx.y``, ``bn`` channels from ``y * bn``; the resident
    kernel has one), streams, rows, columns and channels cut at the level's
    edge. Yields ``(blk, streams, rows, cols)`` with each a ``range``, and
    with ``C`` (the level's channels) ``(blk, streams, rows, cols, chans)``.
    On the ring kernel a tile is ``splits`` blocks, one a slice of K."""
    tiles_w, tiles_h, S = -(-W // tiling.tw), -(-H // tiling.th), tiling.streams
    n_px = -(-B // S) * tiles_h * tiles_w
    for blk in range(tiling.tiles):
        x, y = blk % n_px, blk // n_px
        tx, ty, sg = x % tiles_w, x // tiles_w % tiles_h, x // (tiles_w * tiles_h)
        streams = range(sg * S, min(B, (sg + 1) * S))
        rows = range(ty * tiling.th, min(H, (ty + 1) * tiling.th))
        cols = range(tx * tiling.tw, min(W, (tx + 1) * tiling.tw))
        if C is None:
            yield blk, streams, rows, cols
        else:
            yield blk, streams, rows, cols, range(y * tiling.bn, min(C, (y + 1) * tiling.bn))


def ring_staging(tiling: ChainTiling, B: int, H: int, W: int, x: int) -> list:
    """A model of what the ring kernel stages for pixel tile ``x`` (its
    ``blockIdx.x``), slot by slot as ``load_tile`` fills a stage: the
    ``streams`` halo tiles of ``(th + 2) x (tw + 2)`` pixels one after
    another, each ``(b, h, w)`` the pixel of stream ``b`` it copies, or
    None where it writes zeros (outside that stream's map, or past B)."""
    tiles_w, tiles_h = -(-W // tiling.tw), -(-H // tiling.th)
    tx, ty, b0 = x % tiles_w, x // tiles_w % tiles_h, x // (tiles_w * tiles_h) * tiling.streams
    xw, spix = tiling.tw + 2, (tiling.th + 2) * (tiling.tw + 2)
    out = []
    for p in range(tiling.streams * spix):
        s, pp = divmod(p, spix)
        r, c = divmod(pp, xw)
        b, h, w = b0 + s, ty * tiling.th - 1 + r, tx * tiling.tw - 1 + c
        out.append((b, h, w) if b < B and 0 <= h < H and 0 <= w < W else None)
    return out


def ring_reads(tiling: ChainTiling, p: int, tap: int) -> int:
    """The staged slot (an index of :func:`ring_staging`) that row ``p`` of
    the ring kernel's M tile (its ``p``-th of ``streams`` th tw pixels)
    reads at ``tap`` (``3 dy + dx``), as its lane's ``ldmatrix`` address
    ``arow`` plus the tap's offset finds it."""
    sub, xw = tiling.th * tiling.tw, tiling.tw + 2
    s, q = divmod(p, sub)
    r, c = divmod(q, tiling.tw)
    return s * (tiling.th + 2) * xw + (r + tap // 3) * xw + c + tap % 3


def launch_info(cin: int, C: int, dtype: torch.dtype, tiling: ChainTiling) -> dict:
    """The level's launch on the card: threads, the largest launch's shared
    memory, registers a thread and the blocks an SM holds at it (CUDA's
    occupancy query), on the kernel's width for ``C``."""
    dt = 0 if dtype == torch.float32 else 1
    out = (ctypes.c_int * 4)()
    if tiling.ring:
        fn = _cuda.function("unet_block", "rvc_chain_ring_launch_info", [ctypes.c_int] * 8 + [ctypes.c_void_p])
        rc = fn(dt, tiling.th, tiling.tw, tiling.wm, tiling.bn // RING_GROUP, tiling.kw, tiling.streams,
                int(tiling.wgmma), ctypes.cast(out, ctypes.c_void_p))
    else:
        fn = _cuda.function("unet_block", "rvc_chain_launch_info", [ctypes.c_int] * 6 + [ctypes.c_void_p])
        rc = fn(kernel_width(C, cin), dt, cin, tiling.th, tiling.tw, tiling.wm, ctypes.cast(out, ctypes.c_void_p))
    _cuda.check(rc, f"chain launch info ({cin}->{C}, {tiling})")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm"), out))


def conv_block_res_chain(x, blocks: Union[list, PackedChain], tile: Optional[tuple] = None) -> torch.Tensor:
    """Fused ConvBlockRes chain, ``[B, H, W, Cin] → [B, H, W, C]``.
    ``blocks`` is the folded blocks for ``x`` on the CPU, and their
    :func:`pack_chain` in ``x.dtype`` for ``x`` on a card; there ``tile``
    (``(th, tw, wm)``, on the ring kernel ``(th, tw, wm, nw, kw, streams,
    wgmma)`` and optionally the splits) overrides :func:`chain_tiling`'s
    choice."""
    if x.device.type == "cpu":
        if isinstance(blocks, PackedChain):
            raise ValueError("conv_block_res_chain: on the CPU blocks are the folded blocks, not their pack")
        return conv_block_res_chain_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_res_chain: unsupported device {x.device}")
    return _chain_cuda(x, blocks, tile)


def _kernel_weight(w, dt, width):
    return None if w is None else pad_to(w.to(dt).float(), (width,)).contiguous()


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _chain_cuda(x, packed: PackedChain, tile: Optional[tuple] = None) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv_block_res_chain: x must be a contiguous NHWC tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_block_res_chain: unsupported dtype {x.dtype}")
    if not isinstance(packed, PackedChain):
        raise ValueError("conv_block_res_chain: on a card the blocks must be packed by pack_chain")
    B, H, W, cin = x.shape
    C = packed.C
    width = kernel_width(C, cin)
    if packed.dtype != x.dtype or packed.cin != cin or packed.ring != is_ring(C, cin):
        raise ValueError("conv_block_res_chain: the packed weights do not match x's dtype or channels")
    if packed.device != x.device:
        raise ValueError("conv_block_res_chain: weights must be on the activation's device")
    cink = packed.cin_kernel
    tl = chain_tiling(B, H, W, cink, width, x.dtype, _sms(x.device), tile)
    if cink != cin:  # the kernel reads more channels than x has (a slab, or the width it adds x to): zeros
        x = F.pad(x, (0, cink - cin))
    elif tl.ring and x.data_ptr() % 16:  # the ring kernel stages its input by 16-byte copies
        x = x.clone()
    out = torch.empty((B, H, W, width), dtype=x.dtype, device=x.device)
    scratch = torch.empty((3, B, H, W, width), dtype=x.dtype, device=x.device)
    dt = 0 if x.dtype == torch.float32 else 1
    params = ctypes.cast(packed.params, ctypes.c_void_p)
    # the packed weights lie on packed.device, checked above
    if tl.ring:
        fn = _cuda.function("unet_block", "rvc_conv_block_res_chain_ring",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
        # split K: the partial sums, and a counter a tile that the kernel leaves at zero
        partial = torch.empty(tl.partial, dtype=torch.float32, device=x.device) if tl.partial else None
        counters = torch.zeros(tl.tiles, dtype=torch.int32, device=x.device) if tl.partial else None
        if tl.wgmma:  # the batch kernel's wgmma reads its own layout
            params = ctypes.cast(wgmma_pack(packed)[1], ctypes.c_void_p)
        with _cuda.on_device_of(x, out, scratch, partial, counters, what="conv_block_res_chain"):
            rc = fn(_cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(scratch), _cuda.ptr(partial), _cuda.ptr(counters),
                    params, len(packed.blocks), B, H, W, cink, width, dt, tl.th, tl.tw, tl.wm, tl.bn // RING_GROUP,
                    tl.kw, tl.streams, int(tl.wgmma), *tl.splits, _cuda.stream_of(x))
    else:
        fn = _cuda.function("unet_block", "rvc_conv_block_res_chain",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        with _cuda.on_device_of(x, out, scratch, what="conv_block_res_chain"):
            rc = fn(_cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(scratch), params, len(packed.blocks), B, H, W, cink,
                    width, dt, tl.th, tl.tw, tl.wm, _cuda.stream_of(x))
    _cuda.check(rc, f"conv_block_res_chain ({cin}->{C} on the kernel's {cink}->{width}, {len(packed.blocks)} blocks)")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out if width == C else out[..., :C].contiguous()
