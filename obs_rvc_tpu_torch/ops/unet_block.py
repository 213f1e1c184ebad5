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
a tile shape that :func:`chain_tiling` chooses from the batch and the
level's size (plain arithmetic, so the CPU tests check it).

Widths: the kernel is built for C in :data:`CUDA_CHANNELS` and any Cin up to
:data:`CUDA_MAX_CIN`; any other C up to 32 runs on the next built one,
:func:`pack_chain` zero-padding the weights (and the wrapper the input of a
level whose first block keeps its channels), exact as ``ops/_mma.py`` says.
What lies outside raises ``NotImplementedError`` naming its limit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.ops._mma import built_width, conv_rounded, k_step, pack_taps, pad_to

#: output channel counts the CUDA kernel is built for (its template instances); a narrower C runs on the next
#: one up. Past 32 none: a conv stages its whole weight in shared memory, and the C=64 levels' (Cin up to
#: 128: 9 x 128 x 64 float32, 295 KB) would not fit a block's 227 KB without a ring of taps
CUDA_CHANNELS = (8, 16, 32)
#: input channels the kernel takes at most (its stage of the input tile, the weights beside it)
CUDA_MAX_CIN = 64
#: wrapper calls that launched the CUDA kernel
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


def kernel_width(C: int, cin: int) -> int:
    """The kernel's output channels for a level ``cin → C``: the least of
    :data:`CUDA_CHANNELS` that holds C. Raises ``NotImplementedError`` past
    them or past :data:`CUDA_MAX_CIN`."""
    width = built_width(C, CUDA_CHANNELS)
    if width is None:
        raise NotImplementedError(f"conv_block_res_chain: the CUDA kernel takes C up to {CUDA_CHANNELS[-1]}, got "
                                  f"{C} (shared memory: a conv stages its whole weight)")
    if not 1 <= cin <= CUDA_MAX_CIN:
        raise NotImplementedError(f"conv_block_res_chain: the CUDA kernel takes Cin 1..{CUDA_MAX_CIN}, got {cin} "
                                  "(shared memory: the input tile and the weights)")
    return width


def pack_chain(blocks, dtype: torch.dtype) -> PackedChain:
    """Check a level's folded blocks and pack them for the kernel in the
    activation ``dtype`` (:func:`pack_taps`), zero-padded to the kernel's
    width (:func:`kernel_width`); the biases are rounded to ``dtype`` as the
    plain version rounds them, and kept in float32."""
    C = blocks[0][0].shape[-1]
    cin = cin0 = blocks[0][0].shape[2]
    width = kernel_width(C, cin0)
    # a first block without a shortcut adds its input: that input is padded to the width too
    cin_kernel = cin0 if blocks[0][4] is not None else width
    out, ptrs = [], []
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
        ci = cin_kernel if i == 0 else width
        packed = (pack_taps(pad_to(w1.reshape(9, cin, C), (9, ci, width)), dtype), _kernel_weight(b1, dtype, width),
                  pack_taps(pad_to(w2.reshape(9, C, C), (9, width, width)), dtype), _kernel_weight(b2, dtype, width),
                  None if wsc is None else pack_taps(pad_to(wsc.reshape(1, cin, C), (1, ci, width)), dtype),
                  _kernel_weight(bsc, dtype, width))
        out.append(packed)
        ptrs += [0 if t is None else t.data_ptr() for t in packed]
        cin = C
    return PackedChain(dtype, blocks[0][0].device, C, cin0, width, cin_kernel, out,
                       (ctypes.c_void_p * len(ptrs))(*ptrs))


class ChainTiling(NamedTuple):
    """A level's launch shape: one block a tile of ``th`` x ``tw`` output
    pixels, ``warps`` warps of ``wm`` m16 tiles (16 pixels of a row) each,
    ``tiles`` blocks in all; the shared memory of the level's largest
    launch."""

    th: int
    tw: int
    wm: int
    warps: int
    tiles: int
    smem_bytes: int


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


def chain_tiling(B: int, H: int, W: int, cin: int, C: int, dtype: torch.dtype, n_sms: int = N_SMS,
                 tile: Optional[tuple] = None) -> ChainTiling:
    """The launch shape of a level ``[B, H, W, Cin] → C`` (on the kernel's
    width for C): the tile of :data:`TILES` for its pixels an SM, or
    ``tile``, a ``(th, tw, wm)``."""
    width = built_width(C, CUDA_CHANNELS)
    if width is None:
        raise ValueError(f"chain_tiling: no kernel for C={C}")
    if tile is None:
        tile = TILES[sum(B * H * W >= step * n_sms for step in TILE_STEPS)]
    th, tw, wm = tile
    warps = th * tw // (16 * wm)
    if tw % 16 or wm not in CUDA_WM or warps * 16 * wm != th * tw or not 1 <= warps <= CUDA_MAX_WARPS:
        raise ValueError(f"chain_tiling: no kernel for tile {tuple(tile)}")
    smem = level_smem(cin, width, dtype, th, tw)
    if smem > SMEM_CAP:
        raise ValueError(f"chain_tiling: tile {tuple(tile)} takes {smem} bytes of shared memory")
    return ChainTiling(th, tw, wm, warps, B * -(-H // th) * -(-W // tw), smem)


def chain_tiles(tiling: ChainTiling, B: int, H: int, W: int):
    """The output pixels each block computes, in the kernel's order: block
    ``(b * ceil(H/th) + ty) * ceil(W/tw) + tx`` takes tile ``(b, ty, tx)``,
    its rows and columns cut at the image's edge. Yields ``(block, b, rows,
    cols)`` with ``rows`` and ``cols`` ranges."""
    tiles_w, tiles_h = -(-W // tiling.tw), -(-H // tiling.th)
    for blk in range(tiling.tiles):
        tx, ty, b = blk % tiles_w, blk // tiles_w % tiles_h, blk // (tiles_w * tiles_h)
        yield (blk, b, range(ty * tiling.th, min(H, (ty + 1) * tiling.th)),
               range(tx * tiling.tw, min(W, (tx + 1) * tiling.tw)))


def launch_info(cin: int, C: int, dtype: torch.dtype, tiling: ChainTiling) -> dict:
    """The level's launch on the card: threads, the largest launch's shared
    memory, registers a thread and the blocks an SM holds at it (CUDA's
    occupancy query), on the kernel's width for ``C``."""
    fn = _cuda.function("unet_block", "rvc_chain_launch_info", [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = (ctypes.c_int * 4)()
    _cuda.check(fn(kernel_width(C, cin), 0 if dtype == torch.float32 else 1, cin, tiling.th, tiling.tw, tiling.wm,
                   ctypes.cast(out, ctypes.c_void_p)), f"chain launch info ({cin}->{C}, {tiling})")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm"), out))


def conv_block_res_chain(x, blocks: Union[list, PackedChain], tile: Optional[tuple] = None) -> torch.Tensor:
    """Fused ConvBlockRes chain, ``[B, H, W, Cin] → [B, H, W, C]``.
    ``blocks`` is the folded blocks for ``x`` on the CPU, and their
    :func:`pack_chain` in ``x.dtype`` for ``x`` on a card; there ``tile``,
    a ``(th, tw, wm)``, overrides :func:`chain_tiling`'s choice."""
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
    if packed.dtype != x.dtype or packed.cin != cin:
        raise ValueError("conv_block_res_chain: the packed weights do not match x's dtype or channels")
    if packed.device != x.device:
        raise ValueError("conv_block_res_chain: weights must be on the activation's device")
    cink = packed.cin_kernel
    tl = chain_tiling(B, H, W, cink, width, x.dtype, _sms(x.device), tile)
    fn = _cuda.function("unet_block", "rvc_conv_block_res_chain",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    if cink != cin:  # the first block adds its input to C channels padded to the width: the input padded too
        x = F.pad(x, (0, cink - cin))
    out = torch.empty((B, H, W, width), dtype=x.dtype, device=x.device)
    scratch = torch.empty((3, B, H, W, width), dtype=x.dtype, device=x.device)
    # the packed weights lie on packed.device, checked above
    with _cuda.on_device_of(x, out, scratch, what="conv_block_res_chain"):
        rc = fn(_cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(scratch), ctypes.cast(packed.params, ctypes.c_void_p),
                len(packed.blocks), B, H, W, cink, width, 0 if x.dtype == torch.float32 else 1, tl.th, tl.tw, tl.wm,
                _cuda.stream_of(x))
    _cuda.check(rc, f"conv_block_res_chain ({cin}->{C} on the kernel's {cink}->{width}, {len(packed.blocks)} blocks)")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out if width == C else out[..., :C].contiguous()
