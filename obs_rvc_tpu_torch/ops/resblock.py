"""The NSF generator's resblock bank: one upsample level's multi-receptive-field
bank, ``sum_j ResBlock1_j(x) / len(kernel_sizes)`` (counterpart of
``obs_rvc_tpu/ops/resblock.py:resblock_bank_tapdot``).

Each ResBlock1 runs, for every dilation ``d``: leaky-ReLU(0.1) → conv(k, d)
→ leaky-ReLU → conv(k, 1) → + residual. Activations are ``[B, L, C]`` (the
JAX package's layout); weights are per bank ``(W1 [S, k, C, C], b1 [S, C],
W2 [S, k, C, C], b2 [S, C])`` in ``[tap, in, out]`` order, ``S`` the number
of dilations.

:func:`resblock_bank` takes the plain PyTorch version for a tensor on the
CPU and runs the CUDA kernel (``csrc/resblock.cu``: implicit GEMMs on the
tensor cores, 3xTF32 in float32 and bf16 in bfloat16; one C call per level,
one launch per dilation for every bank) for a tensor on a card; it never
falls back from one to the other. The plain version takes the dense bank
params; the kernel takes only their :func:`pack_bank` (the weights in its
mma fragments' order), which ``models/synthesizer.py:GeneratorNSF`` makes
once per weight version, and a tile that :func:`bank_tiling` chooses from
the batch and the level's size (plain arithmetic, so the CPU tests check
it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.ops._mma import conv_rounded, pack_taps

LRELU_SLOPE = 0.1
#: channel counts the CUDA kernel is built for
CUDA_CHANNELS = (16, 32, 64)
CUDA_KERNEL_SIZES = (3, 7, 11)
CUDA_MAX_DILATION = 5
CUDA_MAX_BANKS = 4

#: wrapper calls that launched the CUDA kernel
LAUNCHES = 0

#: the kernel's m16 tiles a warp (its template instances), and warps a block at most
CUDA_WM = (1, 2)
CUDA_MAX_WARPS = 8
#: shared memory a block may take on Hopper
SMEM_CAP = 232448
#: tap slabs of weights the kernel keeps in shared memory: at most (csrc/resblock.cu:MAX_RING), and for a
#: tile given without its ring
MAX_RING = 8
RING = 3
#: the last step's blocks take one bank each, and a sum kernel adds them, where a block a tile would give
#: fewer than this many blocks an SM
SPLIT_BLOCKS_PER_SM = 2
#: the H100 SXM's SMs (a card reports its own count)
N_SMS = 132
#: tiles (warps, m16 tiles a warp, ring depth) by the level's positions an SM, B·L / SMs: below
#: TILE_STEPS[0] (one stream's levels) 128 conv rows a block and a ring of 8 taps (the weights' latency
#: sets the time), beyond (8 and 64 streams) 256 rows and 3 taps (more blocks an SM). Chosen from a sweep
#: of every tile the kernel takes at 1, 8 and 64 streams (scripts/torch_bank_probe.py --sweep, PERF.md)
TILES = ((4, 2, 8), (8, 2, 3))
TILE_STEPS = (256,)
#: every tile of at least 32 conv rows the kernel takes, for scripts/torch_bank_probe.py --sweep
SWEEP_TILES = ((2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2), (8, 2))
#: ring depths for scripts/torch_bank_probe.py --sweep
SWEEP_RINGS = (2, 3, 4, 6, 8)


def resblock_bank_plain(x, bank_params, kernel_sizes, dilations) -> torch.Tensor:
    """The bank as ``F.conv1d`` loops, in the order the JAX flax path computes
    it, in ``x``'s dtype, each conv rounded where the Pallas kernel rounds it
    (:func:`~obs_rvc_tpu_torch.ops._mma.conv_rounded`)."""
    xt = x.transpose(1, 2)  # [B, C, L]
    total = None
    for (w1, b1, w2, b2), k in zip(bank_params, kernel_sizes):
        a = xt
        for s, d in enumerate(dilations):
            t = F.leaky_relu(a, LRELU_SLOPE)
            t = conv_rounded(F.conv1d, t, w1[s].permute(2, 1, 0), b1[s], padding=d * (k - 1) // 2, dilation=d)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = conv_rounded(F.conv1d, t, w2[s].permute(2, 1, 0), b2[s], padding=(k - 1) // 2)
            a = a + t
        total = a if total is None else total + a
    return (total / len(kernel_sizes)).transpose(1, 2)


class PackedBank(NamedTuple):
    """A level's bank params as the CUDA kernel reads them (see
    :func:`pack_bank`), for one activation dtype."""

    dtype: torch.dtype
    device: torch.device
    C: int
    kernel_sizes: tuple
    dilations: tuple
    #: per bank and step ``(W1, b1, W2, b2)``, weights as mma fragments, biases float32
    steps: list
    #: the steps' pointers, four per step, bank-major, as the C entry point takes them
    params: ctypes.Array
    ks: ctypes.Array
    dils: ctypes.Array


def pack_bank(bank_params, kernel_sizes, dilations, dtype: torch.dtype) -> PackedBank:
    """Check a level's bank params and pack them for the kernel in the
    activation ``dtype``: each step's ``[k, C, C]`` conv weights as ``k``
    slabs of one tap's ``C`` in the order of the mma B fragments
    (:func:`~obs_rvc_tpu_torch.ops._mma.pack_taps`: m16n8k8 float32, m16n8k16
    bfloat16); the biases rounded to ``dtype`` as the plain version rounds
    them, and kept in float32."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if len(bank_params) != len(kernel_sizes) or not kernel_sizes or not dilations:
        raise ValueError("resblock_bank: one parameter tuple per kernel size, and at least one dilation")
    S, C = len(dilations), bank_params[0][0].shape[-1]
    if len(kernel_sizes) > CUDA_MAX_BANKS:
        raise NotImplementedError(f"resblock_bank: the CUDA kernel takes at most {CUDA_MAX_BANKS} banks")
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"resblock_bank: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    for k in kernel_sizes:
        if k not in CUDA_KERNEL_SIZES:
            raise NotImplementedError(f"resblock_bank: kernel size {k} not built")
    for d in dilations:
        if not 1 <= d <= CUDA_MAX_DILATION:
            raise NotImplementedError(f"resblock_bank: dilation {d} outside 1..{CUDA_MAX_DILATION}")
    device = bank_params[0][0].device
    steps, ptrs = [], []
    for j, ((w1, b1, w2, b2), k) in enumerate(zip(bank_params, kernel_sizes)):
        if w1.shape != (S, k, C, C) or w2.shape != (S, k, C, C):
            raise ValueError(f"resblock_bank: bank {j} weights must be [{S}, {k}, {C}, {C}]")
        if b1.shape != (S, C) or b2.shape != (S, C):
            raise ValueError(f"resblock_bank: bank {j} biases must be [{S}, {C}]")
        if any(t.device != device for t in (w1, b1, w2, b2)):
            raise ValueError(f"resblock_bank: bank {j} weights on more than one device")
        for s in range(S):
            step = (pack_taps(w1[s], dtype), b1[s].to(dtype).float().contiguous(),
                    pack_taps(w2[s], dtype), b2[s].to(dtype).float().contiguous())
            steps.append(step)
            ptrs += [t.data_ptr() for t in step]
    return PackedBank(dtype, device, C, kernel_sizes, dilations, steps, (ctypes.c_void_p * len(ptrs))(*ptrs),
                      (ctypes.c_int * len(kernel_sizes))(*kernel_sizes), (ctypes.c_int * S)(*dilations))


class BankTiling(NamedTuple):
    """A level's launch shape: blocks of ``warps`` warps of ``wm`` m16 tiles
    each, so ``rows`` = 16 wm warps rows of each conv a block, of which
    ``tile`` = rows - (max k - 1) are its output positions (the rest conv2's
    halo); ``tiles`` a stream; ``blocks`` of a launch before the last (one a
    bank and tile; the last launch has one a tile, unless ``split``: then
    one a bank and tile too, and a sum kernel after it); ``ring`` tap slabs
    of weights in shared memory; the shared memory of the largest launch
    (the largest dilation's)."""

    warps: int
    wm: int
    rows: int
    tile: int
    tiles: int
    blocks: int
    ring: int
    split: bool
    smem_bytes: int


def level_smem(C: int, dtype: torch.dtype, rows: int, kmax: int, d: int, ring: int) -> int:
    """Shared memory of a launch at dilation ``d`` (``csrc/resblock.cu:
    smem_bytes``): the ring of ``ring`` tap slabs of ``C x C`` weights, and
    one plane of rows of ``C`` channels and 16 bytes of padding, lrelu(x)
    over the block's rows and conv1's halo, ``rows + (kmax - 1) d``, which
    then holds conv1's output."""
    elem = 4 if dtype == torch.float32 else 2
    return ring * C * C * elem + (rows + (kmax - 1) * d) * (C * elem + 16)


def bank_tiling(B: int, L: int, C: int, dtype: torch.dtype, n_sms: int = N_SMS, kernel_sizes=(3, 7, 11),
                dilations=(1, 3, 5), tile: Optional[tuple] = None) -> BankTiling:
    """The launch shape of a level ``[B, L, C]``: the tile of :data:`TILES`
    for its positions an SM, or ``tile``, a ``(warps, wm)``, optionally with
    the ring's depth (default :data:`RING`) and ``split`` after them; the
    last step splits where a block a tile would leave fewer than
    :data:`SPLIT_BLOCKS_PER_SM` blocks an SM."""
    if C not in CUDA_CHANNELS:
        raise ValueError(f"bank_tiling: no kernel for C={C}")
    if B < 1 or L < 1:
        raise ValueError(f"bank_tiling: empty level [{B}, {L}, {C}]")
    if tile is None:
        tile = TILES[sum(B * L >= step * n_sms for step in TILE_STEPS)]
    warps, wm, *rest = tile
    kmax, dmax = max(kernel_sizes), max(dilations)
    rows = 16 * wm * warps
    ring = rest[0] if rest else RING
    if wm not in CUDA_WM or not 1 <= warps <= CUDA_MAX_WARPS or rows <= kmax - 1 or not 2 <= ring <= MAX_RING:
        raise ValueError(f"bank_tiling: no kernel for tile {tuple(tile)}")
    smem = level_smem(C, dtype, rows, kmax, dmax, ring)
    if smem > SMEM_CAP:
        raise ValueError(f"bank_tiling: tile {tuple(tile)} takes {smem} bytes of shared memory")
    tl = rows - (kmax - 1)
    tiles = -(-L // tl)
    split = bool(rest[1]) if len(rest) > 1 else B * tiles < SPLIT_BLOCKS_PER_SM * n_sms
    return BankTiling(warps, wm, rows, tl, tiles, len(kernel_sizes) * B * tiles, ring, split, smem)


def bank_tiles(tiling: BankTiling, B: int, L: int, nbanks: int, last: bool = False):
    """The output positions each block of a launch computes, in the kernel's
    order: block ``(r * B + b) * tiles + i`` takes tile ``i`` of stream
    ``b`` for the ``r``-th bank by descending k (the largest k's blocks
    first), and in a last launch that is not split, block ``b * tiles + i``
    takes it for every bank. Yields ``(block, b, r or None, positions)``,
    the positions cut at ``L``."""
    fused = last and not tiling.split
    for blk in range(B * tiling.tiles * (1 if fused else nbanks)):
        r, q = divmod(blk, B * tiling.tiles)
        b, i = divmod(q, tiling.tiles)
        yield blk, b, None if fused else r, range(i * tiling.tile, min(L, (i + 1) * tiling.tile))


def resblock_bank(x, bank_params: Union[list, PackedBank], kernel_sizes, dilations,
                  tile: Optional[tuple] = None) -> torch.Tensor:
    """Fused resblock bank, ``[B, L, C] → [B, L, C]``. ``bank_params`` is the
    dense params for ``x`` on the CPU, and their :func:`pack_bank` in
    ``x.dtype`` for ``x`` on a card; there ``tile``, a ``(warps, wm[, ring[,
    split]])``, overrides :func:`bank_tiling`'s choice."""
    if x.device.type == "cpu":
        if isinstance(bank_params, PackedBank):
            raise ValueError("resblock_bank: on the CPU bank_params are the dense params, not their pack")
        return resblock_bank_plain(x, bank_params, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_bank: unsupported device {x.device}")
    return _resblock_bank_cuda(x, bank_params, tuple(kernel_sizes), tuple(dilations), tile)


def launch_info(C: int, dtype: torch.dtype, tiling: BankTiling, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)) -> dict:
    """The level's launches on the card at its largest dilation: threads,
    shared memory, and for the launches before the last and the last (a
    block a tile, every bank), registers a thread and the blocks an SM holds
    (CUDA's occupancy query)."""
    fn = _cuda.function("resblock", "rvc_resblock_launch_info", [ctypes.c_int] * 7 + [ctypes.c_void_p])
    out = (ctypes.c_int * 6)()
    _cuda.check(fn(C, 0 if dtype == torch.float32 else 1, tiling.warps, tiling.wm, tiling.ring, max(kernel_sizes),
                   max(dilations), ctypes.cast(out, ctypes.c_void_p)), f"resblock launch info (C={C}, {tiling})")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm", "registers_last", "blocks_per_sm_last"),
                    out))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _resblock_bank_cuda(x, packed: PackedBank, kernel_sizes, dilations, tile: Optional[tuple] = None) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("resblock_bank: x must be a contiguous [B, L, C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resblock_bank: unsupported dtype {x.dtype}")
    B, L, C = x.shape
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"resblock_bank: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    if not isinstance(packed, PackedBank):
        raise ValueError("resblock_bank: on a card the bank params must be packed by pack_bank")
    if packed.dtype != x.dtype or packed.C != C:
        raise ValueError("resblock_bank: the packed params do not match x's dtype or channels")
    if packed.kernel_sizes != kernel_sizes or packed.dilations != dilations:
        raise ValueError("resblock_bank: the packed params are for other kernel sizes or dilations")
    if packed.device != x.device:
        raise ValueError("resblock_bank: the packed params must be on the activation's device")
    if L < 1 or B < 1:
        raise ValueError(f"resblock_bank: empty input {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("resblock_bank: x must be 16-byte aligned (the kernel stages it by cp.async)")
    tl = bank_tiling(B, L, C, x.dtype, _sms(x.device), kernel_sizes, dilations, tile)
    fn = _cuda.function("resblock", "rvc_resblock_bank",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])
    out = torch.empty_like(x)
    S, nbanks = len(dilations), len(kernel_sizes)
    # each bank's activation between its steps, in two buffers taken in turns; a split last step's outputs
    tmp = torch.empty((min(S - 1, 2), nbanks, B, L, C), dtype=x.dtype, device=x.device) if S > 1 else None
    sums = torch.empty((nbanks, B, L, C), dtype=torch.float32, device=x.device) if tl.split else None
    # the packed params lie on packed.device, checked above
    with _cuda.on_device_of(x, out, tmp, sums, what="resblock_bank"):
        rc = fn(_cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(tmp), _cuda.ptr(sums),
                ctypes.cast(packed.params, ctypes.c_void_p), nbanks, S, ctypes.cast(packed.ks, ctypes.c_void_p),
                ctypes.cast(packed.dils, ctypes.c_void_p), B, L, C, 0 if x.dtype == torch.float32 else 1, tl.warps,
                tl.wm, tl.ring, _cuda.stream_of(x))
    _cuda.check(rc, f"resblock_bank (C={C}, k={kernel_sizes}, d={dilations}, {tl})")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out
