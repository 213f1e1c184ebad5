"""CREPE's first two blocks, conv → ReLU → BatchNorm (eval) → max-pool 2,
in bfloat16 on the tensor cores (``csrc/crepe_conv.cu``): conv1 (1 → C
channels, kernel 512, stride 4, over a 1024-sample frame) by
:func:`block_frames`, conv2 (Cin → 128 channels, kernel 64, over 128
positions) by :func:`block_taps`. It replaces no kernel of the JAX package
(which leaves CREPE to XLA): it takes these two convolutions off cuDNN's
deterministic kernels, which run conv2 without the tensor cores.

The arithmetic: bfloat16 operands, float32 products and sums, then in
float32 the bias, ReLU and the norm folded to ``v * scale + shift``
(:func:`fold`), the larger of each pooled pair, one rounding to bfloat16.
Layouts: conv1 writes ``[N, C / 8, 128, 8]`` (channels-last, blocked by 8
channels: each 16-byte row of 8 channels is what the kernel copies), which
conv2 reads; conv2 writes ``[N, 128, 64]``, the ``[N, C, L]`` of the
blocks after it. :func:`to_blocked` and :func:`from_blocked` convert.

Which convolutions take it (:func:`takes_kernel`, by the conv's shape and
the activation's dtype, never by a ``try``): in bfloat16, in eval mode,
conv1's shape with C a multiple of 128 (``full``'s 1024, ``tiny``'s 128)
and conv2's shape with Cin a multiple of 64 and 128 outputs (``full``'s).
conv3–conv6 (64 positions a frame or fewer), ``tiny``'s conv2 (16 outputs)
and float32 stay on cuDNN.

Each wrapper runs the plain version on a CPU tensor and the kernel on a
CUDA tensor, with the dense params (:func:`fold`) on the CPU and their
:func:`pack` on a card; ``LAUNCHES`` counts the calls that launched the
kernel. conv2 splits K over :func:`taps_splits` parts, summed in a fixed
order by a second kernel, so a launch repeats bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda

#: wrapper calls that launched the CUDA kernel
LAUNCHES = 0

FRAME = 1024
FRAME_TAPS, FRAME_STRIDE, FRAME_PAD = 512, 4, 254
TAPS, TAP_PADS = 64, (31, 32)
#: conv2's positions a frame (conv1's 256 pooled); conv2's own are pooled to ROWS // 2
ROWS = 128
#: output channels of the kernel's tile, input channels of conv2's staged slab, K values of a stage
BN, SLAB, STAGE_K = 128, 64, 64
#: frames of one conv2 block (csrc/crepe_conv.cu:TAP_FRAMES)
TAP_FRAMES = 2
#: the H100 SXM's SMs (a card reports its own count)
N_SMS = 132


class Folded(NamedTuple):
    """A block's conv and norm as the plain version takes them: the conv's
    weight ``[C, Cin, k]`` and bias in float32 (the network's values, so in
    bfloat16 the bfloat16 ones), and the norm as ``scale``, ``shift``."""

    w: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


class Packed(NamedTuple):
    """A block's params as the kernel reads them (:func:`pack`)."""

    kind: str  # "frames" (conv1) or "taps" (conv2)
    device: torch.device
    cin: int
    cout: int
    #: the weight in stages of 64 K values x 128 outputs, each in wgmma's K-major layout, bfloat16
    w: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def fold(conv: torch.nn.Module, bn: torch.nn.Module) -> Folded:
    """A ``Conv2d`` with a ``(k, 1)`` kernel and the ``BatchNorm1d`` after it
    (eval) as :class:`Folded`: ``scale = weight / sqrt(running_var + eps)``,
    ``shift = bias - running_mean * scale``, in float32."""
    with torch.no_grad():
        scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
        shift = bn.bias.float() - bn.running_mean.float() * scale
        return Folded(conv.weight[..., 0].float().contiguous(), conv.bias.float().contiguous(), scale.contiguous(),
                      shift.contiguous())


def takes_kernel(conv: torch.nn.Module, dtype: torch.dtype, training: bool, positions: int) -> str:
    """``"frames"`` or ``"taps"`` where the block of ``conv`` over an input
    of ``positions`` (conv1: samples a frame; the others: positions a frame)
    runs on the kernel in ``dtype``, else ``""`` (cuDNN)."""
    if dtype != torch.bfloat16 or training or conv.bias is None:
        return ""
    cin, cout = conv.in_channels, conv.out_channels
    k, s = conv.kernel_size, conv.stride
    if (k, s, cin, positions) == ((FRAME_TAPS, 1), (FRAME_STRIDE, 1), 1, FRAME) and cout % BN == 0:
        return "frames"
    if (k, s, cout, positions) == ((TAPS, 1), (1, 1), BN, ROWS) and cin % SLAB == 0:
        return "taps"
    return ""


def to_blocked(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, L]`` → ``[N, C / 8, L, 8]``, contiguous."""
    N, C, L = x.shape
    return x.reshape(N, C // 8, 8, L).transpose(2, 3).contiguous()


def from_blocked(x: torch.Tensor) -> torch.Tensor:
    """``[N, C / 8, L, 8]`` → ``[N, C, L]``, contiguous."""
    N, C8, L, _ = x.shape
    return x.transpose(2, 3).reshape(N, C8 * 8, L)


def _epilogue(y: torch.Tensor, p: Folded) -> torch.Tensor:
    """The kernel's epilogue on float32 sums ``[N, C, L]``: bias, ReLU, the
    folded norm, max-pool 2, one rounding to bfloat16."""
    y = torch.relu(y + p.bias[:, None]) * p.scale[:, None] + p.shift[:, None]
    return F.max_pool1d(y, 2, 2).to(torch.bfloat16)


def block_frames_plain(frames: torch.Tensor, p: Folded) -> torch.Tensor:
    """conv1's block as the kernel computes it: ``[N, 1024]`` bfloat16 →
    ``[N, C / 8, 128, 8]`` bfloat16."""
    y = F.conv1d(frames.float()[:, None], p.w, stride=FRAME_STRIDE, padding=FRAME_PAD)
    return to_blocked(_epilogue(y, p))


def block_taps_plain(x: torch.Tensor, p: Folded, splits: int = 1) -> torch.Tensor:
    """conv2's block as the kernel computes it: ``[N, Cin / 8, 128, 8]``
    bfloat16 → ``[N, 128, 64]`` bfloat16. With ``splits``, the convolution
    over each ``Cin / splits`` input channels apart, the parts added in
    order, as the kernel's split K adds them."""
    xp = F.pad(from_blocked(x).float(), TAP_PADS)
    cs = p.w.shape[1] // splits
    y = None
    for s in range(splits):
        part = F.conv1d(xp[:, s * cs : (s + 1) * cs], p.w[:, s * cs : (s + 1) * cs])
        y = part if y is None else y + part
    return _epilogue(y, p)


def pack_weight(w: torch.Tensor, kind: str) -> torch.Tensor:
    """A conv weight ``[C, Cin, k]`` in the stages the kernel walks, each 64
    K values x 128 output channels in wgmma's K-major layout without
    swizzle, ``[4 K steps, 16 n8 tiles, 2 K halves, 8 outputs, 8 K values]``
    (core matrices of 128 contiguous bytes, 128 apart along K, 256 along N):
    conv1 (``"frames"``, K = the 512 taps) ``[C / 128, 8 stages, ...]``, a
    block of 128 outputs after another; conv2 (``"taps"``, K = tap, channel)
    ``[Cin / 64 slabs, 64 taps, ...]``. Returns bfloat16 ``[stages, 8192]``."""
    C, cin, k = w.shape
    w = w.to(torch.bfloat16)
    if kind == "frames":  # k = 64 ks + 16 kk + 8 h + e; output 128 nb + 8 j + n
        t = w.reshape(C // BN, 16, 8, k // STAGE_K, 4, 2, 8).permute(0, 3, 4, 1, 5, 2, 6)
    else:  # input channel 64 slab + 16 kk + 8 h + e at tap k; output 8 j + n
        t = w.reshape(16, 8, cin // SLAB, 4, 2, 8, k).permute(2, 6, 3, 0, 4, 1, 5)
    return t.reshape(-1, STAGE_K * BN).contiguous()


def pack(p: Folded, kind: str) -> Packed:
    """:class:`Folded` params as the kernel reads them, on their device."""
    C, cin, k = p.w.shape
    if kind not in ("frames", "taps"):
        raise ValueError(f"crepe_conv.pack: no kernel {kind!r}")
    if kind == "frames" and (cin, k) != (1, FRAME_TAPS) or kind == "taps" and k != TAPS or C % BN:
        raise ValueError(f"crepe_conv.pack: no {kind!r} kernel for a [{C}, {cin}, {k}] weight")
    if kind == "taps" and (C != BN or cin % SLAB):
        raise ValueError(f"crepe_conv.pack: the taps kernel takes {BN} outputs and Cin a multiple of {SLAB}")
    return Packed(kind, p.w.device, cin, C, pack_weight(p.w, kind), p.bias, p.scale, p.shift)


def taps_splits(N: int, cin: int, n_sms: int = N_SMS) -> int:
    """conv2's split of K at ``N`` frames: the largest power of two that
    divides Cin's slabs of 64 and keeps the blocks (two frames each) times
    the split within the SMs; 1 where the blocks alone fill them."""
    slabs, tiles = cin // SLAB, -(-N // TAP_FRAMES)
    s = 1
    while slabs % (2 * s) == 0 and tiles * 2 * s <= n_sms:
        s *= 2
    return s


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, what: str, shape: tuple) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bfloat16, got {x.dtype}")
    if tuple(x.shape[1:]) != shape or x.shape[0] < 1:
        raise ValueError(f"{what}: the input must be [N, {', '.join(map(str, shape))}], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: the input must be contiguous and 16-byte aligned (the kernel copies its rows "
                         "in bulk)")


def _check_packed(x: torch.Tensor, params, kind: str, what: str) -> None:
    if not isinstance(params, Packed) or params.kind != kind:
        raise ValueError(f"{what}: on a card the params must be pack(fold(...), {kind!r})")
    if params.device != x.device:
        raise ValueError(f"{what}: the packed params must be on the input's device")


def block_frames(frames: torch.Tensor, params) -> torch.Tensor:
    """conv1's block, ``[N, 1024]`` bfloat16 → ``[N, C / 8, 128, 8]``:
    ``params`` :class:`Folded` for a CPU tensor, its :func:`pack` for a CUDA
    one."""
    if frames.device.type == "cpu":
        if isinstance(params, Packed):
            raise ValueError("crepe_conv.block_frames: on the CPU params are fold(...), not a pack")
        return block_frames_plain(frames, params)
    if frames.device.type != "cuda":
        raise ValueError(f"crepe_conv.block_frames: unsupported device {frames.device}")
    return _frames_cuda(frames, params)


def block_taps(x: torch.Tensor, params) -> torch.Tensor:
    """conv2's block, ``[N, Cin / 8, 128, 8]`` bfloat16 → ``[N, 128, 64]``:
    ``params`` :class:`Folded` for a CPU tensor (one part), its :func:`pack`
    for a CUDA one."""
    if x.device.type == "cpu":
        if isinstance(params, Packed):
            raise ValueError("crepe_conv.block_taps: on the CPU params are fold(...), not a pack")
        return block_taps_plain(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"crepe_conv.block_taps: unsupported device {x.device}")
    return _taps_cuda(x, params)


def _count() -> None:
    global LAUNCHES
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1


def _frames_cuda(frames: torch.Tensor, p: Packed) -> torch.Tensor:
    what = "crepe_conv.block_frames"
    _check(frames, what, (FRAME,))
    _check_packed(frames, p, "frames", what)
    N = frames.shape[0]
    out = torch.empty((N, p.cout // 8, ROWS, 8), dtype=torch.bfloat16, device=frames.device)
    fn = _cuda.function("crepe_conv", "rvc_crepe_conv_frames", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
    with _cuda.on_device_of(frames, out, what=what):
        rc = fn(_cuda.ptr(frames), _cuda.ptr(p.w), _cuda.ptr(p.bias), _cuda.ptr(p.scale), _cuda.ptr(p.shift),
                _cuda.ptr(out), N, p.cout, _cuda.stream_of(frames))
    _cuda.check(rc, f"{what} (N={N}, C={p.cout})")
    _count()
    return out


def _taps_cuda(x: torch.Tensor, p: Packed) -> torch.Tensor:
    what = "crepe_conv.block_taps"
    _check_packed(x, p, "taps", what)
    _check(x, what, (p.cin // 8, ROWS, 8))
    N = x.shape[0]
    splits = taps_splits(N, p.cin, _sms(x.device))
    out = torch.empty((N, p.cout, ROWS // 2), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, N, ROWS, p.cout), dtype=torch.float32, device=x.device) if splits > 1
               else None)
    fn = _cuda.function("crepe_conv", "rvc_crepe_conv_taps", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
    with _cuda.on_device_of(x, out, partial, what=what):
        rc = fn(_cuda.ptr(x), _cuda.ptr(p.w), _cuda.ptr(p.bias), _cuda.ptr(p.scale), _cuda.ptr(p.shift),
                _cuda.ptr(partial), _cuda.ptr(out), N, p.cin, splits, _cuda.stream_of(x))
    _cuda.check(rc, f"{what} (N={N}, Cin={p.cin}, splits={splits})")
    _count()
    return out
