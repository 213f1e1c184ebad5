"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These run only where a CUDA card is present; elsewhere each test skips with
the reason (the kernels have no CPU mode, and their plain versions are held
against the JAX package's Pallas kernels in ``test_torch_port_kernels.py``).
They cover what ``chip_smoke.py``'s main-path shapes do not: batches, ragged
tile edges, every channel count the kernels are built for, and the launch
counters. On a machine with a card, run them as::

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
from obs_rvc_tpu_torch.ops import resblock, stft_mel, unet_block

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
    """For each kind of norm the networks use (PyTorch's LayerNorm and
    BatchNorm2d, the port's GroupNorm and VitsLayerNorm), in bfloat16 on
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


def _bank(rng, B, L, C, ks, device):
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    params = [tuple(t(a) for a in (
        rng.standard_normal((3, k, C, C)) / np.sqrt(k * C), rng.standard_normal((3, C)) * 0.05,
        rng.standard_normal((3, k, C, C)) / np.sqrt(k * C), rng.standard_normal((3, C)) * 0.05))
        for k in ks]
    return t(rng.standard_normal((B, L, C)) * 0.5), params


def _length(L, C, dtype):
    """``L``, or for "TL-1" / "TL" / "TL+1" the kernel's tile length plus the offset."""
    if isinstance(L, int):
        return L
    return resblock.launch_info(C, 3, 1, dtype)["tile"] + int(L[2:] or 0)


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
    (64, 7000, 1, (1, 3, 5)),  # the main path's two levels
    (32, 14000, 1, (1, 3, 5)),
])
def test_resblock_bank_kernel_matches_plain(cuda, C, L, B, dil, dtype):
    ks = (3, 7, 11)
    L = _length(L, C, dtype)
    x, params = _bank(np.random.default_rng(C + L), B, L, C, ks, cuda)
    x = x.to(dtype)
    packed = resblock.pack_bank(params, ks, dil, dtype)  # as GeneratorNSF caches it per weight version
    before = resblock.LAUNCHES
    got = resblock.resblock_bank(x, packed, ks, dil)
    assert resblock.LAUNCHES == before + 1  # one C call runs the whole bank
    want = resblock.resblock_bank_plain(x, params, ks, dil)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, L, C) and got.dtype == dtype
    _close(got, want, *BOUNDS["bank"][dtype])


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
])
def test_unet_chain_kernel_matches_plain(cuda, cin, C, H, W, B, dtype):
    x, blocks = _chain(np.random.default_rng(cin * 100 + C), B, H, W, cin, C, 3, cuda)
    x = x.to(dtype)
    got = unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, dtype))
    want = unet_block.conv_block_res_chain_plain(x, blocks)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, H, W, C) and got.dtype == dtype
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
    rng = np.random.default_rng(1)
    x, params = _bank(rng, 1, 64, 8, (3, 7, 11), cuda)
    with pytest.raises(NotImplementedError):
        resblock.pack_bank(params, (3, 7, 11), (1, 3, 5), x.dtype)
    x, params = _bank(rng, 1, 64, 16, (3, 7, 11), cuda)
    with pytest.raises(ValueError, match="pack_bank"):  # on a card the kernel takes only the pack
        resblock.resblock_bank(x, params, (3, 7, 11), (1, 3, 5))
    x, blocks = _chain(rng, 1, 8, 16, 8, 64, 1, cuda)
    with pytest.raises(NotImplementedError):
        unet_block.conv_block_res_chain(x, unet_block.pack_chain(blocks, x.dtype))
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
