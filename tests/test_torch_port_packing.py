"""The host-side packing the CUDA kernels read, checked on the CPU.

- ``ops/stft_mel.py:pack_mel_basis``: the log-mel kernel's sparse basis
  (each row's run of weights from its first to its last nonzero bin, cut
  into pieces of at most ``PIECE`` weights) rebuilds the dense basis
  exactly, for the step's HTK basis, a Slaney-scale one, a random dense one
  and one of 80 rows.
- ``ops/_mma.py:pack_taps``: both tensor-core kernels' weights in the order
  of their B fragments, ``m16n8k8`` float32 (split in the kernel) or
  ``m16n8k16`` bfloat16, each tap's Cin padded to the K step, a tap one slab
  of K steps; a bank conv's ``[k, C, C]`` packs tap by tap.
- ``ops/unet_block.py:pack_chain``: the chain's packed weights unpack to
  the folded weights.
- ``models/rmvpe.py:_Chain`` repacks when a parameter changes.
- ``ops/resblock.py:pack_bank``: the bank kernel's weights, a ``[k, C, C]``
  conv as ``k`` slabs of one tap's ``C`` in the k16 (bfloat16) or k8
  (float32) fragment order, unpack to the bank params;
  ``models/synthesizer.py:GeneratorNSF`` stacks and packs each level's banks
  once per weight version, and gives the same audio as before and as the
  JAX package's generator.

The kernels themselves run only on a card (``test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram, mel_filterbank
from obs_rvc_tpu_torch.models.rmvpe import _Chain
from obs_rvc_tpu_torch.ops import _mma as M
from obs_rvc_tpu_torch.ops import resblock as R
from obs_rvc_tpu_torch.ops import stft_mel
from obs_rvc_tpu_torch.ops import unet_block as U

from test_torch_port_models import SYNTH_SMALL, _synth_case
from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)


def unpack_mel_basis(packed: stft_mel.PackedMelBasis) -> torch.Tensor:
    """The dense ``[n_mels, n_bins]`` basis a packed one stands for."""
    starts, offs = packed.row_start.tolist(), packed.row_off.tolist()
    w = packed.weights.cpu()
    out = torch.zeros((len(starts), packed.n_bins), dtype=torch.float32)
    for m, lo in enumerate(starts):
        out[m, lo : lo + offs[m + 1] - offs[m]] = w[offs[m] : offs[m + 1]]
    return out


def unpack_taps(frag: torch.Tensor, taps: int, cin: int) -> torch.Tensor:
    """The float32 weight ``[taps, cin, C]`` that ``M.pack_taps`` packed:
    float32 fragments hold rows ``k = 4 i + t`` of a k8 step, bfloat16 ones
    ``k = 8 h + 2 t + i`` of a k16 step, at lane ``4 g + t``."""
    nk, nt = frag.shape[:2]
    if frag.dtype == torch.float32:
        w, ks = frag.reshape(nk, nt, 8, 4, 2).permute(0, 4, 3, 1, 2), 8
    else:
        w, ks = frag.float().reshape(nk, nt, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2), 16
    return w.reshape(taps, nk * ks // taps, nt * 8)[:, :cin]


def _bases():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((128, 513)).astype(np.float32)
    dense[:, 0] = 0.0  # a leading zero column, so rows start past bin 0
    holes = mel_filterbank(16000, 1024, 128, 30.0, 8000.0).copy()
    holes[5] = 0.0  # an empty row
    holes[7, 40:45] = 0.0  # zeros inside a row's run
    return {
        "htk": mel_filterbank(16000, 1024, 128, 30.0, 8000.0, htk=True),
        "slaney": mel_filterbank(16000, 1024, 128, 30.0, 8000.0, htk=False),
        "dense": dense,
        "mels80": mel_filterbank(16000, 1024, 80, 40.0, 7600.0),
        "holes": holes,
    }


@pytest.mark.parametrize("name", ["htk", "slaney", "dense", "mels80", "holes"])
def test_packed_mel_basis_rebuilds_the_dense_basis(name):
    basis = torch.from_numpy(_bases()[name])
    packed = stft_mel.pack_mel_basis(basis)
    assert packed.row_start.dtype == packed.row_off.dtype == packed.pieces.dtype == torch.int32
    torch.testing.assert_close(unpack_mel_basis(packed), basis, rtol=0, atol=0)
    # every piece of rows fits the kernel's shared-memory stage, and they cover the rows in order
    cuts, offs = packed.pieces.tolist(), packed.row_off.tolist()
    assert cuts[0] == 0 and cuts[-1] == basis.shape[0] and cuts == sorted(set(cuts))
    assert all(offs[b] - offs[a] <= stft_mel.PIECE for a, b in zip(cuts, cuts[1:]))
    starts = packed.row_start.tolist()
    assert all(0 <= s and s + offs[m + 1] - offs[m] <= basis.shape[1] for m, s in enumerate(starts))


def test_the_step_basis_packs_small_and_in_one_piece():
    """The default basis is triangles: ~1000 weights, one shared-memory stage."""
    mel = MelSpectrogram(device="cpu")
    assert mel.log_mel_basis is mel.mel_basis  # the CPU's plain version takes the dense basis
    packed = stft_mel.pack_mel_basis(mel.mel_basis)  # what a MelSpectrogram on a card holds
    nnz = int((mel.mel_basis != 0).sum())
    assert packed.weights.numel() >= nnz and 4 * packed.weights.numel() < 5 * 1024
    assert packed.pieces.tolist() == [0, 128]
    dense = stft_mel.pack_mel_basis(torch.from_numpy(_bases()["dense"]))
    assert dense.pieces.numel() - 1 == -(-128 * 512 // stft_mel.PIECE)


def test_log_mel_cuda_wrapper_checks_the_packed_basis():
    """The checks a CUDA launch runs first, exercised without a card."""
    mel = MelSpectrogram(device="cpu")
    x = torch.zeros(10080)
    packed = stft_mel.pack_mel_basis(mel.mel_basis)
    with pytest.raises(ValueError, match="pack_mel_basis"):  # the kernel takes only the packed form
        stft_mel._log_mel_cuda(x, mel.mel_basis, mel.window, 160, 1e-5)
    with pytest.raises(ValueError, match="513 bins"):
        stft_mel._log_mel_cuda(x, stft_mel.pack_mel_basis(torch.ones(128, 257)), mel.window, 160, 1e-5)
    on_meta = stft_mel.PackedMelBasis(*(t.to("meta") for t in packed[:4]), packed.n_bins)
    with pytest.raises(ValueError, match="device"):
        stft_mel._log_mel_cuda(x, on_meta, mel.window, 160, 1e-5)
    with pytest.raises(ValueError, match="dense"):  # and the plain version only the dense one
        stft_mel.log_mel(x, packed, mel.window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,C", [(1, 16), (3, 32), (16, 16), (24, 16), (64, 32)])
def test_packed_taps_unpack_and_follow_the_fragment_order(cin, C, dtype):
    """A 3x3 weight packs as 9 taps of Cin padded with zeros to the K step
    (8 in float32, 16 in bfloat16), K = tap * Cinp + ci."""
    rng = np.random.default_rng(cin * 100 + C + 7)
    w = torch.from_numpy(rng.standard_normal((9, cin, C)).astype(np.float32))
    frag = M.pack_taps(w, dtype)
    ks = M.k_step(dtype)
    cinp = -(-cin // ks) * ks
    assert frag.shape == (9 * cinp // ks, C // 8, 32, 2 if dtype == torch.float32 else 4) and frag.dtype == dtype
    want = w if dtype == torch.float32 else w.to(dtype).float()
    torch.testing.assert_close(unpack_taps(frag, 9, cin), want, rtol=0, atol=0)
    # lane 4g + t of the n8 tile nt at K step kb holds column nt*8 + g at rows
    # (t, t+4) of a k8 step in float32, (2t, 2t+1, 2t+8, 2t+9) of a k16 step
    # in bfloat16; the padded channels are zero
    wp = torch.cat([want, torch.zeros(9, cinp - cin, C)], dim=1).reshape(9 * cinp, C)
    for kb, nt, lane in [(0, 0, 0), (cinp // ks, C // 8 - 1, 31), (9 * cinp // ks - 1, 1, 13)]:
        g, t, n = lane // 4, lane % 4, nt * 8 + lane // 4
        k0 = kb * ks
        rows = [k0 + t, k0 + t + 4] if dtype == torch.float32 else [k0 + 2 * t, k0 + 2 * t + 1, k0 + 2 * t + 8,
                                                                      k0 + 2 * t + 9]
        assert frag[kb, nt, lane].float().tolist() == wp[rows, n].tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,C", [(3, 16), (7, 32), (11, 64), (3, 64)])
def test_packed_weight_unpacks_and_follows_the_fragment_order(k, C, dtype):
    """A bank conv's ``[k, C, C]`` weight packs tap by tap: tap t's
    fragments are one slab of C / ks K steps (the slab the bank kernel
    streams into its ring), the tap's own weight packed alone, and lane
    ``4 g + t`` of a k16 step holds four bf16 of column g (two float32 of a
    k8 step)."""
    rng = np.random.default_rng(k * 100 + C)
    w = torch.from_numpy(rng.standard_normal((k, C, C)).astype(np.float32))
    frag = M.pack_taps(w, dtype)
    ks = M.k_step(dtype)
    assert frag.shape == (k * C // ks, C // 8, 32, 2 if dtype == torch.float32 else 4) and frag.dtype == dtype
    want = w if dtype == torch.float32 else w.to(dtype).float()
    torch.testing.assert_close(unpack_taps(frag, k, C), want, rtol=0, atol=0)
    for tap in (0, k // 2, k - 1):
        slab = frag[tap * C // ks : (tap + 1) * C // ks]
        assert torch.equal(slab, M.pack_taps(w[tap : tap + 1], dtype))
    # lane 4g + t of n8 tile nt at K step kb of tap 1: column nt*8 + g, rows 2t, 2t+1, 2t+8, 2t+9 (bf16) or
    # t, t+4 (float32) of the step's channels
    kb, nt, lane = C // ks + 1 if C > ks else C // ks, C // 8 - 1, 13
    g, t, n = lane // 4, lane % 4, nt * 8 + lane // 4
    c0 = (kb % (C // ks)) * ks
    rows = [c0 + t, c0 + t + 4] if dtype == torch.float32 else [c0 + 2 * t, c0 + 2 * t + 1, c0 + 2 * t + 8,
                                                                 c0 + 2 * t + 9]
    assert frag[kb, nt, lane].float().tolist() == want[1, rows, n].tolist()


def _chain(in_ch, out_ch, seed=0):
    torch.manual_seed(seed)
    chain = _Chain(in_ch, out_ch, 3, fused=True).eval()
    with torch.no_grad():
        for blk in chain:  # BatchNorm statistics away from the identity, so folding shows
            for bn in (blk.conv[1], blk.conv[4]):
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.normal_(0, 0.1)
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.5)
    return chain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_chain_unpacks_to_the_folded_weights(dtype):
    chain = _chain(32, 16)
    blocks = chain._blocks()
    packed = chain._packed(dtype)
    assert packed.dtype == dtype and packed.C == 16 and packed.cin == 32 and len(packed.params) == 6 * 3
    for (w1, b1, w2, b2, wsc, bsc), (f1, c1, f2, c2, fsc, csc) in zip(blocks, packed.blocks):
        cin = w1.shape[2]
        for w, f, taps in ((w1, f1, 9), (w2, f2, 9), (wsc, fsc, 1)):
            if w is None:
                assert f is None
                continue
            w = w.reshape(taps, -1, 16)
            want = w if dtype == torch.float32 else w.to(dtype).float()
            torch.testing.assert_close(unpack_taps(f, taps, w.shape[1]), want, rtol=0, atol=0)
        for b, c in ((b1, c1), (b2, c2), (bsc, csc)):
            if b is not None:
                assert c.dtype == torch.float32
                torch.testing.assert_close(c, b.to(dtype).float(), rtol=0, atol=0)
        assert (wsc is None) == (cin == 16)
    # the pointer table the C entry point walks: six per block, null for an identity shortcut
    assert [p or 0 for p in packed.params[6:12]][4:] == [0, 0]
    assert packed.params[0] == packed.blocks[0][0].data_ptr()


def test_chain_repacks_when_a_parameter_changes():
    chain = _chain(16, 32, seed=1)
    first = chain._packed(torch.float32)
    assert chain._packed(torch.float32) is first  # cached per weight version
    bf = chain._packed(torch.bfloat16)
    assert bf is not first and chain._packed(torch.bfloat16) is bf
    with torch.no_grad():
        chain[1].conv[3].weight.mul_(2.0)  # an in-place update bumps _version
    again = chain._packed(torch.float32)
    assert again is not first and chain._packed(torch.bfloat16) is not bf
    w2 = chain._blocks()[1][2].reshape(9, 32, 32)
    torch.testing.assert_close(unpack_taps(again.blocks[1][2], 9, 32), w2, rtol=0, atol=0)
    assert not torch.equal(unpack_taps(first.blocks[1][2], 9, 32), w2)
    with torch.no_grad():
        chain[0].conv[1].running_var.add_(0.5)  # a buffer too
    assert chain._packed(torch.float32) is not again


def test_chain_cuda_wrapper_checks_the_packed_weights():
    """The checks a CUDA launch runs first, exercised without a card."""
    chain = _chain(16, 16, seed=2)
    blocks = chain._blocks()
    x = torch.zeros((1, 4, 16, 16))
    with pytest.raises(ValueError, match="pack_chain"):  # the kernel takes only the packed form
        U._chain_cuda(x, blocks)
    with pytest.raises(ValueError, match="packed"):
        U._chain_cuda(x, chain._packed(torch.bfloat16))
    with pytest.raises(ValueError, match="packed"):
        U._chain_cuda(torch.zeros((1, 4, 16, 32)), chain._packed(torch.float32))
    with pytest.raises(ValueError, match="folded"):  # and the plain version only the folded blocks
        U.conv_block_res_chain(x, chain._packed(torch.float32))
    bad = [list(b) for b in blocks]
    bad[1][1] = torch.zeros(8)
    with pytest.raises(ValueError, match="bias"):
        U.pack_chain([tuple(b) for b in bad], torch.float32)


def _bank_params(rng, C, ks, S=3):
    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    return [tuple(t(a) for a in (rng.standard_normal((S, k, C, C)) / np.sqrt(k * C), rng.standard_normal((S, C)) * 0.05,
                                 rng.standard_normal((S, k, C, C)) / np.sqrt(k * C), rng.standard_normal((S, C)) * 0.05))
            for k in ks]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_pack_bank_unpacks_to_the_bank_params(C, k, dtype):
    """Each step's [k, C, C] conv weights pack as k slabs of one tap's C (the
    kernel walks K one tap at a time), bf16 in the m16n8k16 fragment order
    and float32 in the m16n8k8 one; the biases are rounded to the
    activation type and kept in float32."""
    ks, dils = (k, 3), (1, 3, 5)
    params = _bank_params(np.random.default_rng(C * 100 + k), C, ks)
    packed = R.pack_bank(params, ks, dils, dtype)
    assert packed.dtype == dtype and packed.C == C and packed.kernel_sizes == ks and packed.dilations == dils
    assert list(packed.ks) == list(ks) and list(packed.dils) == list(dils)
    assert len(packed.steps) == 2 * 3 and len(packed.params) == 4 * 2 * 3
    steps = iter(packed.steps)
    for (w1, b1, w2, b2), kk in zip(params, ks):
        for s in range(3):
            f1, c1, f2, c2 = next(steps)
            for w, f in ((w1[s], f1), (w2[s], f2)):
                ks = M.k_step(dtype)
                assert f.shape == (kk * C // ks, C // 8, 32, 2 if dtype == torch.float32 else 4) and f.dtype == dtype
                want = w if dtype == torch.float32 else w.to(dtype).float()
                torch.testing.assert_close(unpack_taps(f, kk, C), want, rtol=0, atol=0)
            for b, c in ((b1[s], c1), (b2[s], c2)):
                assert c.dtype == torch.float32
                torch.testing.assert_close(c, b.to(dtype).float(), rtol=0, atol=0)
    # the pointer table the C entry point walks: four per step, bank-major
    assert [packed.params[4 * i + j] for i in (0, 5) for j in range(4)] == [
        t.data_ptr() for i in (0, 5) for t in packed.steps[i]]


def _generator(seed=0):
    from obs_rvc_tpu_torch.models.synthesizer import GeneratorNSF, SynthesizerConfig

    torch.manual_seed(seed)
    return GeneratorNSF(SynthesizerConfig(**SYNTH_SMALL)).eval()


def test_generator_repacks_after_a_weight_update_and_not_otherwise():
    gen = _generator()
    levels = [i for i in range(len(gen.ups)) if gen.uses_bank_kernel(gen.ups[i].out_channels)]
    assert levels == [0, 1]
    dense = gen.bank_params(1)
    first = gen.packed_bank(1, torch.float32)
    assert gen.bank_params(1) is dense and gen.packed_bank(1, torch.float32) is first  # cached
    bf = gen.packed_bank(1, torch.bfloat16)
    assert bf is not first and gen.packed_bank(1, torch.bfloat16) is bf and gen.bank_params(1) is dense
    other = gen.packed_bank(0, torch.float32)
    assert other.C == 64 and first.C == 32
    with torch.no_grad():
        gen.resblocks[4].convs2[1].weight.mul_(2.0)  # level 1's second bank; an in-place update bumps _version
    again = gen.packed_bank(1, torch.float32)
    assert again is not first and gen.packed_bank(1, torch.bfloat16) is not bf and gen.bank_params(1) is not dense
    assert gen.packed_bank(0, torch.float32) is other  # level 0's weights did not change
    w2 = gen.resblocks[4].convs2[1].weight.permute(2, 1, 0)
    torch.testing.assert_close(unpack_taps(again.steps[3 + 1][2], 7, 32), w2, rtol=0, atol=0)
    torch.testing.assert_close(gen.bank_params(1)[1][2][1], w2)
    assert not torch.equal(unpack_taps(first.steps[3 + 1][2], 7, 32), w2)
    with torch.no_grad():
        gen.resblocks[3].convs1[0].bias.add_(0.5)  # a bias too
    assert gen.packed_bank(1, torch.float32) is not again


@pytest.mark.parametrize("with_rnd", [True, False])
def test_generator_with_cached_banks_matches_the_uncached_and_jax(with_rnd):
    """The cache changes no output: a forward from the cache equals one that
    stacks the banks anew, and both stay within the synthesizer's bound of
    the JAX package's generator."""
    from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig

    tm, got, want = _synth_case(JSynthesizerConfig(**SYNTH_SMALL), SynthesizerConfig(**SYNTH_SMALL),
                                with_rnd=with_rnd, seed=7)
    gen = tm.dec
    cached = [gen._bank_cache[i] for i in (0, 1)]
    assert all(c is not None for c in cached)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 16, 12)).astype(np.float32))
    f0 = torch.from_numpy(rng.uniform(80.0, 400.0, (1, 12)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 16, 1)).astype(np.float32))
    with torch.no_grad():
        y = gen(x, f0, g)
        assert [gen._bank_cache[i] for i in (0, 1)] == cached and gen._bank_cache[0] is cached[0]  # no restack
        gen._bank_cache = [None] * len(gen._bank_cache)
        fresh = gen(x, f0, g)
    torch.testing.assert_close(y, fresh, rtol=0, atol=0)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_bank_cuda_wrapper_checks_the_packed_params():
    """The checks a CUDA launch runs first, exercised without a card."""
    ks, dils = (3, 7, 11), (1, 3, 5)
    rng = np.random.default_rng(3)
    params = _bank_params(rng, 32, ks)
    packed = R.pack_bank(params, ks, dils, torch.float32)
    x = torch.zeros((1, 40, 32))
    with pytest.raises(ValueError, match="pack_bank"):  # the kernel takes only the packed form
        R._resblock_bank_cuda(x, params, ks, dils)
    with pytest.raises(ValueError, match="packed"):
        R._resblock_bank_cuda(x, R.pack_bank(params, ks, dils, torch.bfloat16), ks, dils)
    with pytest.raises(ValueError, match="packed"):
        R._resblock_bank_cuda(torch.zeros((1, 40, 64)), packed, ks, dils)
    with pytest.raises(ValueError, match="packed"):
        R._resblock_bank_cuda(torch.zeros((1, 40, 16)), packed, ks, dils)
    with pytest.raises(ValueError, match="device"):
        R._resblock_bank_cuda(x, packed._replace(device=torch.device("meta")), ks, dils)
    with pytest.raises(ValueError, match="kernel sizes or dilations"):
        R._resblock_bank_cuda(x, packed, ks, (1, 2, 4))
    with pytest.raises(ValueError, match="contiguous"):
        R._resblock_bank_cuda(torch.zeros((40, 32)), packed, ks, dils)
    with pytest.raises(ValueError, match="empty"):
        R._resblock_bank_cuda(torch.zeros((1, 0, 32)), packed, ks, dils)
    with pytest.raises(ValueError, match="dense"):  # and the plain version only the dense params
        R.resblock_bank(x, packed, ks, dils)
    # pack_bank checks the shapes and refuses what no kernel is built for
    bad = [list(p) for p in params]
    bad[1][3] = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="biases"):
        R.pack_bank([tuple(p) for p in bad], ks, dils, torch.float32)
    with pytest.raises(ValueError, match="weights"):
        R.pack_bank(params, (3, 3, 11), dils, torch.float32)
    with pytest.raises(ValueError, match="one parameter tuple"):
        R.pack_bank(params[:2], ks, dils, torch.float32)
    with pytest.raises(NotImplementedError, match="C in"):
        R.pack_bank(_bank_params(rng, 8, ks), ks, dils, torch.float32)
    with pytest.raises(NotImplementedError, match="kernel size"):
        R.pack_bank(_bank_params(rng, 16, (5,)), (5,), dils, torch.float32)
    with pytest.raises(NotImplementedError, match="dilation"):
        R.pack_bank(_bank_params(rng, 16, (3,), S=1), (3,), (6,), torch.float32)
