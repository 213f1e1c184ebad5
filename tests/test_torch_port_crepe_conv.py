"""CREPE's conv kernel on the CPU (``ops/crepe_conv.py``): its plain version
against the module's own cuDNN-form block (conv, ReLU, BatchNorm, pool in
bfloat16) at ``full`` and ``tiny`` shapes and at 1, 64 and 130 frames; the
weight packing's round trip; which blocks take the kernel (bfloat16 in eval
at conv1's and conv2's shapes; float32, training and every other block on
cuDNN); the wrappers' refusals; the C calls and the launch count (a
stand-in for the library records its arguments); the split of K and its
parts added in order; the network's forward through the wrappers. The
kernel itself runs only on a card (``test_torch_port_cuda.py``,
``chip_smoke.py``).

The plain version rounds once, after the epilogue in float32; the module's
form rounds the conv's output, the norm's and the pool's. Both are held to
the float32 block of the same bfloat16 operands: the plain version's error
is within the module's own.
"""

import ctypes

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.models.crepe import _PADS, Crepe, CrepeConfig, extract_crepe_frames
from obs_rvc_tpu_torch.ops import crepe_conv as cc

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)


def _model(capacity, seed=0, dtype=torch.bfloat16):
    """CREPE with fan-in weights and drawn conv biases and norms (weights of either sign), in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    model = Crepe(CrepeConfig(capacity)).eval()
    with torch.no_grad():
        for i in range(1, 7):
            conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
            fan_in = conv.in_channels * conv.kernel_size[0]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / fan_in**0.5)
            C = conv.out_channels
            conv.bias.copy_(torch.randn(C, generator=gen) * 0.1)
            bn.weight.copy_(torch.randn(C, generator=gen))
            bn.bias.copy_(torch.randn(C, generator=gen) * 0.1)
            bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(C, generator=gen) * 1.5 + 0.5)
    return model.to(dtype)


def _frames(N, seed=0):
    """``N`` normalised frames of a gliding tone in noise, bfloat16."""
    t = torch.arange(160 * (N - 1) + 1) / 16000.0
    f = 190.0 * 2 ** torch.sin(2 * torch.pi * 0.7 * t)
    x = 0.3 * torch.sin(2 * torch.pi * torch.cumsum(f, 0) / 16000.0)
    x = x + 0.02 * torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))
    return extract_crepe_frames(x[None], N)[0].to(torch.bfloat16).contiguous()


def _module_block(model, i, x_ncl):
    """Block ``i`` (1-based) as the module computes it on cuDNN's path: ``[N, C, L]`` → ``[N, C', L']``."""
    conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
    y = conv(F.pad(x_ncl, _PADS[i - 1])[..., None])[..., 0]
    return F.max_pool1d(bn(F.relu(y)), 2, 2)


def _f32_block(folded, x_ncl, i, stride):
    """The block in float32 on the same bfloat16 operands (the norm folded), not rounded."""
    y = F.conv1d(F.pad(x_ncl.float(), _PADS[i - 1]), folded.w, stride=stride)
    return F.max_pool1d(torch.relu(y + folded.bias[:, None]) * folded.scale[:, None] + folded.shift[:, None], 2, 2)


# (capacity, block, frames): full's conv1 and conv2 and tiny's conv1 (its conv2, 16 outputs, stays on cuDNN)
CASES = [(cap, blk, N) for cap, blk in (("full", 1), ("full", 2), ("tiny", 1)) for N in (1, 64, 130)]


@pytest.mark.parametrize("capacity,block,N", CASES)
def test_plain_block_is_within_the_modules_own_rounding(capacity, block, N):
    model = _model(capacity, seed=block)
    frames = _frames(N, seed=N)
    conv, bn = getattr(model, f"conv{block}"), getattr(model, f"conv{block}_BN")
    folded = cc.fold(conv, bn)
    with torch.no_grad():
        if block == 1:
            x_ncl = frames[:, None]
            got = cc.from_blocked(cc.block_frames(frames, folded))
        else:
            x = cc.block_frames_plain(frames, cc.fold(model.conv1, model.conv1_BN))
            x_ncl = cc.from_blocked(x)
            got = cc.block_taps(x, folded)
        module = _module_block(model, block, x_ncl)
        ref = _f32_block(folded, x_ncl, block, conv.stride[0])
    assert got.dtype == torch.bfloat16 and got.shape == module.shape == ref.shape
    scale = float(ref.abs().max())
    e_plain = float((got.float() - ref).abs().max()) / scale
    e_module = float((module.float() - ref).abs().max()) / scale
    assert e_plain <= e_module, (e_plain, e_module)
    assert e_plain <= 2**-8  # one rounding: half a bf16 step of the largest output
    assert float((got.float() - module.float()).abs().max()) / scale <= 2 * e_module


def _unpack(packed, kind, C, cin, k):
    """``pack_weight``'s inverse: ``[C, Cin, k]``."""
    if kind == "frames":  # [C / 128, k / 64 stages, 4 K steps, 16 n8 tiles, 2 K halves, 8 outputs, 8 K values]
        t = packed.reshape(C // 128, k // 64, 4, 16, 2, 8, 8).permute(0, 3, 5, 1, 2, 4, 6)
    else:  # [Cin / 64 slabs, k taps, 4, 16, 2, 8, 8]
        t = packed.reshape(cin // 64, k, 4, 16, 2, 8, 8).permute(3, 5, 0, 2, 4, 6, 1)
    return t.reshape(C, cin, k)


@pytest.mark.parametrize("kind,C,cin,k", [("frames", 1024, 1, 512), ("frames", 128, 1, 512),
                                          ("taps", 128, 1024, 64), ("taps", 128, 64, 64)])
def test_weight_packing_round_trips_and_lays_stages_out_as_the_kernel_reads_them(kind, C, cin, k):
    w = torch.randn(C, cin, k, generator=torch.Generator().manual_seed(C + cin))
    packed = cc.pack_weight(w, kind)
    assert packed.dtype == torch.bfloat16 and packed.shape == (C * cin * k // (64 * 128), 64 * 128)
    assert torch.equal(_unpack(packed, kind, C, cin, k), w.to(torch.bfloat16))
    wb = w.to(torch.bfloat16)
    # one element by hand: stage s, K step kk, n8 tile j, K half h, output n, K value e
    s, kk, j, h, n, e = 3, 2, 5, 1, 6, 7
    at = kk * 4096 + j * 256 + h * 128 + n * 16 + e * 2  # bytes within the stage
    got = packed[s].view(torch.uint8)[at : at + 2].view(torch.bfloat16)[0]
    kv = 16 * kk + 8 * h + e
    if kind == "frames":  # stage = block of 128 outputs, then 64 taps
        nb, ks = divmod(s, 512 // 64)
        want = wb[128 * nb + 8 * j + n, 0, 64 * ks + kv]
    else:  # stage = slab of 64 channels, then tap
        slab, tap = divmod(s, k)
        want = wb[8 * j + n, 64 * slab + kv, tap]
    assert torch.equal(got, want)


def test_which_blocks_take_the_kernel():
    full, tiny = Crepe(CrepeConfig("full")), Crepe(CrepeConfig("tiny"))
    positions = (1024, 128, 64, 32, 16, 8)
    bf = torch.bfloat16
    assert [cc.takes_kernel(getattr(full, f"conv{i + 1}"), bf, False, L) for i, L in enumerate(positions)] == \
        ["frames", "taps", "", "", "", ""]
    assert [cc.takes_kernel(getattr(tiny, f"conv{i + 1}"), bf, False, L) for i, L in enumerate(positions)] == \
        ["frames", "", "", "", "", ""]  # tiny's conv2 has 16 outputs
    for dtype, training in ((torch.float32, False), (torch.float16, False), (bf, True)):
        assert cc.takes_kernel(full.conv1, dtype, training, 1024) == ""
        assert cc.takes_kernel(full.conv2, dtype, training, 128) == ""
    assert cc.takes_kernel(full.conv1, bf, False, 2048) == ""  # another frame length
    assert cc.takes_kernel(full.conv2, bf, False, 64) == ""  # another number of positions
    odd = nn.Conv2d(96, 128, (64, 1))  # Cin no multiple of 64
    assert cc.takes_kernel(odd, bf, False, 128) == ""
    assert cc.takes_kernel(nn.Conv2d(1, 1024, (512, 1), stride=(4, 1), bias=False), bf, False, 1024) == ""


@pytest.mark.parametrize("capacity,dtype,want", [("full", torch.bfloat16, ["frames", "taps"]),
                                                 ("tiny", torch.bfloat16, ["frames"]),
                                                 ("full", torch.float32, []), ("tiny", torch.float32, [])])
def test_the_forward_calls_the_wrappers_by_the_rule(capacity, dtype, want, monkeypatch):
    calls = []
    frames_fn, taps_fn = cc.block_frames, cc.block_taps
    monkeypatch.setattr(cc, "block_frames", lambda *a: calls.append("frames") or frames_fn(*a))
    monkeypatch.setattr(cc, "block_taps", lambda *a: calls.append("taps") or taps_fn(*a))
    model = _model(capacity, dtype=dtype)
    with torch.no_grad():
        out = model(_frames(3).float())
    assert calls == want and out.shape == (3, 360) and out.dtype == torch.float32
    assert sorted(model._kernel_params) == list(range(len(want)))
    model.train()
    calls.clear()
    with torch.no_grad():
        model(_frames(3).float())
    assert calls == []  # training: BatchNorm's batch statistics, on cuDNN's path


def test_the_bf16_forward_is_the_blocks_composed():
    model = _model("full", seed=3)
    frames = _frames(2, seed=4)
    with torch.no_grad():
        got = model(frames.float())
        x = cc.block_frames_plain(frames, cc.fold(model.conv1, model.conv1_BN))
        x = cc.block_taps_plain(x, cc.fold(model.conv2, model.conv2_BN))
        for i in range(3, 7):
            x = _module_block(model, i, x)
        want = torch.sigmoid(model.classifier(x.transpose(1, 2).reshape(2, -1))).float()
    assert torch.equal(got, want)


def test_the_fold_and_pack_follow_a_weight_reload():
    model = _model("full", seed=5)
    frames = _frames(2)
    with torch.no_grad():
        before = model(frames.float())
        key0, fold0, _ = model._kernel_params[0]
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        sd["conv1.weight"] = sd["conv1.weight"] * 2
        sd["conv2_BN.running_mean"] = sd["conv2_BN.running_mean"] + 0.5
        model.load_state_dict(sd)
        after = model(frames.float())
        fresh = _model("full", seed=5)
        fresh.load_state_dict(sd)
        want = fresh(frames.float())
    assert model._kernel_params[0][0] != key0 and torch.equal(model._kernel_params[0][1].w, fold0.w * 2)
    assert not torch.equal(after, before) and torch.equal(after, want)
    copy = __import__("copy").deepcopy(model)
    assert copy._kernel_params == {}  # a copy folds and packs its own


@pytest.mark.parametrize("splits", [2, 4, 16])
def test_split_parts_add_to_the_whole(splits):
    model = _model("full", seed=6)
    x = cc.block_frames_plain(_frames(2), cc.fold(model.conv1, model.conv1_BN))
    folded = cc.fold(model.conv2, model.conv2_BN)
    whole, parts = cc.block_taps_plain(x, folded), cc.block_taps_plain(x, folded, splits)
    # the float32 sums differ in order only: at most one bf16 step apart, a step at each output's magnitude
    # floored at 2^-8 of the largest (near zero the order moves a sum by more than its own tiny step)
    mag = whole.float().abs().clamp_min(float(whole.float().abs().max()) * 2**-8)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((parts.float() - whole.float()).abs() <= step).all())


@pytest.mark.parametrize("N,want", [(1, 16), (2, 16), (8, 16), (16, 16), (32, 8), (64, 4), (65, 4), (128, 2),
                                    (130, 2), (133, 1), (4096, 1)])
def test_taps_splits_fill_the_sms_with_parts_that_divide_the_slabs(N, want):
    s = cc.taps_splits(N, 1024)
    assert s == want and 16 % s == 0
    tiles = -(-N // cc.TAP_FRAMES)
    assert tiles * s <= cc.N_SMS or s == 1
    assert s == 16 or 16 % (2 * s) or tiles * 2 * s > cc.N_SMS  # no larger split would fit
    assert cc.taps_splits(N, 128) == min(want, 2)  # two slabs at most split in two


def _stand_in(monkeypatch):
    calls = []

    def function(name, symbol, argtypes):
        assert name == "crepe_conv"
        return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(cc._cuda, "function", function)
    monkeypatch.setattr(cc._cuda, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(cc, "_sms", lambda device: cc.N_SMS)
    return calls


def _packs(seed=7):
    model = _model("full", seed=seed)
    return (cc.pack(cc.fold(model.conv1, model.conv1_BN), "frames"),
            cc.pack(cc.fold(model.conv2, model.conv2_BN), "taps"))


@pytest.mark.parametrize("N", [1, 64, 130])
def test_the_wrappers_hand_their_shapes_to_the_c_calls_and_count_one_launch_a_call(monkeypatch, N):
    calls = _stand_in(monkeypatch)
    p1, p2 = _packs()
    before = cc.LAUNCHES
    out1 = cc._frames_cuda(torch.zeros(N, 1024, dtype=torch.bfloat16), p1)
    out2 = cc._taps_cuda(torch.zeros(N, 128, 128, 8, dtype=torch.bfloat16), p2)
    assert cc.LAUNCHES == before + 2
    assert out1.shape == (N, 128, 128, 8) and out2.shape == (N, 128, 64)
    (sym1, a1), (sym2, a2) = calls
    assert sym1 == "rvc_crepe_conv_frames" and list(a1[6:8]) == [N, 1024]
    splits = cc.taps_splits(N, 1024)
    assert sym2 == "rvc_crepe_conv_taps" and list(a2[7:10]) == [N, 1024, splits]
    assert (a2[5].value is None) == (splits == 1)  # float32 parts only where K is split
    assert a1[1].value == p1.w.data_ptr() and a2[1].value == p2.w.data_ptr()


def test_the_wrappers_refuse_what_the_kernel_does_not_take(monkeypatch):
    calls = _stand_in(monkeypatch)
    p1, p2 = _packs()
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        cc._frames_cuda(torch.zeros(4, 1024), p1)
    with pytest.raises(ValueError, match=r"\[N, 1024\]"):
        cc._frames_cuda(torch.zeros(4, 1000, dtype=bf), p1)
    with pytest.raises(ValueError, match="contiguous"):
        cc._frames_cuda(torch.zeros(1024, 4, dtype=bf).t(), p1)
    with pytest.raises(ValueError, match="pack"):
        cc._frames_cuda(torch.zeros(4, 1024, dtype=bf), p2)  # the taps pack
    with pytest.raises(ValueError, match=r"\[N, 128, 128, 8\]"):
        cc._taps_cuda(torch.zeros(4, 64, 128, 8, dtype=bf), p2)  # 512 input channels for a 1024-channel pack
    with pytest.raises(ValueError, match="contiguous"):
        cc._taps_cuda(torch.zeros(4, 128, 8, 128, dtype=bf).transpose(2, 3), p2)
    with pytest.raises(ValueError, match="not a pack"):
        cc.block_frames(torch.zeros(4, 1024, dtype=bf), p1)  # on the CPU, the fold
    with pytest.raises(ValueError, match="not a pack"):
        cc.block_taps(torch.zeros(4, 128, 128, 8, dtype=bf), p2)
    with pytest.raises(ValueError, match="unsupported device"):
        cc.block_frames(torch.zeros(4, 1024, dtype=bf, device="meta"), p1)
    with pytest.raises(ValueError, match="no 'frames' kernel"):
        cc.pack(cc.Folded(torch.zeros(1024, 1, 256), *[torch.zeros(1024)] * 3), "frames")
    with pytest.raises(ValueError, match="taps kernel takes"):
        cc.pack(cc.Folded(torch.zeros(256, 1024, 64), *[torch.zeros(256)] * 3), "taps")
    with pytest.raises(ValueError, match="no kernel"):
        cc.pack(cc.Folded(torch.zeros(128, 64, 64), *[torch.zeros(128)] * 3), "dense")
    assert calls == []  # every refusal before the C call


def test_blocked_layout_round_trips():
    x = torch.randn(3, 1024, 128)
    b = cc.to_blocked(x)
    assert b.shape == (3, 128, 128, 8) and b.is_contiguous()
    assert torch.equal(b[1, 5, 7], x[1, 40:48, 7])  # a position's 8 channels, contiguous
    assert torch.equal(cc.from_blocked(b), x)
