"""The yardstick's arithmetic on inputs whose answers are known."""

import types

import numpy as np
import pytest

from benchmark import yardstick
from benchmark.metrics import audio_s_per_s, chunk_p95_ms, device_idle_pct, pool_host_ms, step_mfu_pct, tick_p95_ms


@pytest.mark.parametrize("n", [1, 2, 7, 100, 2301])
def test_percentile_is_numpys(n):
    v = np.random.default_rng(n).exponential(size=n).tolist()
    for q in (50, 95, 99):
        assert yardstick.percentile(v, q) == pytest.approx(float(np.percentile(v, q)), rel=1e-12)


def _ctx(kind="session", **window):
    w = {"seconds": 10.0, "steps": 4, "streams": 1, "step_ms": [], "chunks": 4, "audio_s": 1.2, "phases": []}
    w.update(window)
    return types.SimpleNamespace(window=w, traffic={"door": {"kind": kind}}, trace=None, stage_ms=None,
                                 cfg={"dtype": "bfloat16", "flops_per_chunk": {"total": 70e9}})


def test_tails_rates_and_means():
    ms = list(range(1, 101))
    assert chunk_p95_ms.read(_ctx(step_ms=ms)) == pytest.approx(95.05)
    assert tick_p95_ms.read(_ctx(step_ms=ms)) is None
    assert tick_p95_ms.read(_ctx("pool", step_ms=ms)) == pytest.approx(95.05)
    assert audio_s_per_s.read(_ctx(audio_s=4800.0, seconds=20.0)) == 240.0
    phases = [{"controls_ms": 1.0, "drain_ms": 2.0, "merge_ms": 3.0, "dispatch_ms": 50.0}] * 3
    assert pool_host_ms.read(_ctx("pool", phases=phases)) == 6.0
    # 70 GFLOP a chunk, 1000 chunks in 10 s: 7 TFLOP/s of 989
    assert step_mfu_pct.read(_ctx(chunks=1000)) == pytest.approx(100 * 7e12 / 989e12)


def test_idle_share_of_a_synthetic_trace():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38), (90, 100)]
    assert yardstick.busy(spans) == 40
    assert yardstick.gaps(spans, 0, 120) == [(20, 30), (40, 90), (100, 120)]
    trace = {"device": [("k", s, e) for s, e in spans], "busy_s": 40e-6, "window_s": 120e-6}
    ctx = _ctx()
    ctx.trace = trace
    assert device_idle_pct.read(ctx) == pytest.approx(100 * 80 / 120)


def test_kernel_counts_match_the_repository_table():
    """Rows 1b and 2b of the kernel table: the chain at one stream (its four
    C <= 32 levels, 1.248 GFLOP, 2.04 MB in bfloat16) and the bank (its two
    levels, 10.838 GFLOP, 4.88 MB)."""
    chain = [(64, 128, 1, 16), (64, 128, 32, 16), (32, 64, 16, 32), (32, 64, 64, 32)]
    f, b = map(sum, zip(*(yardstick.chain_flops_bytes(1, H, W, ci, C, 2, 2) for H, W, ci, C in chain)))
    assert f / 1e9 == pytest.approx(1.248, abs=5e-4) and b / 1e6 == pytest.approx(2.04, abs=5e-3)
    f, b = map(sum, zip(*(yardstick.bank_flops_bytes(1, L, C, 2, 2) for L, C in ((7000, 64), (14000, 32)))))
    assert f / 1e9 == pytest.approx(10.838, abs=5e-4) and b / 1e6 == pytest.approx(4.88, abs=5e-3)
    ms, by = yardstick.bound_ms(f, b, yardstick.BF16_PEAK_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.0110, abs=5e-5)


def test_roofline_readers_read_the_shapes_launched():
    import json
    import pathlib

    from benchmark.metrics import bank_roofline, chain_roofline

    repo = pathlib.Path(__file__).resolve().parents[2]
    rm = json.loads((repo / "benchmark/configs/rvc-v2-40k-rmvpe.json").read_text())
    fc = json.loads((repo / "benchmark/configs/rvc-v2-40k-fcpe.json").read_text())
    assert sorted(chain_roofline.levels(rm)) == sorted([(64, 128, 1, 16), (64, 128, 32, 16),
                                                            (32, 64, 16, 32), (32, 64, 64, 32)])
    assert chain_roofline.levels(fc) == []
    assert bank_roofline.levels(fc) == [(7000, 64), (14000, 32)]
    # 10 steps, the bank's kernels busy 10 x the bound: 100 %
    bound = yardstick.bound_ms(*yardstick.bank_flops_bytes(1, 7000, 64, 2, 2), yardstick.BF16_PEAK_FLOPS)[0] + \
        yardstick.bound_ms(*yardstick.bank_flops_bytes(1, 14000, 32, 2, 2), yardstick.BF16_PEAK_FLOPS)[0]
    ctx = _ctx()
    ctx.cfg = fc
    ctx.trace = {"steps": 10, "device": [("resblock_bank_kernel<64>", 0.0, 10 * bound * 1e3)]}
    assert bank_roofline.read(ctx) == pytest.approx(100.0)
    ctx.trace = {"steps": 10, "device": [("other", 0.0, 1.0)]}
    assert bank_roofline.read(ctx) is None
