"""CREPE ``full`` in the benchmark (``reference/pitch/crepe.py``, the
configuration ``rvc-v2-40k-crepe-full``, ``metrics/crepe_roofline.py``): the
harness at the CPU tests' reduced widths through a session and a pool, the
control not correct at the configuration's limits, and the FLOPs a chunk
held to the count from the network's shapes."""

import io
import json
import pathlib
import types

import pytest
import torch

from benchmark import control, flops, harness, judge, yardstick
from benchmark.metrics import crepe_roofline
from benchmark.tests import tiny

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[2]
CFG = json.loads((REPO / "benchmark/configs/rvc-v2-40k-crepe.json").read_text())
#: one frame of CREPE ``full``, counted from its shapes (a multiply-add 2): conv1 (1 → 1024, kernel 512, over
#: 256 positions), conv2 (1024 → 128, kernel 64, over 128), conv3 … conv6 (over 64, 32, 16, 8), the classifier
FRAME_FLOPS = 2 * (512 * 1 * 1024 * 256 + 64 * 1024 * 128 * 128 + 64 * 128 * 128 * 64 + 64 * 128 * 128 * 32
                   + 64 * 128 * 256 * 16 + 64 * 256 * 512 * 8 + 2048 * 360)


def _run(root, seed=3, steps=6, **kw):
    out = io.StringIO()
    harness.run(tiny.args(seed=seed, seconds=600.0), 0.0, device="cpu", root=root, max_steps=steps, out=out,
                err=io.StringIO(), **kw)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("door", ["session", "pool"])
def test_a_run_of_the_float32_program_with_crepe_is_correct(tmp_path, door):
    r = _run(tiny.tiny_root(tmp_path, pitch="crepe", door=door))
    assert r["correct"], r["checks"]
    assert r["checks"]["audio_err"]["value"] < 1e-4 and not any(r["readings"]["per_chunk"]["sola_gap"])
    assert r["failed"] == 0 and r["attempted"] == 6 * (1 if door == "session" else 4)


def test_the_control_is_not_correct(tmp_path):
    """The reference with float8 products in the program's place fails the
    configuration's limits; the bfloat16 program reads well under it."""
    root = tiny.tiny_root(tmp_path, pitch="crepe", dtype="bfloat16", limits=CFG["limits"])
    prog = _run(root, seed=1, steps=8)
    ctl = _run(root, seed=1, steps=8, make_program=control.ReferenceProgram)
    assert prog["correct"], prog["checks"]
    assert not ctl["correct"], ctl["checks"]
    for name in judge.COMPARED:
        assert ctl["checks"][name]["value"] >= prog["checks"][name]["value"], (name, prog["checks"], ctl["checks"])
    assert ctl["checks"]["audio_err"]["value"] > 2.5 * prog["checks"]["audio_err"]["value"]


def test_the_flops_a_chunk_are_the_shapes_count():
    counted = flops.count(CFG)
    frames = harness.geometry(CFG).pitch_frames
    assert frames == 64 and FRAME_FLOPS == 2_820_046_848
    assert counted["crepe"] == pytest.approx(frames * FRAME_FLOPS, rel=1e-3)
    assert CFG["flops_per_chunk"] == counted
    f, b = crepe_roofline.crepe_flops_bytes(frames, "full", 2)
    assert f == pytest.approx(counted["crepe"], rel=1e-3)
    # ~22.2 M parameters read once in bfloat16, the frames and every block's pooled output
    assert 44e6 < b < 100e6
    ms, by = yardstick.bound_ms(f, b, yardstick.BF16_PEAK_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.1825, abs=5e-4)


def test_the_roofline_reads_the_programs_crepe_spans():
    from obs_rvc_tpu_torch.serve import metrics

    ctx = types.SimpleNamespace(cfg=CFG, window={"streams": 1}, geometry=harness.geometry(CFG))
    metrics.reset()
    try:
        assert crepe_roofline.read(ctx) is None
        bound = yardstick.bound_ms(*crepe_roofline.crepe_flops_bytes(64), yardstick.BF16_PEAK_FLOPS)[0]
        for total in (8.0, 2.0, 4.0):  # three timed steps: the median step sums to 4 ms
            spans = {name: total / 7 for name in crepe_roofline.SPANS}
            metrics.record_spans(None, spans, on_card=True)
        assert crepe_roofline.read(ctx) == pytest.approx(100 * bound / 4.0)
        other = types.SimpleNamespace(cfg=json.loads((REPO / "benchmark/configs/rvc-v2-40k-rmvpe.json").read_text()),
                                      window={"streams": 1}, geometry=ctx.geometry)
        assert crepe_roofline.read(other) is None
    finally:
        metrics.reset()
