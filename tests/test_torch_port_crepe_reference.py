"""The port's CREPE against the benchmark's plain reference of it
(``benchmark/reference/pitch/crepe.py``, written from torchcrepe's
description and importing nothing of the port): the network at ``full``
and ``tiny`` on one state dict, the frames, the decode, a run of the
benchmark's harness at reduced widths, the spans CREPE's blocks leave under
the CPU's stage timing, and the bfloat16 step held to the reference by the
error budget ``tests/test_torch_port_bf16.py`` keeps (``e <= 2 e_ref +
tol``, ``e_ref`` here the reference computed with bfloat16 products)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness, judge, weights  # noqa: E402
from benchmark.reference import nets  # noqa: E402
from benchmark.reference import step as refstep  # noqa: E402
from benchmark.reference.pitch import crepe as ref_crepe  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.traffic import generate  # noqa: E402

from obs_rvc_tpu_torch.config import ChunkConfig  # noqa: E402
from obs_rvc_tpu_torch.dsp.f0 import decode_f0  # noqa: E402
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig  # noqa: E402
from obs_rvc_tpu_torch.models.crepe import Crepe, CrepeConfig, extract_crepe_frames  # noqa: E402
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig  # noqa: E402
from obs_rvc_tpu_torch.serve import metrics  # noqa: E402
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamSession  # noqa: E402

from test_torch_port_models import few_torch_threads  # noqa: E402,F401 (autouse fixture)
from test_torch_port_pipeline import CV, SY, voiced_signal  # noqa: E402

SPANS = [f"crepe.conv{i}" for i in range(1, 7)] + ["crepe.head"]


def _state_dict(capacity, seed):
    """The benchmark's weights for CREPE at ``capacity``: fan-in draws, norms at 1 and 0, the peaked head."""
    gen = torch.Generator().manual_seed(seed)
    sd = weights.make_state_dict(weights.skeleton("crepe", ref_crepe.Size(capacity)), gen, "cpu")
    return weights.structure(sd, gen, "cpu", ref_crepe.HEADS)


def _window(n_frames, seed):
    """A 16 kHz window of ``n_frames`` pitch frames: a tone in noise, the last fifth silent."""
    L = (n_frames - 1) * ref_crepe.HOP
    t = torch.arange(L) / 16000.0
    x = 0.3 * torch.sin(2 * torch.pi * 190.0 * t) + 0.02 * torch.randn(L, generator=torch.Generator().manual_seed(seed))
    x[-L // 5 :] = 0.0
    return x[None]


@pytest.mark.parametrize("capacity,n_frames", [("full", 3), ("tiny", 64)])
def test_the_ports_crepe_is_the_references(capacity, n_frames):
    sd = _state_dict(capacity, seed=4)
    port = Crepe(CrepeConfig(capacity)).eval()
    port.load_state_dict(sd, strict=True)
    ref = refstep.make_module(ref_crepe.Net, ref_crepe.Size(capacity), "cpu", state_dict=sd)
    frames = ref_crepe.inputs(_window(n_frames, seed=5))
    with torch.no_grad():
        want = ref(frames)
        got = port(frames.flatten(0, 1)).unflatten(0, frames.shape[:2])
    assert want.shape == (1, n_frames, 360)
    # float32 both sides; the two convolutions sum conv2's 65,536 products a value in their own orders
    assert (got - want).abs().max() < 1e-5
    assert torch.equal(decode_f0(got) > 0, ref_crepe.decode(want) > 0)


def test_extract_crepe_frames_is_the_references_inputs():
    window = _window(64, seed=6).expand(2, -1).clone()
    window[1] *= 0.01
    got, want = extract_crepe_frames(window, 64), ref_crepe.inputs(window)
    assert got.shape == want.shape == (2, 64, 1024)
    # unit-variance frames, their mean and variance summed in float32 in two orders
    assert (got - want).abs().max() < 1e-4
    assert torch.all(got[:, -8:] == 0) and torch.all(want[:, -8:] == 0)  # silent frames are 0 on both


def test_the_ports_decode_is_the_references():
    gen = torch.Generator().manual_seed(7)
    bins = torch.arange(360.0)
    centre = torch.randint(20, 340, (2, 64, 1), generator=gen).float()
    sal = 0.9 * torch.exp(-0.5 * ((bins - centre) / 3.0) ** 2) + 0.01 * torch.rand(2, 64, 360, generator=gen)
    sal[:, ::7] *= 0.02  # every seventh frame under the 0.03 threshold: unvoiced
    got, want = decode_f0(sal, threshold=0.03), ref_crepe.decode(sal)
    assert torch.equal(got == 0, want == 0) and (want == 0).sum() == 2 * 10
    # the same float32 arithmetic on the same grid
    assert torch.allclose(got, want, rtol=1e-6, atol=0)


#: a run of the harness refuses a process that has loaded JAX, as this suite's has: it runs in its own
HARNESS_RUN = """
import io, json, pathlib, sys
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests import tiny
out = io.StringIO()
harness.run(tiny.args(seconds=60.0), 0.0, device="cpu", root=tiny.tiny_root(pathlib.Path(%r), "crepe"), max_steps=6,
            out=out, err=io.StringIO())
print(out.getvalue().strip().splitlines()[-1])
"""


def test_a_run_of_the_float32_program_with_crepe_is_correct(tmp_path):
    proc = subprocess.run([sys.executable, "-c", HARNESS_RUN % (str(REPO), str(tmp_path))], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 6
    # float32 against float32: the harness's limits at these widths (1e-3) with room to spare
    assert r["checks"]["audio_err"]["value"] < 1e-4


def _pipe():
    pipe = RvcPipeline(ChunkConfig.build(sample_length=0.10, extra_inference_time=0.50),
                       contentvec_cfg=ContentVecConfig(**CV), synth_cfg=SynthesizerConfig(**SY), device="cpu",
                       pitch_algorithm="crepe", crepe_cfg=CrepeConfig("tiny"))
    pipe.init_params(0)
    return pipe


def test_crepes_spans_follow_its_blocks_under_the_cpus_stage_timing():
    pipe = _pipe()
    with torch.no_grad(), metrics.marking(metrics.Marks(on_card=False)) as marks:
        pipe.crepe(torch.randn(8, 1024))
    assert [name for name, _ in marks.points] == ["crepe", *SPANS]
    assert list(marks.spans()) == SPANS and all(ms >= 0 for ms in marks.spans().values())
    assert metrics.stage_marks() is None

    metrics.reset()
    size = pipe.cfg.sample_frame_size
    wav = voiced_signal(2, pipe.cfg)
    sessions = {t: StreamSession(pipe, StepControls.default(), mode="staged", stage_timing=t) for t in (True, False)}
    with torch.no_grad():
        for sess in sessions.values():
            for k in range(2):
                sess.push_audio(wav[k * size : (k + 1) * size])
                assert sess.process_pending() == 1
    timed = sessions[True].metrics.snapshot().spans
    assert all(timed[name]["count"] == 2 and timed[name]["p50_ms"] > 0 for name in SPANS)
    # a block's span lies inside its stage's
    assert sum(timed[name]["total_ms"] for name in SPANS) <= timed["stage.salience"]["total_ms"] + 1e-3
    assert not any(n.startswith("crepe") for n in sessions[False].metrics.snapshot().spans)
    # the CPU's host-clocked spans stay with their door, as its stage times do
    assert not any(n.startswith("crepe") for n in metrics.process_snapshot()["spans"])


class _Bf16(nets.Precision):
    """Every product's activation and weight rounded to bfloat16, computed in float32."""

    def __init__(self):
        self.kind = "bf16"

    def act(self, x):
        return x.to(torch.bfloat16).float() if x.is_floating_point() else x


def test_the_bf16_step_is_within_the_budget_of_the_reference():
    """The port's bfloat16 step (the harness's program at reduced widths)
    and the reference with bfloat16 products, each stepped from a zeroed
    state, against the float32 reference on the same rounded weights:
    ``e_port <= 2 e_ref + 2e-3``, ``e`` the largest relative error of an
    emitted chunk (2e-3 the emitted audio's float32 tolerance in
    ``test_torch_port_bf16.py``), and ``e_ref > 1e-4``: the products did round."""
    cfg = tiny.tiny_config("crepe", dtype="bfloat16")
    geo = harness.geometry(cfg)
    sizes = harness.sizes(cfg)
    seed = 2**31 + 24
    traffic = json.loads((REPO / "benchmark/traffic/stream1.json").read_text())
    signal = generate.voice({**traffic["signal"], "period_s": 1.0}, 1, geo.sample_rate, geo.chunk, seed, "cpu")
    rounded = {n: weights.round_to(sd, torch.bfloat16) for n, sd in weights.make_weights(sizes, seed, "cpu").items()}
    asdict = {n: harness._asdict(s) for n, s in sizes.items()}
    c = cfg["controls"]
    controls = refstep.Controls(c["pitch_shift"], c["rms_mix_rate"], c.get("sid", 0))
    ref32 = refstep.build(geo, "crepe", asdict, rounded, controls, "cpu")
    ref16 = refstep.ReferenceStreams(refstep.build(geo, "crepe", asdict, rounded, controls, "cpu", _Bf16()), 1, "cpu")
    prog = harness.Program(cfg, traffic, weights.make_weights(sizes, seed, "cpu"), "cpu")
    n = 8
    chunks = [generate.chunk(signal, 0, k, geo.chunk)[None] for k in range(n)]
    with torch.no_grad():
        port = [prog.serve(ch.numpy())[0][0] for ch in chunks]
        bf16 = [ref16.step(ch)[0].numpy() for ch in chunks]

    def worst(emitted):
        checked = [(0, k, emitted[k], emitted[k - 1] if k else None) for k in range(2, n)]
        return max(judge.compare(ref32, signal, checked, 1.0, 1.0)["per_chunk"]["audio_err"])

    e_port, e_ref = worst(port), worst(bf16)
    print(f"crepe bf16 step: e_ref {e_ref:.3e}, e_port {e_port:.3e}, budget {2 * e_ref + 2e-3:.3e}")
    assert np.isfinite(port).all() and e_ref > 1e-4
    assert e_port <= 2 * e_ref + 2e-3, (e_port, e_ref)
