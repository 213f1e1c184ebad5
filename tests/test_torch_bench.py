"""``scripts/torch_bench.py``, the port's counterpart of ``bench.py``, on the
CPU at reduced widths, and the GFLOP counts its MFU divides by.

On the CPU the graphs run eagerly, the kernels take their plain versions and
the stage times are host times: these tests check the line's schema and
arithmetic, not a speed. ``utils/flops.py``'s ContentVec, RMVPE and
synthesizer counts equal the JAX package's; its CREPE and FCPE counts equal
``torch.utils.flop_counter.FlopCounterMode`` over one forward (exactly: both
count each product's multiply-adds twice and neither counts norms, gates or
biases).
"""

import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from obs_rvc_tpu.config import StreamSettings as JStreamSettings
from obs_rvc_tpu.utils import flops as jflops

from obs_rvc_tpu_torch.config import StreamSettings
from obs_rvc_tpu_torch.models.crepe import Crepe, CrepeConfig
from obs_rvc_tpu_torch.models.fcpe import Fcpe, FcpeConfig
from obs_rvc_tpu_torch.utils import flops

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_bench", ROOT / "scripts" / "torch_bench.py")
torch_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_bench)

FCPE_SMALL = dict(hidden=64, n_layers=2)
STAGES = ["pre", "features", "mel", "salience", "pitch_post", "synth", "post"]
EXTRA_KEYS = {"p95_ms", "sustained_ms_per_chunk", "rtf", "audio_seconds_per_second", "mfu",
              "model_gflops_per_chunk", "batch", "mode", "pitch_algorithm", "dtype", "chunk_ms", "backend",
              "device_name", "power_limit_w", "cudnn_tf32", "matmul_tf32", "stage_device_ms", "stage_device_ms_sum"}


@pytest.fixture
def small(monkeypatch):
    """The networks the pipeline builds, at reduced widths."""
    from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
    from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
    from obs_rvc_tpu_torch.stream import pipeline as pipeline_mod

    from test_torch_port_pipeline import CV, RM, SY

    monkeypatch.setattr(ContentVecConfig, "v2", staticmethod(lambda: ContentVecConfig(**CV)))
    monkeypatch.setattr(SynthesizerConfig, "for_sample_rate",
                        staticmethod(lambda sr, feature_dim=768: SynthesizerConfig(**SY)))
    monkeypatch.setattr(pipeline_mod, "RMVPEConfig", lambda: RMVPEConfig(**RM))
    monkeypatch.setattr(pipeline_mod, "FcpeConfig", lambda: FcpeConfig(**FCPE_SMALL))


def bench_line(capsys, *argv) -> dict:
    assert torch_bench.main(["--device", "cpu", "--steps", "3", "--warmup", "1", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv, batch, mode, pitch", [
    ((), 1, "fused", "rmvpe"),
    (("--batch", "2", "--mode", "staged"), 2, "staged", "rmvpe"),
    (("--pitch-algorithm", "fcpe",), 1, "fused", "fcpe"),
], ids=["b1-fused", "b2-staged", "fcpe"])
def test_bench_line_on_the_cpu(small, capsys, argv, batch, mode, pitch):
    line = bench_line(capsys, *argv)
    assert (line["metric"], line["unit"]) == ("chunk_p50_ms", "ms")
    p50, x = line["value"], line["extra"]
    assert math.isfinite(p50) and p50 > 0
    assert line["vs_baseline"] == round(80.0 / p50, 3)
    assert EXTRA_KEYS <= set(x), EXTRA_KEYS - set(x)
    assert (x["batch"], x["mode"], x["pitch_algorithm"], x["dtype"]) == (batch, mode, pitch, "bfloat16")
    assert (x["backend"], x["device_name"], x["power_limit_w"]) == ("cpu", "cpu", None)
    assert (x["cudnn_tf32"], x["matmul_tf32"]) == (torch.backends.cudnn.allow_tf32,
                                                   torch.backends.cuda.matmul.allow_tf32)
    assert x["p95_ms"] >= p50
    cfg = StreamSettings().chunk_config(48000)
    chunk_s = cfg.sample_frame_size / cfg.sample_rate
    assert x["chunk_ms"] == pytest.approx(300.0)
    assert x["rtf"] == pytest.approx(p50 / 1e3 / chunk_s, rel=1e-12)
    sustained = x["sustained_ms_per_chunk"]
    assert math.isfinite(sustained) and sustained > 0
    assert x["audio_seconds_per_second"] == pytest.approx(batch * chunk_s / (sustained / 1e3), rel=1e-12)
    # the count is the analytic one: the JAX package's at the default geometry, FCPE's own in place of RMVPE's
    jcfg = JStreamSettings().chunk_config(48000)
    gflop = jflops.pipeline_gflops_per_chunk(jcfg)
    if pitch == "fcpe":
        gflop += flops.fcpe_gflops(Fcpe(FcpeConfig(**FCPE_SMALL)), cfg.rmvpe_n_frames) \
            - jflops.rmvpe_gflops(jcfg.rmvpe_n_frames)
    assert x["model_gflops_per_chunk"] == pytest.approx(gflop, rel=1e-12)
    assert x["mfu"] == pytest.approx(batch * gflop * 1e9 / (sustained / 1e3) / 989e12, rel=1e-12)
    assert list(x["stage_device_ms"]) == STAGES
    assert all(math.isfinite(v) and v >= 0 for v in x["stage_device_ms"].values())
    assert x["stage_device_ms_sum"] == pytest.approx(sum(x["stage_device_ms"].values()), rel=1e-12)


def test_bench_refuses_what_it_cannot_measure(capsys):
    """The flag the port refuses for good, and a trace of the card's kernels without a card."""
    with pytest.raises(SystemExit, match="refused"):
        torch_bench.main(["--device", "cpu", "--no-pallas-resblocks"])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        torch_bench.main(["--device", "cpu", "--profile", "trace"])
    assert '"metric"' not in capsys.readouterr().out


def test_bench_without_a_card_exits_naming_it():
    """No ``--device`` means the card; with none the script fails and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_bench.py"), "--steps", "2"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert '"metric"' not in proc.stdout


def test_flop_counts_equal_the_jax_package_at_the_default_geometry():
    cfg, jcfg = StreamSettings().chunk_config(48000), JStreamSettings().chunk_config(48000)
    assert flops.contentvec_gflops(cfg.input_buffer_16k_size) == jflops.contentvec_gflops(jcfg.input_buffer_16k_size)
    assert flops.rmvpe_gflops(cfg.rmvpe_n_frames) == jflops.rmvpe_gflops(jcfg.rmvpe_n_frames)
    assert flops.synth_gflops(cfg.return_length) == jflops.synth_gflops(jcfg.return_length)
    assert flops.pipeline_gflops_per_chunk(cfg) == jflops.pipeline_gflops_per_chunk(jcfg)


@pytest.mark.parametrize("pitch", ["crepe", "fcpe"])
def test_pitch_network_counts_equal_the_flop_counter(pitch):
    """One forward at reduced widths (CREPE ``tiny``, FCPE at hidden 64, 2
    layers) over 3 frames, counted by PyTorch's own FLOP counter."""
    torch.manual_seed(0)
    frames = 3
    if pitch == "crepe":
        net = Crepe(CrepeConfig("tiny")).eval()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((frames, 1024)).astype(np.float32))
        want = flops.crepe_gflops(net, frames)
    else:
        net = Fcpe(FcpeConfig(**FCPE_SMALL)).eval()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, frames, 128)).astype(np.float32))
        want = flops.fcpe_gflops(net, frames)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(x)
    assert want == pytest.approx(counter.get_total_flops() / 1e9, rel=1e-12)
