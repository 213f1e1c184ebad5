"""What the benchmark loads: no JAX and nothing of the JAX package in the
process that runs a cell, nothing of the program in the reference; and a
run with no card, or with no program beside it, gives no result."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "obs_rvc_tpu")


def _top_level_imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_a_runs_process():
    """Every module a run imports, the program's entry points with them, by
    whole top-level name (``obs_rvc_tpu_torch`` is not ``obs_rvc_tpu``)."""
    code = """
import sys, json
sys.path.insert(0, %r)
import benchmark.run, benchmark.harness, benchmark.judge, benchmark.control, benchmark.flops, benchmark.weights
import benchmark.reference.step, benchmark.traffic.generate
import torch.profiler
from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline
from obs_rvc_tpu_torch.stream.scheduler import StreamSession
from obs_rvc_tpu_torch.stream.pool import StreamPool
from obs_rvc_tpu_torch.models import ContentVecConfig, FcpeConfig, RMVPEConfig, SynthesizerConfig
from benchmark import harness
spec = harness.load_spec()
for w in spec["workloads"]:
    for t in (False, True):
        for n in harness.metric_names(spec, w["name"], t):
            harness.reader(n)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
""" % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "obs_rvc_tpu_torch" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_the_reference_imports_nothing_of_the_program():
    for f in (REPO / "benchmark" / "reference").glob("*.py"):
        bad = _top_level_imports(f) & {"obs_rvc_tpu_torch", *BANNED}
        assert not bad, f"{f.name} imports {bad}"
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.step, benchmark.reference.nets; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'obs_rvc_tpu_torch', 'jax', 'flax', "
            "'jaxlib', 'obs_rvc_tpu'}))") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rmvpe.stream1", "--seed",
                           "2147483901", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines()), out.stdout


def test_no_card_no_result():
    _no_result(_run(REPO))


def test_no_program_no_result(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the files under ``paths``."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
