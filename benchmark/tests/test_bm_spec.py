"""``BENCHMARK.json`` against the contract the harness is written to, and
the harness finding a configuration, a mix and a metric added as files."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_workload_resolves_and_reports(workload):
    c = harness.resolve(SPEC, workload)
    assert c.cfg["name"] == c.cell["config"] and c.traffic["door"]["kind"] in ("session", "pool")
    assert c.cfg["flops_per_chunk"]["total"] > 0
    e2e = harness.metric_names(SPEC, workload, trace=False)
    per_layer = harness.metric_names(SPEC, workload, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    e2e_all = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_all
        if workload in m.get("workloads", []):
            assert m["moves"] in e2e, f"{m['name']} moves a metric {workload} does not report"
    for name in e2e + per_layer:
        assert callable(harness.reader(name).read)


def test_a_config_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    """A later change adds files and entries and edits no file that is there."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/rvc-v2-40k-rmvpe.json").read_text())
    cfg["name"] = "rvc-v2-40k-rmvpe-wide"
    cfg["rmvpe"]["pallas_unet_max_ch"] = 256
    (tmp_path / "benchmark/configs/rvc-v2-40k-rmvpe-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "benchmark/traffic/pool64.json").read_text())
    mix["door"]["capacity"] = 8
    (tmp_path / "benchmark/traffic/pool8.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/ticks_done.py").write_text("def read(ctx):\n    return ctx.window['steps']\n")
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                            "file": "benchmark/configs/rvc-v2-40k-rmvpe-wide.json", "reduced": [], "why": "wide"})
    spec["workloads"].append({"name": "wide.pool8", "config": cfg["name"], "traffic": "pool8", "chips": 1,
                              "why": "eight streams"})
    spec["per_layer"].append({"name": "ticks_done.pool", "unit": "ticks", "better": "higher",
                              "source": "host_clock", "layer": "stream.pool", "moves": "audio_s_per_s",
                              "workloads": ["wide.pool8"]})
    for m in spec["end_to_end"]:
        if "fcpe.pool64" in m.get("workloads", []):
            m["workloads"].append("wide.pool8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.resolve(spec, "wide.pool8", tmp_path)
    assert c.cfg["rmvpe"]["pallas_unet_max_ch"] == 256 and c.traffic["door"]["capacity"] == 8
    assert "ticks_done.pool" in harness.metric_names(spec, "wide.pool8", trace=True)
    assert harness.reader("ticks_done.pool", tmp_path).read(type("C", (), {"window": {"steps": 5}})) == 5
    for f in (REPO / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (tmp_path / f.relative_to(REPO)).read_bytes() == f.read_bytes()


#: run in a copy of the benchmark's files with a pitch network ``twin`` added as
#: one file: its sizes, weights, reference and FLOPs, then a few steps of the
#: harness through the program, against those of the network whose pieces it reuses
TWIN_RUN = """
import io, json, sys
sys.path[:0] = [%r, %r]  # the copy's benchmark first, the program beside it
import torch
torch.set_num_threads(2)
from benchmark import flops, harness, weights
from benchmark.reference import step as refstep
from benchmark.tests import tiny
out = {"file": refstep.network("twin").__file__}
for name in ("twin", %r):
    cfg = tiny.tiny_config(name)
    sizes = harness.sizes(cfg)
    sds = weights.make_weights(sizes, 11, "cpu")
    ref = refstep.build(harness.geometry(cfg), name, {n: harness._asdict(s) for n, s in sizes.items()}, sds,
                        refstep.Controls(), "cpu")
    o = ref.outputs(torch.randn(1, 9 * ref.geo.chunk, generator=torch.Generator().manual_seed(1)) * 0.1,
                    torch.tensor([8]))
    full = json.loads(open(%r + "/benchmark/configs/rvc-v2-40k-" + name + ".json").read())
    out[name] = {"sizes": [type(s).__name__ for s in sizes.values()], "keys": {n: list(sd) for n, sd in sds.items()},
                 "sums": [float(v.double().sum()) for sd in sds.values() for v in sd.values()],
                 "out": o.tolist(), "flops": flops.count(full)}
r = io.StringIO()
harness.run(tiny.args(seconds=60.0), 0.0, device="cpu", root=tiny.tiny_root(__import__("pathlib").Path(%r), "twin"),
            max_steps=3, out=r, err=io.StringIO())
out["run"] = json.loads(r.getvalue().strip().splitlines()[-1])
print(json.dumps(out))
"""


def test_a_pitch_network_added_as_one_file_is_found(tmp_path):
    """A later change adds a pitch network as one file under
    ``reference/pitch/`` and a configuration that names it, and edits no file
    that is there: the harness, the weights, the reference and the FLOP count
    take it. Here the file reuses an existing network's pieces under a new
    name, so each reading must equal that network's."""
    conf = SPEC["configs"][-1]
    base = json.loads((REPO / conf["file"]).read_text())
    reused = base["pitch"]
    copy = tmp_path / "copy"
    shutil.copytree(REPO / "benchmark", copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    names = "HEADS, PROGRAM, TINY, Net, Size, decode, inputs"
    (copy / "benchmark/reference/pitch/twin.py").write_text(
        f'"""The pitch network ``{reused}`` under another name."""\n\n'
        f"from benchmark.reference.pitch.{reused} import {names}  # noqa: F401\n")
    cfg = dict(base, name="rvc-v2-40k-twin", pitch="twin", twin=base[reused])
    cfg.pop(reused)
    cfg["flops_per_chunk"] = {("twin" if k == reused else k): v for k, v in base["flops_per_chunk"].items()}
    (copy / "benchmark/configs/rvc-v2-40k-twin.json").write_text(json.dumps(cfg))
    (copy / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    code = TWIN_RUN % (str(copy), str(REPO), reused, str(copy), str(tmp_path / "tiny"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=copy)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert pathlib.Path(r["file"]) == copy / "benchmark/reference/pitch/twin.py"
    twin, other = r["twin"], r[reused]
    assert twin["sizes"] == other["sizes"] and twin["sums"] == other["sums"] and twin["out"] == other["out"]
    assert twin["keys"] == {("twin" if n == reused else n): k for n, k in other["keys"].items()}
    assert twin["flops"] == cfg["flops_per_chunk"] and twin["flops"]["total"] == base["flops_per_chunk"]["total"]
    assert r["run"]["correct"] and r["run"]["attempted"] == 3 and r["run"]["failed"] == 0, r["run"]["checks"]
    for f in (REPO / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (copy / f.relative_to(REPO)).read_bytes() == f.read_bytes()


@pytest.mark.parametrize("name", ["nosuch", "../nets", "Upper"])
def test_an_unknown_pitch_network_is_refused_naming_the_file(name):
    cfg = json.loads((REPO / SPEC["configs"][0]["file"]).read_text())
    cfg["pitch"], cfg[name] = name, {}
    with pytest.raises(ValueError, match=re.escape(f"benchmark/reference/pitch/{name}.py")):
        harness.sizes(cfg)
