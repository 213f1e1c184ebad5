"""``BENCHMARK.json`` against the contract the harness is written to, and
the harness finding a configuration, a mix and a metric added as files."""

import json
import pathlib
import re
import shutil

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
        if m.get("workloads") == ["fcpe.pool64"]:
            m["workloads"].append("wide.pool8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.resolve(spec, "wide.pool8", tmp_path)
    assert c.cfg["rmvpe"]["pallas_unet_max_ch"] == 256 and c.traffic["door"]["capacity"] == 8
    assert "ticks_done.pool" in harness.metric_names(spec, "wide.pool8", trace=True)
    assert harness.reader("ticks_done.pool", tmp_path).read(type("C", (), {"window": {"steps": 5}})) == 5
    for f in (REPO / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (tmp_path / f.relative_to(REPO)).read_bytes() == f.read_bytes()
