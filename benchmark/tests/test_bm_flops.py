"""The FLOP counts stored in the configurations' files against a fresh count."""

import json
import pathlib

import pytest

from benchmark import flops

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_stored_counts_are_fresh(conf):
    cfg = json.loads((REPO / conf["file"]).read_text())
    fresh = flops.count(cfg)
    assert cfg["flops_per_chunk"] == fresh
    parts = sum(v for k, v in fresh.items() if k != "total")
    # the whole step counts the networks and the log-mel's product, nothing else
    assert parts < fresh["total"] < parts * 1.001
