"""A copy of the benchmark's files with one cell at reduced widths, for runs
on the CPU: the CPU tests' sizes (a 0.10 s chunk over 0.5 s of context,
ContentVec 64 wide, a three-level RMVPE, a 128-channel 40 kHz generator)."""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

CONTENTVEC = {"dim": 64, "num_layers": 2, "num_heads": 4, "ffn_dim": 128, "conv_pos_kernel": 128,
              "conv_pos_groups": 16}
RMVPE = {"en_de_layers": 3, "inter_layers": 1, "n_blocks": 2, "en_out_channels": 8, "gru_hidden": 32,
         "pallas_unet_max_ch": 32}
FCPE = {"n_mels": 128, "hidden": 64, "n_layers": 2, "expansion": 2, "conv_kernel": 31}
SYNTH = {"feature_dim": 64, "inter_channels": 16, "hidden_channels": 16, "filter_channels": 32, "n_layers": 2,
         "upsample_initial_channel": 128, "gin_channels": 16, "spk_embed_dim": 4}


def tiny_config(pitch: str = "rmvpe", dtype: str = "float32", limits=None) -> dict:
    cfg = json.loads((REPO / f"benchmark/configs/rvc-v2-40k-{pitch}.json").read_text())
    cfg["name"] = f"tiny-{pitch}"
    cfg["dtype"] = dtype
    cfg["geometry"] = {**cfg["geometry"], "chunk_s": 0.10, "context_s": 0.5}
    cfg["contentvec"] = dict(CONTENTVEC)
    if pitch == "rmvpe":
        cfg["rmvpe"] = dict(RMVPE)
    else:
        cfg["fcpe"] = dict(FCPE)
    cfg["synthesizer"] = {**cfg["synthesizer"], **SYNTH}
    cfg["limits"] = limits if limits is not None else {"audio_err": 1e-3, "chunk_limit": 1e-3, "sola_margin": 0.0,
                                                       "chunks_off": 0.0}
    return cfg


def tiny_root(tmp: pathlib.Path, pitch: str = "rmvpe", door: str = "session", dtype: str = "float32",
              limits=None) -> pathlib.Path:
    """``tmp`` holding ``BENCHMARK.json`` with the one cell ``tiny`` and its files."""
    (tmp / "benchmark" / "configs").mkdir(parents=True, exist_ok=True)
    for part in ("traffic", "metrics"):
        shutil.copytree(REPO / "benchmark" / part, tmp / "benchmark" / part, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg = tiny_config(pitch, dtype, limits)
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "benchmark/traffic" / ("stream1.json" if door == "session" else "pool64.json")).read_text())
    traffic["signal"]["period_s"] = 1.0
    traffic["checked"] = 4
    traffic["trace_steps"] = 2
    traffic["warmup_chunks"] = 1
    if door == "pool":
        traffic["door"].update(capacity=4, batch_min=1)
        traffic["checked_streams"] = 2
    (tmp / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": cfg["name"], "source": cfg["source"], "file": "benchmark/configs/tiny.json",
                        "reduced": ["contentvec", "rmvpe", "fcpe", "synthesizer", "geometry"], "why": "CPU tests"}]
    spec["workloads"] = [{"name": "tiny", "config": cfg["name"], "traffic": "tiny", "chips": 1, "why": "CPU tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny"] if door == ("session" if "stream1" in str(m["workloads"]) else "pool") else []
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def args(seed: int = 7, seconds: float = 1.0, trace: int = 0) -> argparse.Namespace:
    return argparse.Namespace(workload="tiny", seed=seed, seconds=seconds, trace=trace)
