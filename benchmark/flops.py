"""FLOPs a chunk of one stream, counted by ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference at the configuration's geometry, on the meta
device (no memory, no arithmetic).

    python benchmark/flops.py [--write]

prints each configuration's count and, with ``--write``, stores it in the
configuration's file under ``flops_per_chunk`` (by network, and the total).
The counter counts matrix products and convolutions (a multiply-add as 2):
the FFT of the log-mel, the normalisations, activations, the GRU's gate
arithmetic and every other elementwise operation are not in it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def count(cfg: dict) -> dict:
    """``{network: FLOPs, ..., "total": FLOPs}`` of one stream's chunk."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import harness, weights
    from benchmark.reference import step as refstep

    geo = harness.geometry(cfg)
    mods = {name: weights.skeleton(name, size) for name, size in harness.sizes(cfg).items()}
    for m in mods.values():
        m.eval()
    c = cfg["controls"]
    ref = refstep.Reference(geo, cfg["pitch"], mods["contentvec"], mods[cfg["pitch"]], mods["synthesizer"],
                            refstep.Controls(c["pitch_shift"], c["rms_mix_rate"], c.get("sid", 0)))
    out = {}
    with torch.device("meta"), torch.no_grad():
        ring16 = torch.zeros(1, geo.ring16)
        for name, mod in mods.items():
            with FlopCounterMode(display=False) as fc:
                if name == "contentvec":
                    mod(ring16)
                elif name == "synthesizer":
                    T = geo.return_frames
                    mod(torch.zeros(1, T, mod.s.feature_dim), torch.zeros(1, T, dtype=torch.long),
                        torch.zeros(1, T), torch.zeros(1, dtype=torch.long))
                else:
                    mel = torch.zeros(1, 128, geo.pitch_frames)
                    mod(mel if name == "rmvpe" else mel.transpose(1, 2))
            out[name] = int(fc.get_total_flops())
        with FlopCounterMode(display=False) as fc:
            ref.outputs(torch.zeros(1, 9 * geo.chunk), torch.full((1,), 8, dtype=torch.long))
        out["total"] = int(fc.get_total_flops())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--write", action="store_true")
    args = p.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for conf in spec["configs"]:
        path = root / conf["file"]
        cfg = json.loads(path.read_text())
        counts = count(cfg)
        print(conf["name"], json.dumps(counts))
        if args.write:
            cfg["flops_per_chunk"] = counts
            path.write_text(json.dumps(cfg, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
