"""Whether ``torch.cumsum`` on a CUDA card gives the same bits call to call,
at the lengths the port's step scans: the NSF source's phase (``[B, T*upp]``,
14000 samples a stream at the default geometry), the RMS envelope's and
SOLA's energy sums, and longer ones. A ``[1, L]`` tensor is scanned by one
device-wide scan (PyTorch hands a scan whose length is the tensor's size to
CUB), a ``[B, L]`` one with ``B > 1`` row by row. Each shape is scanned
``--reps`` times on the same input and the calls whose output differs from
the first are counted: back to back, then with the card's state stirred
before each call (a spin of random length and a 64 MiB write, so the scan
meets other clocks and a cold L2, as it does inside a step), for
``torch.cumsum`` and for the port's ``dsp.scan.cumsum_rows``.

    PYTHONPATH=. python3 scripts/torch_cumsum_determinism.py [--reps 5000]

Writes ``chiprun_out/cumsum_determinism.json``.
"""
import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from obs_rvc_tpu_torch.dsp.scan import cumsum_rows  # noqa: E402
from obs_rvc_tpu_torch.utils.benchlib import nvidia_smi_line  # noqa: E402

LENGTHS = (2401, 14000, 15361, 38080, 140000, 1_000_000)


def count_mismatches(fn, x, reps, stir=None):
    first = fn(x)
    bad = 0
    for _ in range(reps):
        if stir is not None:
            stir()
        bad += int(not torch.equal(fn(x), first))
    torch.cuda.synchronize()
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5000)
    args = ap.parse_args()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    gen = torch.Generator().manual_seed(0)
    junk = torch.empty(16 * 2**20, device="cuda")
    spins = torch.randint(0, 20000, (100_000,), generator=gen).tolist()

    def stir():
        torch.cuda._sleep(spins[len(spins) - 1 - stir.n % len(spins)])
        junk.fill_(stir.n)
        stir.n += 1

    stir.n = 0
    report = {"device": smi, "reps": args.reps, "torch": torch.__version__, "rows": []}
    for L in LENGTHS:
        # a phase increment as the NSF source scans it: f0 / sr, around 180 Hz at 40 kHz
        base = (0.0045 + 0.001 * torch.rand(8, L, generator=gen)).cuda()
        for B in (1, 8):
            x = base[:B].contiguous()
            row = {"L": L, "B": B,
                   "torch_cumsum": count_mismatches(lambda t: torch.cumsum(t, dim=1), x, args.reps),
                   "torch_cumsum_stirred": count_mismatches(lambda t: torch.cumsum(t, dim=1), x, args.reps, stir),
                   "cumsum_rows_stirred": count_mismatches(lambda t: cumsum_rows(t, dim=1), x, args.reps, stir)}
            report["rows"].append(row)
            print(f"[{B}, {L}] float32: calls of {args.reps} whose output differs from the first: " + ", ".join(
                f"{k} {v}" for k, v in row.items() if k not in ("L", "B")), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "cumsum_determinism.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
