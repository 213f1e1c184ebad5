"""The control of the comparison: the plain reference put in the program's
place, computed one precision below the configuration's (float8 e4m3 with
per-tensor scales for a bfloat16 configuration), and judged by the same
comparison as the program. It has to come out not correct.

    python benchmark/control.py --workload <name> --seeds 11,12,13 [--steps 24] [--sides control,program]

prints, per seed and side, the numbers compared and their per-chunk
readings: of the control and, with ``program`` among ``--sides``, of the
program over the same number of steps, each run in this one process. On the card at the cell's own size;
``benchmark/tests/test_bm_faults.py::test_the_control_is_not_correct`` runs it
at the CPU tests' sizes.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

LOWER = {"bfloat16": "fp8", "float16": "fp8"}


class ReferenceProgram:
    """The reference as a program: every stream stepped by
    :class:`~benchmark.reference.step.ReferenceStreams` with its own state,
    behind the same ``serve`` as :class:`~benchmark.harness.Program`."""

    def __init__(self, cfg: dict, traffic: dict, state_dicts: dict, device, precision=None):
        import torch

        from benchmark import harness, weights
        from benchmark.reference import nets
        from benchmark.reference import step as refstep

        if precision is None:
            precision = LOWER[cfg["dtype"]]
        door = traffic["door"]
        self.kind = door["kind"]
        self.streams = door.get("capacity", 1)
        self.device = torch.device(device)
        sds = {n: weights.round_to(sd, getattr(torch, cfg["dtype"])) for n, sd in state_dicts.items()}
        c = cfg["controls"]
        self.ref = refstep.build(harness.geometry(cfg), cfg["pitch"],
                                 {n: harness._asdict(s) for n, s in harness.sizes(cfg).items()}, sds,
                                 refstep.Controls(c["pitch_shift"], c["rms_mix_rate"], c.get("sid", 0)), device,
                                 nets.Precision(precision))
        self.chunk = self.ref.geo.chunk
        self.phases = []
        self.errors = 0
        self.reset()

    def reset(self) -> None:
        from benchmark.reference.step import ReferenceStreams

        self.state = ReferenceStreams(self.ref, self.streams, self.device)

    def serve(self, chunks):
        import torch

        t0 = time.perf_counter()
        out = self.state.step(torch.from_numpy(np.ascontiguousarray(chunks)).to(self.device)).cpu().numpy()
        return out, (time.perf_counter() - t0) * 1e3, [True] * self.streams

    def stage_graphs(self):
        return {}


def readings(workload: str, seed: int, steps: int, control: bool, device=None, root=None) -> dict:
    """The numbers compared in one short run of ``workload`` at ``seed``: of
    the control, or of the program."""
    from benchmark import harness

    out, err = io.StringIO(), io.StringIO()
    args = argparse.Namespace(workload=workload, seed=seed, seconds=3600.0, trace=0)
    kw = {"root": root} if root is not None else {}
    harness.run(args, time.perf_counter(), device=device, make_program=ReferenceProgram if control else None,
                max_steps=steps, out=out, err=err, **kw)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    return ({k: v["value"] for k, v in result["checks"].items()}
            | {"correct": result["correct"], "per_chunk": result["readings"]["per_chunk"]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--steps", type=int, default=24, help="steps of every stream a run makes")
    p.add_argument("--sides", default="control", help="comma-separated: control, program")
    args = p.parse_args(argv)
    sides = args.sides.split(",")
    if not set(sides) <= {"control", "program"}:
        p.error(f"unknown side in {args.sides!r}")
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in (side == "control" for side in sides):
            r = readings(args.workload, seed, args.steps, control)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": "control" if control else "program",
                              **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
