"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last: each number compared, with its limit). The
last lines of standard error repeat the checks. Without the CUDA cards the
cell asks for, or with a module of JAX or of the JAX package loaded, the
run prints no result and exits with a code other than 0.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    try:
        from benchmark import harness

        return harness.run(args, T_PROCESS)
    except Exception:  # the boundary of the run: no result line, a non-zero exit
        traceback.print_exc()
        print("no result: the run failed", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
