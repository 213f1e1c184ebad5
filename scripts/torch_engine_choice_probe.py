"""Whether cuDNN's choice of engine, and so the bits of the PyTorch port's
bfloat16 step, depends on the card's free memory when a thread first meets
a convolution: PyTorch keeps its cuDNN plans per thread and takes, at a
shape's first call, the first engine in cuDNN's heuristic order that runs,
skipping one whose workspace it cannot allocate.

The voiced stream of ``chip_smoke.py`` (24 chunks) through the eager step
at full width on the main thread, then on fresh threads (empty plan caches):
one with the card as it is, then with all but ``--free`` GiB of the card
held by a tensor. Each stream is held bit for bit against the main
thread's, piece by piece; the first (chunk, piece) that differs is printed.

    PYTHONPATH=. python3 scripts/torch_engine_choice_probe.py [--free 0.5 2 8]

Writes ``chiprun_out/engine_choice.json``.
"""
import argparse
import json
import pathlib
import sys
import threading

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from obs_rvc_tpu_torch.config import ChunkConfig  # noqa: E402
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving  # noqa: E402
from obs_rvc_tpu_torch.ops import _cuda  # noqa: E402
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls  # noqa: E402
from torch_poison_probe import recorded_stream  # noqa: E402


def first_difference(clean, got, per_step):
    for i, ((name, a), (_, b)) in enumerate(zip(clean, got)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            return {"chunk": i // per_step, "piece": name,
                    "max_abs_diff": max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))}
    return None


def on_thread(fn):
    """``fn()`` on a new thread; its exception's text in place of its result."""
    box = {}

    def body():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 (reported, not raised: an out-of-memory is a finding here)
            box["out"] = f"{type(e).__name__}: {e}"[:300]

    t = threading.Thread(target=body)
    t.start()
    t.join()
    return box["out"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--free", type=float, nargs="+", default=[0.5, 2.0, 8.0])
    args = ap.parse_args()
    _cuda.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    cfg = ChunkConfig.build()
    wav = torch.from_numpy(cs.voiced_signal(cs.N_CHUNKS * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size].cuda() for i in range(cs.N_CHUNKS)]
    controls = StepControls.default()
    pipe = RvcPipeline(cfg, compute_dtype=torch.bfloat16)
    pipe.init_params(cs.SEED, std=None)
    cast_params_for_serving(pipe)
    clean = recorded_stream(pipe, chunks, controls, None)
    per_step = len(clean) // len(chunks)
    report = {"device": smi, "runs": {}}

    def check(label, got):
        d = got if isinstance(got, str) else first_difference(clean, got, per_step)
        report["runs"][label] = d
        print(f"{label}: first piece that differs from the main thread's stream: {d}", flush=True)

    check("a fresh thread", on_thread(lambda: recorded_stream(pipe, chunks, controls, None)))
    for free in args.free:
        torch.cuda.empty_cache()
        avail, _ = torch.cuda.mem_get_info()
        hold = int(avail - free * 2**30)
        blocker = torch.empty(max(hold, 0), dtype=torch.uint8, device="cuda")
        try:
            got = on_thread(lambda: recorded_stream(pipe, chunks, controls, None))
        finally:
            del blocker
        check(f"a fresh thread with {free} GiB of the card free", got)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "engine_choice.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
