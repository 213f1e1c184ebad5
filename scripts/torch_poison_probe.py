"""Whether the PyTorch port's eager step reads device memory it never wrote:
the voiced stream of ``chip_smoke.py`` (24 chunks) through the eager step at
full width, once as it is and once for each poison, where before every
chunk the allocator's cached free memory is filled with the poison (NaN,
1e4, random values), so every buffer the step allocates and does not write
holds it. Every piece of every step (``pre``, the features, ``mel``,
``salience``, ``pitch_post``, ``synth``, ``post``) is held bit for bit
against the unpoisoned stream, and the first (chunk, piece) that differs is
reported. On a card, in float32 (cuDNN held to its deterministic
algorithms, which repeat bit for bit) and bfloat16.

    PYTHONPATH=. python3 scripts/torch_poison_probe.py

Writes ``chiprun_out/poison_probe.json``.
"""
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from obs_rvc_tpu_torch.config import ChunkConfig  # noqa: E402
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving  # noqa: E402
from obs_rvc_tpu_torch.ops import _cuda  # noqa: E402
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls  # noqa: E402
from obs_rvc_tpu_torch.stream.graphs import leaves  # noqa: E402

#: blocks filled and freed before each chunk: the small pool's sizes (under 1 MiB) and the large pool's
SMALL = [512 * 2**i for i in range(12)] * 24
LARGE = [2**20 * m for m in (1, 2, 3, 5, 8, 13, 21, 34, 55, 89)] * 3


def poison(kind: str, gen: torch.Generator) -> None:
    blocks = []
    for nbytes in SMALL + LARGE:
        t = torch.empty(nbytes // 4, dtype=torch.float32, device="cuda")
        if kind == "nan":
            t.fill_(float("nan"))
        elif kind == "big":
            t.fill_(1e4)
        else:
            t.uniform_(-1e3, 1e3, generator=gen)
        blocks.append(t)
    torch.cuda.synchronize()
    del blocks  # back to the allocator's cache, the poison in them


def recorded_stream(pipe, chunks, controls, kind):
    rec = []

    def run(name, fn, *args, device=None):
        out = fn(*args)
        rec.append((name, [t.clone() for t in leaves(out) if isinstance(t, torch.Tensor)]))
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    state = pipe.new_state()
    with torch.no_grad():
        for c in chunks:
            if kind is not None:
                poison(kind, gen)
            state, _ = pipe._run_steps(state, c, controls, None, run)
    torch.cuda.synchronize()
    return rec


def main() -> int:
    _cuda.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    cfg = ChunkConfig.build()
    wav = torch.from_numpy(cs.voiced_signal(cs.N_CHUNKS * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size].cuda() for i in range(cs.N_CHUNKS)]
    controls = StepControls.default()
    report = {"device": smi}
    for dtype in ("float32", "bfloat16"):
        torch.backends.cudnn.deterministic = True
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype))
        pipe.init_params(cs.SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        clean = recorded_stream(pipe, chunks, controls, None)
        per_step = len(clean) // len(chunks)
        for kind in (None, "nan", "big", "random"):
            got = recorded_stream(pipe, chunks, controls, kind)
            first, finite = None, all(bool(torch.isfinite(t.float()).all()) for _, ts in got for t in ts)
            for i, ((name, a), (_, b)) in enumerate(zip(clean, got)):
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    first = {"chunk": i // per_step, "piece": name,
                             "max_abs_diff": max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)),
                             "elements": sum(int((x != y).sum()) for x, y in zip(a, b))}
                    break
            report[f"{dtype} {kind or 'repeat'}"] = {"first_difference": first, "all_finite": finite}
            print(f"{dtype}, poison {kind or 'none (a repeat)'}: first piece that differs from the clean stream: "
                  f"{first}; all finite: {finite}", flush=True)
        del pipe, clean
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "poison_probe.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
