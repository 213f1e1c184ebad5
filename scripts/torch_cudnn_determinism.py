"""Which piece of the PyTorch port's step is not bitwise repeatable on a
CUDA card, in each compute dtype, with cuDNN's default algorithms and with
``torch.backends.cudnn.deterministic``, and what the setting costs.

For each dtype (float32, bfloat16) at full width:

- each piece of one eager step (``pre``, the features, ``mel``,
  ``salience``, ``pitch_post``, ``synth``, ``post``) is run ``--reps``
  times on the same recorded inputs and held bit for bit against its first
  output: the elements that differ and the largest difference;
- in a piece that differs, the first leaf module (in the order they ran)
  whose output differs, by forward hooks over the repeats;
- the voiced stream of ``chip_smoke.py`` (24 chunks) through the eager step
  ``--streams`` times: each stream's relative max difference from the first
  (``chip_smoke.py``'s "eager vs eager" check, bound 1e-3);
- each stage graph's device time (CUDA events around replays,
  ``scripts/torch_bench.py:stage_device_ms``) at 1 and 8 streams, the
  graphs captured under each setting.

    PYTHONPATH=. python3 scripts/torch_cudnn_determinism.py [--reps 8] [--streams 6]

Writes ``chiprun_out/cudnn_determinism.json``; prints a line a finding.
"""
import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import torch_bench  # noqa: E402
from obs_rvc_tpu_torch.config import ChunkConfig  # noqa: E402
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving  # noqa: E402
from obs_rvc_tpu_torch.ops import _cuda  # noqa: E402
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState  # noqa: E402
from obs_rvc_tpu_torch.stream.graphs import leaves  # noqa: E402


def tensors(tree):
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def record_pieces(pipe, state, chunk, controls):
    """One eager step through a runner that keeps each piece's (fn, args, outputs)."""
    pieces = {}

    def run(name, fn, *args, device=None):
        if device is not None:
            args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
        out = fn(*args)
        pieces[name] = (fn, args, [t.clone() for t in tensors(out)])
        return out

    pipe._run_steps(state, chunk, controls, None, run)
    return pieces


def leaf_outputs(pipe, fn, args):
    """Every leaf module's output (its first tensor) in one call of ``fn``, in the order they ran."""
    outs, hooks = [], []
    for net, module in pipe.modules().items():
        for name, m in module.named_modules():
            if not list(m.children()):
                def hook(_m, _inp, out, key=f"{net}.{name}"):
                    t = out[0] if isinstance(out, tuple) else out
                    if isinstance(t, torch.Tensor):
                        outs.append((key, t.detach().clone()))
                hooks.append(m.register_forward_hook(hook))
    try:
        fn(*args)
    finally:
        for h in hooks:
            h.remove()
    return outs


def repeat_pieces(pipe, pieces, reps):
    res = {}
    for name, (fn, args, want) in pieces.items():
        ndiff, worst, first_leaf = 0, 0.0, None
        for _ in range(reps):
            got = tensors(fn(*args))
            for g, w in zip(got, want):
                d = g.float() - w.float()
                ndiff += int((g != w).sum())
                worst = max(worst, float(d.abs().max()) if d.numel() else 0.0)
        if ndiff:
            ref = leaf_outputs(pipe, fn, args)
            for _ in range(reps):
                for (key, a), (_, b) in zip(ref, leaf_outputs(pipe, fn, args)):
                    if not torch.equal(a, b):
                        first_leaf = key if first_leaf is None else first_leaf
                        break
                if first_leaf:
                    break
        res[name] = {"elements_differing": ndiff, "max_abs_diff": worst, "first_leaf_differing": first_leaf}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--streams", type=int, default=6)
    args = ap.parse_args()
    _cuda.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    cfg = ChunkConfig.build()
    report = {"device": smi, "reps": args.reps, "streams": args.streams}
    wav = torch.from_numpy(cs.voiced_signal(cs.N_CHUNKS * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size].cuda() for i in range(cs.N_CHUNKS)]
    controls = StepControls.default()
    for dtype in ("float32", "bfloat16"):
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype))
        pipe.init_params(cs.SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        with torch.no_grad():
            state = pipe.new_state()
            for c in chunks[:12]:
                state, _ = pipe.step(state, c, controls)
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                key = f"{dtype} deterministic={det}"
                r = report[key] = {}
                pieces = record_pieces(pipe, state, chunks[12], controls)
                r["pieces"] = repeat_pieces(pipe, pieces, args.reps)
                print(f"{key}: pieces repeated {args.reps} times on the same inputs:",
                      {k: v["elements_differing"] for k, v in r["pieces"].items()},
                      {k: v["first_leaf_differing"] for k, v in r["pieces"].items() if v["first_leaf_differing"]},
                      flush=True)
                first = cs.stream(pipe.step, pipe, chunks, controls)[0]
                rels = [float((cs.stream(pipe.step, pipe, chunks, controls)[0] - first).abs().max())
                        / float(first.abs().max()) for _ in range(args.streams - 1)]
                r["stream_rel_vs_first"] = rels
                print(f"{key}: {args.streams} eager streams of {len(chunks)} chunks, relative max difference "
                      f"from the first: {rels}", flush=True)
                for batch in (1, 8):
                    p = pipe.with_config(cfg)  # graphs of its own, captured under this setting
                    s, chunk = (StreamState.init_batch(cfg, batch, device=p.device),
                                torch.stack([chunks[12]] * batch)) if batch > 1 else (p.new_state(), chunks[12])
                    c = StepControls.stack([controls] * batch, p.device) if batch > 1 else controls
                    ms = [torch_bench.stage_device_ms(p, batch, s, chunk, c)[0] for _ in range(3)]
                    r[f"stage_device_ms_b{batch}"] = {k: float(np.median([m[k] for m in ms])) for k in ms[0]}
                    print(f"{key}: stage graphs' device ms at {batch} stream(s) (median of 3): "
                          + ", ".join(f"{k} {v:.4f}" for k, v in r[f"stage_device_ms_b{batch}"].items()), flush=True)
                    del p
        torch.backends.cudnn.deterministic = False
        del pipe
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "cudnn_determinism.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
