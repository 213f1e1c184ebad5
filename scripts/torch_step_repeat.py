"""Whether a fresh process's first eager stream of the PyTorch port's step
gives the same bits as its later ones on a CUDA card, and where it first
moves when it does not.

Each child process does what ``chip_smoke.py`` does before its
``main_bf16`` "eager vs eager" check: a float32 pipeline at full width
streams the voiced signal (24 chunks) eagerly, captures the fused and the
staged graphs and streams through both, and is dropped; then a bfloat16
pipeline streams the same chunks eagerly twice. Every piece of every step
(``pre``, the features, ``mel``, ``salience``, ``pitch_post``, ``synth``,
``post``) is kept, and the first (chunk, piece) whose output differs between
the two bfloat16 streams is reported, with its largest difference. The
children run ``--lanes`` at a time on the one card.

    PYTHONPATH=. python3 scripts/torch_step_repeat.py [--children 12] [--lanes 3]

Writes ``chiprun_out/step_repeat.json``.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def child(out_path: str) -> None:
    import torch

    import chip_smoke as cs
    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls
    from obs_rvc_tpu_torch.stream.graphs import leaves

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ChunkConfig.build()
    wav = torch.from_numpy(cs.voiced_signal(cs.N_CHUNKS * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size].cuda() for i in range(cs.N_CHUNKS)]
    controls = StepControls.default()
    t0 = time.perf_counter()
    f32 = RvcPipeline(cfg)
    f32.init_params(cs.SEED, std=None)
    cs.stream(f32.step, f32, chunks, controls)
    cs.stream(f32.jit_step, f32, chunks, controls)
    cs.stream(f32.staged_step, f32, chunks, controls)
    del f32
    torch.cuda.empty_cache()
    pipe = RvcPipeline(cfg, compute_dtype=torch.bfloat16)
    pipe.init_params(cs.SEED, std=None)
    cast_params_for_serving(pipe)

    def recorded_stream():
        rec = []

        def run(name, fn, *args, device=None):
            out = fn(*args)
            rec.append((len(rec), name, [t.clone() for t in leaves(out) if isinstance(t, torch.Tensor)]))
            return out

        state = pipe.new_state()
        with torch.no_grad():
            for c in chunks:
                state, _ = pipe._run_steps(state, c, controls, None, run)
        torch.cuda.synchronize()
        return rec

    first, second = recorded_stream(), recorded_stream()
    per_step = len(first) // len(chunks)
    result = {"seconds": time.perf_counter() - t0, "first_difference": None}
    for (i, name, a), (_, _, b) in zip(first, second):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
            n = sum(int((x != y).sum()) for x, y in zip(a, b))
            result["first_difference"] = {"chunk": i // per_step, "piece": name, "max_abs_diff": diff,
                                          "elements": n}
            break
    emitted = [torch.cat([r[2][0].flatten() for r in rec if r[1] == "post"]).float() for rec in (first, second)]
    result["emitted_rel"] = float((emitted[1] - emitted[0]).abs().max() / emitted[0].abs().max())
    pathlib.Path(out_path).write_text(json.dumps(result))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--children", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    from obs_rvc_tpu_torch.ops import _cuda
    from obs_rvc_tpu_torch.utils.benchlib import nvidia_smi_line

    _cuda.build()  # once, before the children load it
    smi = nvidia_smi_line()
    print(smi, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    results, pending = [], list(range(args.children))
    running = []
    while pending or running:
        while pending and len(running) < args.lanes:
            i = pending.pop(0)
            path = out / f"step_repeat_{i}.json"
            running.append((i, path, subprocess.Popen([sys.executable, __file__, "--child", str(path)])))
        time.sleep(1)
        for item in list(running):
            i, path, proc = item
            if proc.poll() is not None:
                running.remove(item)
                r = json.loads(path.read_text()) if proc.returncode == 0 else {"rc": proc.returncode}
                path.unlink(missing_ok=True)
                results.append({"child": i, **r})
                print(f"child {i}: {r}", flush=True)
    moved = [r for r in results if r.get("first_difference")]
    print(f"{len(moved)} of {len(results)} fresh processes' first bfloat16 eager stream differed from their second",
          flush=True)
    (out / "step_repeat.json").write_text(json.dumps({"device": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
