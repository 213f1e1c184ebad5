"""Benchmark the port's streaming step on one CUDA card: the counterpart of
the root ``bench.py``, with each stage's device time (the counterpart of
``scripts/tpu_stage_timing.py``).

Runs the full pipeline (ContentVec → pitch network → synthesizer →
resample/RMS/SOLA) at the reference's default geometry (48 kHz stream, 0.3 s
chunks, 2 s context, RVC v2 40k) at full width on random weights from seed
0, through the graphed step a server replays: ``jit_step`` (``--mode
fused``, one CUDA graph; ``auto`` is fused) or ``staged_step`` (a graph per
stage), and ``jit_step_batch`` or the batched stage graphs for ``--batch``
above 1. Prints ONE JSON line last, in ``bench.py``'s shape: the p50 chunk
latency in ms against the 80 ms BASELINE target (``vs_baseline`` > 1 is
faster), and in ``extra`` p95, the sustained ms a chunk (steps chained
through the state, one read at the end), audio-seconds a second, MFU
against the card's peak (989 TFLOP/s bfloat16, 67 float32), each stage's
device time (CUDA events around back-to-back replays of that stage's own
graph, ``stage_device_ms``), the card's name and power limit, and PyTorch's
TF32 settings. The numbers are unrounded but ``vs_baseline``.

TF32 stays at PyTorch's defaults, as a server runs it (``chip_smoke.py``
turns it off). ``--profile DIR`` writes a ``torch.profiler`` trace of the
measured steps to DIR and prints the device's busy share and the hand
kernels' launches a step. With no card the script fails unless it is given
``--device cpu``; there the graphs run eagerly, the kernels take their plain
versions and the stage times are host times around eager stages: a test
path, not a measurement. Any failure exits non-zero and prints no line.

    python3 scripts/torch_bench.py                      # bfloat16, one stream, fused
    python3 scripts/torch_bench.py --batch 8 --mode staged --profile bench_trace
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

#: BASELINE.md's p50 target for one chunk, ms
TARGET_P50_MS = 80.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--batch", type=int, default=1, help="concurrent streams, one step for all")
    p.add_argument("--mode", choices=["staged", "fused", "auto"], default="auto",
                   help="staged = a CUDA graph per stage; fused = one graph of the step; auto = fused")
    p.add_argument("--profile", metavar="DIR", help="write a torch.profiler trace of the measured steps to DIR")
    p.add_argument("--pitch-algorithm", default="rmvpe", choices=["rmvpe", "crepe", "fcpe"])
    p.add_argument("--crepe-capacity", default="full", choices=["full", "tiny"])
    p.add_argument("--no-pallas-resblocks", action="store_true",
                   help="refused: on the card it would put the plain versions on the main path")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p


def card(device) -> tuple:
    """(name, power limit in W) from ``nvidia-smi`` on a card; ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    from obs_rvc_tpu_torch.utils.benchlib import nvidia_smi_line

    name, limit = nvidia_smi_line().rsplit(",", 1)  # "NVIDIA H100 80GB HBM3, 700.00 W"
    return name.strip(), float(limit.strip().removesuffix("W"))


def stage_device_ms(pipe, batch, state, chunk, controls) -> tuple:
    """Each stage's ms at ``batch`` streams, and the stages whose replays
    wrote their own arguments (none does: replayed alone, each graph does
    its step's work). On a card: one staged step from a copy of ``state``
    (capturing the stage graphs if need be) leaves ``chunk``'s inputs in
    each stage graph's arguments, then CUDA events time that graph alone,
    replayed back to back. On the CPU: the host ms of each eager stage."""
    import torch

    from obs_rvc_tpu_torch.stream.graphs import leaves
    from obs_rvc_tpu_torch.utils.benchlib import replay_ms

    scratch = state.map(torch.clone)
    if pipe.device.type != "cuda":
        times = {}
        pipe.staged_step(scratch, chunk, controls, stage_times=times, batched=batch > 1)
        return times, []
    pipe.staged_step(scratch, chunk, controls, batched=batch > 1)
    times, written = {}, []
    for name, graph in pipe.staged_batch_graphs(batch).graphs.items():
        args = [t for t in leaves(graph.static_args) if isinstance(t, torch.Tensor)]
        before = [t.clone() for t in args]
        times[name] = replay_ms(graph.replay)
        if not all(torch.equal(a, b) for a, b in zip(args, before)):
            written.append(name)
    return times, written


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from obs_rvc_tpu_torch.config import StreamSettings
    from obs_rvc_tpu_torch.device import resolve_device
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.models.crepe import CrepeConfig
    from obs_rvc_tpu_torch.serve.cli import check_ported
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState
    from obs_rvc_tpu_torch.utils import benchlib
    from obs_rvc_tpu_torch.utils.flops import chunk_gflops

    check_ported(args)
    if args.steps < 2 or args.warmup < 1:
        raise SystemExit("--steps must be at least 2 (the sustained rate is a difference of two chains) and "
                         "--warmup at least 1 (its first step captures the graphs)")
    device = resolve_device(args.device)  # raises with no card: never a silent move to the CPU
    on_card = device.type == "cuda"
    if args.profile and not on_card:
        raise SystemExit("--profile traces the card's kernels: it needs a CUDA device")
    cfg = StreamSettings().chunk_config(48000)
    pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, args.dtype), pitch_algorithm=args.pitch_algorithm,
                       crepe_cfg=CrepeConfig(args.crepe_capacity) if args.pitch_algorithm == "crepe" else None,
                       device=device)
    pipe.init_params(0)
    if args.dtype == "bfloat16":
        cast_params_for_serving(pipe)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    build_s = 0.0
    if on_card:
        from obs_rvc_tpu_torch.ops import _cuda

        build_s = _cuda.build()  # the kernels' nvcc builds (none when built), apart from the capture
        print(f"build: {build_s:.1f} s", file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    controls1 = StepControls.default(pitch_shift=12.0, rms_mix_rate=0.5)
    mode = "fused" if args.mode == "auto" else args.mode
    B = args.batch
    if B == 1:
        state = pipe.new_state()
        step = pipe.staged_step if mode == "staged" else pipe.jit_step
        controls = controls1
        shape = (cfg.sample_frame_size,)
    else:
        state = StreamState.init_batch(cfg, B, device=pipe.device)
        step = functools.partial(pipe.staged_step, batched=True) if mode == "staged" else pipe.jit_step_batch
        controls = StepControls.stack([controls1] * B, pipe.device)
        shape = (B, cfg.sample_frame_size)

    def make_chunk():
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1).to(pipe.device)

    def check_finite(out):
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("the step emitted non-finite audio")

    with torch.no_grad():
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        # warm-up: the first call captures the graphs (capture_seconds holds the warm-up call before the capture)
        t0 = time.perf_counter()
        for _ in range(args.warmup):
            state, out = step(state, make_chunk(), controls)
        check_finite(out.cpu())
        graphs = ([pipe.batch_graph(B).graph] if mode == "fused"
                  else list(pipe.staged_batch_graphs(B).graphs.values()))
        capture_s = sum(g.capture_seconds for g in graphs)
        print(f"capture: {capture_s:.3f} s ({len(graphs)} graphs; warm-up of {args.warmup} steps "
              f"{time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)

        # synchronous per-chunk latency: the new chunk on the device, then the emitted audio on the host
        prof = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            state, _ = step(state, make_chunk(), controls)  # not counted: the tracer can miss the first kernels
            benchlib.mark_trace()
        times = []
        t_loop = time.perf_counter()
        for _ in range(args.steps):
            chunk = make_chunk()
            sync()
            t0 = time.perf_counter()
            state, out = step(state, chunk, controls)
            out = out.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
            check_finite(out)
        loop_ms = (time.perf_counter() - t_loop) * 1e3
        profiled = None
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, "trace.json.gz")
            prof.export_chrome_trace(trace)
            events = benchlib.events_after_mark(prof)
            busy = benchlib.device_busy_ms(events)
            counts = benchlib.kernel_counts(events)
            profiled = {"trace": trace, "traced_steps": args.steps, "kernels_in_trace": counts,
                        "device_busy_ms_per_step": busy / args.steps, "busy_share": busy / loop_ms}
            print(f"profile: device busy {busy / args.steps:.3f} ms a step of {loop_ms / args.steps:.3f} "
                  f"({busy / loop_ms:.1%}); hand kernels a step "
                  + ", ".join(f"{k} {v / args.steps:g}" for k, v in counts.items()) + f"; trace {trace}",
                  file=sys.stderr, flush=True)

        # sustained: steps chained through the carried state on one resident chunk, one read at the end
        chunk_dev = torch.zeros(shape, device=pipe.device)
        sync()

        def run_chain(n):
            nonlocal state
            t0 = time.perf_counter()
            for _ in range(n):
                state, out = step(state, chunk_dev, controls)
            check_finite(out.reshape(-1)[:1].cpu())  # the read forces the sync
            return time.perf_counter() - t0

        t_one = min(run_chain(1) for _ in range(3))
        t_all = run_chain(args.steps)
        sustained_ms = (t_all - t_one) / (args.steps - 1) * 1e3
        if not sustained_ms > 0:
            raise AssertionError(f"{args.steps} chained steps took no longer than one ({t_all:.4f} s, {t_one:.4f} s)")

        stages, written = stage_device_ms(pipe, B, state, make_chunk(), controls)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    print("stage ms (" + ("device, CUDA events around replays" if on_card else "host, eager") + "): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; sum {sum(stages.values()):.3f}; sustained "
          f"{sustained_ms:.3f}" + (f"; peak memory {peak_mib:.1f} MiB" if on_card else ""),
          file=sys.stderr, flush=True)

    p50 = statistics.median(times)
    p95 = sorted(times)[max(0, int(len(times) * 0.95) - 1)]
    chunk_s = cfg.sample_frame_size / cfg.sample_rate
    gflop = chunk_gflops(pipe)
    peak = benchlib.BF16_PEAK_FLOPS if args.dtype == "bfloat16" else benchlib.F32_PEAK_FLOPS
    name, power = card(pipe.device)
    extra = {
        "p95_ms": p95,
        "sustained_ms_per_chunk": sustained_ms,
        "rtf": (p50 / 1e3) / chunk_s,
        "audio_seconds_per_second": B * chunk_s / (sustained_ms / 1e3),
        "mfu": B * gflop * 1e9 / (sustained_ms / 1e3) / peak,
        "model_gflops_per_chunk": gflop,
        "batch": B,
        "mode": mode,
        "pitch_algorithm": args.pitch_algorithm,
        **({"crepe_capacity": args.crepe_capacity} if args.pitch_algorithm == "crepe" else {}),
        "dtype": args.dtype,
        "chunk_ms": chunk_s * 1e3,
        "backend": pipe.device.type,
        "device_name": name,
        "power_limit_w": power,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "stage_device_ms": stages,
        "stage_device_ms_sum": sum(stages.values()),
        "stage_inputs_written": written,
        "capture_s": capture_s,
        "build_s": build_s,
        "peak_memory_mib": peak_mib,
        **({"profile": profiled} if profiled else {}),
    }
    numbers = [p50, p95, sustained_ms, *stages.values()]
    if not all(math.isfinite(v) for v in numbers):
        raise AssertionError(f"a measurement is not finite: {numbers}")
    print(json.dumps({"metric": "chunk_p50_ms", "value": p50, "unit": "ms",
                      "vs_baseline": round(TARGET_P50_MS / p50, 3), "extra": extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
