"""Measure the port's serving pool: ``StreamPool`` ticks on the card, the
counterpart of ``scripts/pool_bench.py``.

Drives ``--streams`` synthetic streams through one pool (bfloat16 networks
at full width, random weights from seed 0): every tick feeds each slot one
chunk and calls ``process_pending`` (the worker loop's body, without the
thread). Prints one JSON line: the tick's p50 wall ms, with p95, the pool's
audio-seconds per second, ms per chunk, the median of each tick phase
(``last_tick_phases``) and, in fused mode, the pool's own tick graph
replayed on its resident arguments (``raw_step_ms``), so that tick minus
step is the host's share. ``--realtime S`` then paces ticks on the wall
clock for S seconds and counts deadline misses. The card's name and power
limit (``nvidia-smi``) are in the line. The float32 and TF32 settings are
PyTorch's defaults, a server's (``chip_smoke.py`` turns TF32 off).

    python scripts/torch_pool_bench.py --streams 64 --mode fused --io-dtype int16 --pipelined
    python scripts/torch_pool_bench.py --device cpu --skip-inference --streams 4 \\
        --sample-length 0.10 --extra-inference-time 0.5 --ticks 5      # a smoke on the CPU
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--mode", choices=["staged", "fused"], default="fused")
    ap.add_argument("--io-dtype", choices=["float32", "int16"], default="float32",
                    help="the PCM width to and from the card (int16 halves the bytes)")
    ap.add_argument("--pipelined", action="store_true",
                    help="deliver a tick's output after the next tick's dispatch (+1 tick of latency)")
    ap.add_argument("--no-exec-cache", action="store_true")
    ap.add_argument("--sample-length", type=float, default=0.30)
    ap.add_argument("--extra-inference-time", type=float, default=2.00)
    ap.add_argument("--skip-inference", action="store_true")
    ap.add_argument("--pitch-algorithm", default="rmvpe", choices=["rmvpe", "crepe", "fcpe"])
    ap.add_argument("--realtime", type=float, default=0.0, metavar="SECONDS",
                    help="after the throughput ticks, tick on the wall clock (one chunk per slot every chunk) "
                         "for SECONDS and count the ticks whose output was late")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from obs_rvc_tpu_torch.config import StreamSettings
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.stream import RvcPipeline, StreamPool

    B = args.streams
    cfg = StreamSettings(sample_length=args.sample_length, extra_inference_time=args.extra_inference_time,
                         skip_inference=args.skip_inference).chunk_config(48000)
    pipe = RvcPipeline(cfg, compute_dtype=torch.bfloat16, pitch_algorithm=args.pitch_algorithm, device=args.device)
    pipe.init_params(0, std=None)
    if pipe.modules():
        cast_params_for_serving(pipe)

    build_s = 0.0
    if pipe.device.type == "cuda":
        from obs_rvc_tpu_torch.ops import _cuda

        build_s = _cuda.build()  # the kernels' nvcc builds, apart from the capture
    t0 = time.perf_counter()
    pool = StreamPool(pipe, capacity=B, mode=args.mode, exec_cache=not args.no_exec_cache, input_capacity_chunks=4,
                      output_capacity_chunks=4, io_dtype=args.io_dtype, pipelined=args.pipelined)
    pool.prepare()
    capture_s = time.perf_counter() - t0
    slots = [pool.attach() for _ in range(B)]
    chunk = cfg.sample_frame_size
    frames = np.random.default_rng(0).standard_normal((B, chunk)).astype(np.float32) * 0.1
    phase_log, pulled, ticked = [], [0] * B, [0]

    def tick():
        for k, s in enumerate(slots):
            pool.push_audio(s, frames[k])
        t = time.perf_counter()
        n = pool.process_pending()
        if n != B:
            raise AssertionError(f"a tick fed {n} slots of {B}")
        dt = (time.perf_counter() - t) * 1e3
        ticked[0] += 1
        phase_log.append(dict(pool.last_tick_phases))
        for k, s in enumerate(slots):
            pulled[k] += pool.pull_audio(s, chunk).size  # pipelined ticks deliver one tick late
        return dt

    with torch.no_grad():
        for _ in range(args.warmup):
            tick()
        print(f"capture {capture_s:.1f} s, setup and warm-up {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        phase_log.clear()
        times = [tick() for _ in range(args.ticks)]
        phases = {k: statistics.median(p[k] for p in phase_log) for k in phase_log[0]}
        p50 = statistics.median(times)
        p95 = sorted(times)[max(0, int(len(times) * 0.95) - 1)]
        chunk_s = chunk / cfg.sample_rate

        step_ms = None
        if args.mode == "fused":
            # the pool's own tick graph on its resident arguments, synchronized: the device's share of a tick
            graph = pool._fused()
            raw = frames if args.io_dtype == "float32" else \
                np.clip(np.rint(frames * 32768.0), -32768, 32767).astype(np.int16)
            controls = pool._controls_device(list(pool._controls), pool._controls_version)
            with pool._on_stream():
                chunks_dev, mask_dev = pool._to_device(raw), pool._to_device(np.zeros(B, bool))
                sts = []
                for _ in range(max(args.ticks // 2, 5)):
                    t = time.perf_counter()
                    graph.run(pool._states, chunks_dev, controls, mask_dev)
                    if pipe.device.type == "cuda":
                        torch.cuda.current_stream().synchronize()
                    sts.append((time.perf_counter() - t) * 1e3)
            step_ms = statistics.median(sts)

        realtime = None
        if args.realtime > 0:
            # one chunk per slot every chunk_s on an absolute schedule; a tick misses when its
            # output is not back by the next chunk boundary
            n_ticks = int(args.realtime / chunk_s)
            lateness, misses = [], 0
            start = time.perf_counter()
            for k in range(n_ticks):
                due = start + k * chunk_s
                while (wait := due - time.perf_counter()) > 0:
                    time.sleep(min(wait, 0.01))
                tick()
                late = time.perf_counter() - due - chunk_s
                lateness.append(late * 1e3)
                misses += late > 0
            lateness.sort()
            realtime = {"paced_seconds": n_ticks * chunk_s, "ticks": n_ticks, "deadline_misses": misses,
                        "miss_rate": misses / max(n_ticks, 1), "lateness_p50_ms": lateness[len(lateness) // 2],
                        "lateness_p95_ms": lateness[max(0, int(len(lateness) * 0.95) - 1)],
                        "lateness_max_ms": lateness[-1]}

        # every chunk pushed comes back
        pool.flush_pending()
        for k, s in enumerate(slots):
            pulled[k] += pool.pull_audio(s, ticked[0] * chunk).size
        if any(p != ticked[0] * chunk for p in pulled):
            raise AssertionError(f"chunks missing: {pulled}")

    result = {
        "metric": "pool_tick_p50_ms",
        "value": p50,
        "unit": "ms",
        "extra": {
            "streams": B, "mode": args.mode, "io_dtype": args.io_dtype, "pipelined": args.pipelined,
            "pitch_algorithm": args.pitch_algorithm, "device": card_line(pipe.device),
            # PyTorch's defaults, as a server runs: cuDNN may take TF32 for the float32 convolutions (pos_conv)
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            **({"realtime": realtime} if realtime else {}),
            "p95_ms": p95,
            "pool_audio_seconds_per_second": B * chunk_s / (p50 / 1e3),
            "per_chunk_ms": p50 / B,
            "phases_ms": phases,
            "capture_s": capture_s, "build_s": build_s,
            **({"raw_step_ms": step_ms, "host_overhead_ms": p50 - step_ms,
                "host_overhead_pct": (p50 - step_ms) / p50 * 100.0} if step_ms else {}),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
