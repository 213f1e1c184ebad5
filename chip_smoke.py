#!/usr/bin/env python3
"""Drive the PyTorch port's streaming step on one CUDA card and check it.

    python3 chip_smoke.py            # every phase; needs one card
    python3 chip_smoke.py --profile  # also torch.profiler traces: a few steps, one call of each chain level and bank

Phases, each printing its own lines:

1. device  the card's name and power limit, CUDA, nvcc and Triton versions
2. build   compile the kernels under obs_rvc_tpu_torch/csrc with nvcc, one
           process per source, all at once
3. parity  each CUDA kernel against its plain PyTorch version on the card,
           at the main path's shapes (float32 and bfloat16 for the U-Net
           chain and the resblock bank; float32 for the log-mel frontend,
           also at a ragged and an offline length and on silence), TF32 off
4. main    RvcPipeline.step at the default geometry and full width (v2
           ContentVec, full RMVPE, 40 kHz synthesizer) on random weights,
           streaming a voiced test signal; the kernels' launch counters must
           rise by 1 (log-mel), 4 (U-Net chain) and 2 (resblock bank) per
           step; then three chunks are rerun stage by stage on the card and
           on the CPU with the same inputs, and each stage's time is taken
           apart
5. serve   the port's server (serve.server.main) on a thread at the same
           geometry and width, listening on the duplex, WebSocket, RPC and
           health ports: a StreamClient and a WsStreamClient stream the
           voiced signal (12 and 4 chunks at least), RpcClient requests come
           at two geometries (the launch one checked against an in-process
           RvcEngine), and serve.cli converts a WAV file; every chunk and request served
           must raise the counters by 1/4/2, and /metrics must count no error
6. timing  step p50/p95; each kernel's device time (CUDA events around a
           CUDA graph of its calls) beside its bound, its plain version, one
           PyTorch composite of the same function and its eager call; the
           U-Net chain and the resblock bank level by level beside cuDNN,
           their bounds at the 3xTF32 rate their float32 paths run at (165
           TFLOP/s) with float32's 67 TFLOP/s beside them, the bank's grid
           (blocks, blocks an SM holds, the share of conv1's rows recomputed
           as halo); peak device memory

The line before the last is the card's name and power limit; before that a
JSON line describes every kernel. The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import platform
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

F32_PEAK_FLOPS = 67e12  # H100 SXM, float32 without tensor cores
#: H100 SXM, float32 products as three TF32 tensor-core products (3xTF32: 495 / 3 TFLOP/s),
#: the rate the chain's and the bank's float32 paths can reach
TF32X3_PEAK_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
N_SMS = 132  # H100 SXM
SEED = 0
#: chunks streamed through the step on the card (the first 4 are warm-up)
N_CHUNKS = 24
#: chunks the serve phase streams through the duplex door, at least
SERVE_CHUNKS = 12
#: chunks it streams through the WebSocket door, at least
WS_CHUNKS = 4
OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 10, replays: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around replays of
    a CUDA graph that holds ``calls`` calls, so the host's per-launch cost
    (Python, ctypes, the launch itself) is not in it. Warmed up first on a
    side stream, which also lets cuDNN's autotuner choose before capture."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def check_close(name, got, want, atol, rtol) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if not bool(got.isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
                             f"atol={atol} rtol={rtol}; max abs err {max_err:.3e}")
    return max_err


# ---------------------------------------------------------------------------
# the two kernels at the main path's shapes
# ---------------------------------------------------------------------------

# (label, B, H, W, Cin, C): the C<=32 U-Net levels of the full RMVPE on a
# 64-frame x 128-mel input, four ConvBlockRes blocks each
CHAIN_SHAPES = [("enc0", 1, 64, 128, 1, 16), ("enc1", 1, 32, 64, 16, 32),
                ("dec3", 1, 32, 64, 64, 32), ("dec4", 1, 64, 128, 32, 16)]
# (label, B, L, C): the 40 kHz generator's C=64 and C=32 levels for T=35 frames
BANK_SHAPES = [("ups2", 1, 7000, 64), ("ups3", 1, 14000, 32)]
# a C=16 level (the JAX package's im2col bank range), at twice the C=32
# level's length; on no path of the default step, gated and timed all the same
BANK_EXTRA_SHAPES = [("c16", 1, 28000, 16)]
BANK_KS, BANK_DILS = (3, 7, 11), (1, 3, 5)
N_BLOCKS = 4
# (label, L, signal): the log-mel frontend's inputs. "main" is the RMVPE
# window of the default chunk (T=64 frames); T=63 is one frame short of
# it; 3 s is an offline length (T=301, past the Pallas kernel's 256-frame
# tile)
MEL_SHAPES = [("main", 10080, "voiced"), ("main-normal", 10080, "normal"), ("T63", 9920, "voiced"),
              ("offline", 48000, "voiced"), ("silence", 10080, "silence")]
MEL_MAIN = "main"
MEL_BOUND = (2e-4, 1e-4)  # the JAX package's own bound for its Pallas kernel


def chain_inputs(label, B, H, W, cin, C, device, rng):
    import torch

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    blocks = []
    ci = cin
    for i in range(N_BLOCKS):
        w1 = t(rng.standard_normal((3, 3, ci, C)) / np.sqrt(9 * ci))
        w2 = t(rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C))
        b1, b2 = t(rng.standard_normal(C) * 0.05), t(rng.standard_normal(C) * 0.05)
        wsc = bsc = None
        if ci != C:
            wsc, bsc = t(rng.standard_normal((ci, C)) / np.sqrt(ci)), t(rng.standard_normal(C) * 0.05)
        blocks.append((w1, b1, w2, b2, wsc, bsc))
        ci = C
    x = t(rng.standard_normal((B, H, W, cin)) * 0.5)
    return x, blocks


def chain_flops_bytes(B, H, W, cin, C, elem=4):
    flops, wbytes, ci = 0, 0, cin
    for _ in range(N_BLOCKS):
        flops += 2 * 9 * ci * C * H * W + 2 * 9 * C * C * H * W
        wbytes += 4 * (9 * ci * C + 9 * C * C + 2 * C)
        if ci != C:
            flops += 2 * ci * C * H * W
            wbytes += 4 * (ci * C + C)
        ci = C
    return B * flops, B * H * W * (cin + C) * elem + wbytes


def bank_inputs(label, B, L, C, device, rng):
    import torch

    params = []
    for k in BANK_KS:
        s = 1.0 / np.sqrt(k * C)
        params.append(tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            rng.standard_normal((3, k, C, C)) * s, rng.standard_normal((3, C)) * 0.05,
            rng.standard_normal((3, k, C, C)) * s, rng.standard_normal((3, C)) * 0.05)))
    x = torch.from_numpy((rng.standard_normal((B, L, C)) * 0.5).astype(np.float32)).to(device)
    return x, params


def bank_flops_bytes(B, L, C, elem=4):
    flops = B * sum(len(BANK_DILS) * 2 * 2 * k * C * C * L for k in BANK_KS)
    wbytes = 4 * sum(len(BANK_DILS) * 2 * (k * C * C + C) for k in BANK_KS)
    return flops, 2 * B * L * C * elem + wbytes


def bank_grid(B, L, C, dtype):
    """The bank kernel's launches at one level: the grid, what an SM holds
    (at the largest dilation, whose halo takes the most shared memory), the
    waves over the card's SMs and the share of the first conv's rows a
    block computes as its neighbours' halo, per kernel size."""
    from obs_rvc_tpu_torch.ops import resblock

    out = {}
    for k in BANK_KS:
        info = resblock.launch_info(C, k, max(BANK_DILS), dtype)
        blocks = B * -(-L // info["tile"])
        rows = blocks * (info["conv1_rows"] + info["tile"])  # conv1's and conv2's m16 rows, all blocks
        out[k] = dict(info, blocks=blocks, waves=blocks / (N_SMS * info["blocks_per_sm"]),
                      recomputed=1.0 - 2 * B * L / rows)
    return out


def mel_inputs(L, kind, device, rng):
    import torch

    x = {"voiced": voiced_signal(L, 16000), "normal": rng.standard_normal(L).astype(np.float32),
         "silence": np.zeros(L, np.float32)}[kind]
    return torch.from_numpy(x).to(device)


def mel_flops_bytes(L, basis, packed, n_fft=1024, hop=160):
    """What the function needs per frame: the window product, one real FFT
    of 1024 points (2.5 N log2 N, the usual count for a real transform), the
    513 bins' magnitudes, the mel product over the basis's nonzero entries
    (the triangles) and the 128 logs; bytes: the signal, the window, the
    basis as the kernel reads it (``packed``: the weights of each row's run
    and the rows' int32 starts, offsets and pieces) and the output, each
    once."""
    T = 1 + L // hop
    n_bins = n_fft // 2 + 1
    nnz = int((basis != 0).sum())
    n_mels = basis.shape[0]
    per_frame = n_fft + 2.5 * n_fft * np.log2(n_fft) + 4 * n_bins + 2 * nnz + n_mels
    basis_bytes = sum(t.numel() * t.element_size() for t in packed[:4])
    return T * per_frame, 4 * (L + n_fft + n_mels * T) + basis_bytes


def bound_ms(flops, nbytes, peak=F32_PEAK_FLOPS):
    t_ops, t_mem = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def phase_parity(report):
    import torch

    from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram
    from obs_rvc_tpu_torch.ops import resblock, stft_mel, unet_block

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("parity", "TF32 off for cuDNN and matmul: the plain versions run in full float32")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    bounds = {"chain": {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 2e-2)},
              "bank": {torch.float32: (1e-4, 1e-3), torch.bfloat16: (3e-2, 2e-2)}}
    out = {"conv_block_res_chain": {}, "resblock_bank": {}, "log_mel": {}}
    mel = MelSpectrogram(device=dev)  # the step's basis and window, and the basis packed for the kernel
    win, basis = mel.window, mel.mel_basis
    for label, L, kind in MEL_SHAPES:
        x = mel_inputs(L, kind, dev, rng)
        got = stft_mel.log_mel(x, mel.log_mel_basis, win)
        want = stft_mel.log_mel_plain(x, basis, win)
        torch.cuda.synchronize()
        err = check_close(f"log_mel {label}", got, want, *MEL_BOUND)
        if kind == "silence":
            check_close("log_mel silence = ln(1e-5)", got, torch.full_like(got, float(np.log(1e-5))), 1e-5, 0.0)
        out["log_mel"][f"{label} float32"] = err
        log("parity", f"log_mel {label} L={L} -> [128, {got.shape[1]}] {kind} float32: max abs err {err:.3e} "
                      f"(bound {MEL_BOUND[0]}/{MEL_BOUND[1]}), |ref| max {float(want.abs().max()):.3g}")
    for label, B, H, W, cin, C in CHAIN_SHAPES:
        x, blocks = chain_inputs(label, B, H, W, cin, C, dev, rng)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = unet_block.conv_block_res_chain(xd, unet_block.pack_chain(blocks, dt))
            want = unet_block.conv_block_res_chain_plain(xd, blocks)
            torch.cuda.synchronize()
            atol, rtol = bounds["chain"][dt]
            err = check_close(f"chain {label} {dt}", got, want, atol, rtol)
            out["conv_block_res_chain"][f"{label} {str(dt)[6:]}"] = err
            log("parity", f"conv_block_res_chain {label} [{B},{H},{W},{cin}]->{C} {str(dt)[6:]}: "
                          f"max abs err {err:.3e} (bound {atol}/{rtol}), |ref| max {float(want.float().abs().max()):.3g}")
    for label, B, L, C in BANK_SHAPES + BANK_EXTRA_SHAPES:
        x, params = bank_inputs(label, B, L, C, dev, rng)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = resblock.resblock_bank(xd, resblock.pack_bank(params, BANK_KS, BANK_DILS, dt), BANK_KS, BANK_DILS)
            want = resblock.resblock_bank_plain(xd, params, BANK_KS, BANK_DILS)
            torch.cuda.synchronize()
            atol, rtol = bounds["bank"][dt]
            err = check_close(f"bank {label} {dt}", got, want, atol, rtol)
            out["resblock_bank"][f"{label} {str(dt)[6:]}"] = err
            log("parity", f"resblock_bank {label} [{B},{L},{C}] {str(dt)[6:]}: max abs err {err:.3e} "
                          f"(bound {atol}/{rtol}), |ref| max {float(want.float().abs().max()):.3g}")
    report["parity"] = out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def voiced_signal(n, sr, seed=SEED):
    """A harmonic tone at 180 Hz with 5 Hz vibrato and a little noise."""
    t = np.arange(n) / sr
    f = 180.0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def phase_main(report, n_chunks):
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

    cfg = ChunkConfig.build()
    t0 = time.perf_counter()
    pipe = RvcPipeline(cfg)  # the card, full width: v2 ContentVec, full RMVPE, 40 kHz synthesizer
    pipe.init_params(SEED, std=None)
    log("main", f"pipeline on {pipe.device}, random fan-in-scaled weights from seed {SEED} "
                f"({time.perf_counter() - t0:.1f} s); chunk {cfg.sample_frame_size} samples, "
                f"16 kHz ring {cfg.input_buffer_16k_size}, RMVPE window {cfg.rmvpe_frame_16k} "
                f"({cfg.rmvpe_n_frames} frames), T={cfg.return_length} -> {cfg.model_return_size} samples")
    log("main", "float32 throughout, TF32 off for cuDNN and matmul (set in the parity phase)")
    controls = StepControls.default(pitch_shift=0.0, rms_mix_rate=1.0)
    wav = torch.from_numpy(voiced_signal(n_chunks * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size].to(pipe.device)
              for i in range(n_chunks)]
    compare_at = {n_chunks // 2, n_chunks // 2 + 1, n_chunks // 2 + 2}
    saved = {}
    state = pipe.new_state()
    outs, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i, chunk in enumerate(chunks):
        if i in compare_at:
            saved[i] = state
        t0 = time.perf_counter()
        state, out = pipe.step(state, chunk, controls)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    audio = torch.cat(outs).cpu()
    log("main", f"streamed {n_chunks} chunks; kernel launches {launches}")
    check_launches("main", launches, n_chunks)
    if audio.shape != (n_chunks * cfg.sample_frame_size,) or not bool(torch.isfinite(audio).all()):
        raise AssertionError(f"output shape {tuple(audio.shape)} or non-finite values")
    tail = audio[4 * cfg.sample_frame_size :]
    log("main", f"output {tuple(audio.shape)} all finite, max |y| {float(audio.abs().max()):.4f}, "
                f"rms after warm-up {float(tail.pow(2).mean().sqrt()):.4f}")
    if float(tail.abs().max()) < 1e-3:
        raise AssertionError("the converted audio is silent")
    steady = np.asarray(times[4:])
    report["main"] = {
        "chunks": n_chunks, "launches": launches, "peak_mem_bytes": int(peak),
        "step_ms": times, "step_p50_ms": float(np.percentile(steady, 50)),
        "step_p95_ms": float(np.percentile(steady, 95)),
        "rtf": float(np.percentile(steady, 50)) / (1e3 * cfg.sample_frame_size / cfg.sample_rate),
    }
    compare_with_cpu(report, pipe, saved, chunks, controls)
    stage_breakdown(report, pipe, state, chunks[:12], controls)
    return pipe, state, chunks, controls


#: launches of each kernel's wrapper per step (and per engine request)
LAUNCHES_PER_STEP = {"log_mel": 1, "conv_block_res_chain": 4, "resblock_bank": 2}


def _counter_modules():
    from obs_rvc_tpu_torch.ops import resblock, stft_mel, unet_block

    return {"log_mel": stft_mel, "conv_block_res_chain": unet_block, "resblock_bank": resblock}


def reset_launches():
    for mod in _counter_modules().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in _counter_modules().items()}


def check_launches(phase, launches, steps):
    want = {k: v * steps for k, v in LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"{phase}: expected {want} launches for {steps} steps, got {launches}")


def stage_breakdown(report, pipe, state, chunks, controls):
    """Host-clock time of each stage of the step, each ended by a
    synchronize, p50 over the chunks: where the step's time goes."""
    import torch

    from obs_rvc_tpu_torch.stream import StreamState

    times = {n: [] for n in ("pre", "features", "mel", "salience", "pitch_post", "synth", "post")}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        for chunk in chunks:
            buf, buf16 = timed("pre", pipe.stage_pre, state, chunk)
            phone = timed("features", pipe.stage_features, buf16)
            mel = timed("mel", pipe.stage_mel, buf16)
            sal = timed("salience", pipe.stage_salience, mel)
            cache, pitch, pitchf = timed("pitch_post", pipe.stage_pitch_post, state.cache_pitchf, sal, controls)
            audio = timed("synth", pipe.stage_synth, phone, pitch, pitchf, controls.sid)
            _, sola = timed("post", pipe.stage_post, buf, audio, state.sola_buffer, controls.rms_mix_rate)
            state = StreamState(buf, buf16, sola, cache)
    p50 = {n: float(np.percentile(v[2:], 50)) for n, v in times.items()}
    report["stages_p50_ms"] = p50
    log("main", f"stage p50 over {len(chunks) - 2} chunks, each ended by a synchronize: "
                + ", ".join(f"{n} {v:.2f} ms" for n, v in p50.items()) + f"; sum {sum(p50.values()):.2f} ms")


def phase_profile(report, pipe, state, chunks, controls, steps: int = 5):
    """torch.profiler over a few steps: the device's busy share of the wall
    time and the operators that take most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for chunk in chunks[:2]:
        state, _ = pipe.step(state, chunk, controls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for chunk in chunks[2 : 2 + steps]:
            state, _ = pipe.step(state, chunk, controls)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # the device's own events (kernels, copies), not the operators that launched them
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    step_ms = wall_ms / steps
    report["profile"] = {"step_ms": step_ms, "device_busy_ms_per_step": busy,
                         "top": [{"ms_per_step": r[0], "calls_per_step": r[1], "name": r[2]} for r in rows[:25]]}
    if not rows:
        log("profile", "torch.profiler recorded no device time: the device breakdown is not measured")
        return
    log("profile", f"{steps} steps, {step_ms:.2f} ms each on the host clock; device busy {busy:.2f} ms "
                   f"per step ({busy / step_ms:.1%}), idle {1 - busy / step_ms:.1%}")
    for ms, calls, name in rows[:25]:
        log("profile", f"  {ms:8.3f} ms/step {calls:5d} calls/step  {name[:110]}")


def compare_with_cpu(report, pipe, saved, chunks, controls):
    """Rerun chunks stage by stage on the card and on the CPU, each stage fed
    the card's inputs to it, and hold the two against each other."""
    import torch

    from obs_rvc_tpu_torch.stream import RvcPipeline

    cpu = RvcPipeline(pipe.cfg, device="cpu")
    for name, module in pipe.modules().items():
        cpu.modules()[name].load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    # relative errors are max|card - cpu| / max|cpu|: the card reorders float32
    # sums (cuDNN, cuBLAS, the two kernels) through 12 + 20 + 30 layers; the
    # log-mel's ln(max(|X|, 1e-5)) turns the reordering's relative error in the
    # smallest spectral magnitudes into an absolute one near ln(1e-5) = -11.5
    tol = {"buf16": 1e-5, "features": 1e-4, "mel": 1e-4, "salience": 1e-4, "pitchf": 1e-5,
           "synth_audio": 1e-3, "emitted": 1e-3}
    worst = {k: 0.0 for k in tol}
    codes_equal = True

    def rel(a, b):
        b = b.float()
        return float((a.float().cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-12)

    with torch.no_grad():
        for i, state in sorted(saved.items()):
            c = lambda t: t.cpu()  # noqa: E731
            buf, buf16 = pipe.stage_pre(state, chunks[i])
            cbuf, cbuf16 = cpu.stage_pre(state.to("cpu"), c(chunks[i]))
            phone = pipe.stage_features(buf16)
            mel = pipe.stage_mel(buf16)
            sal = pipe.stage_salience(mel)
            cache, pitch, pitchf = pipe.stage_pitch_post(state.cache_pitchf, sal, controls)
            audio = pipe.stage_synth(phone, pitch, pitchf, controls.sid)
            emitted, _ = pipe.stage_post(buf, audio, state.sola_buffer, controls.rms_mix_rate)
            _, cpitch, cpitchf = cpu.stage_pitch_post(c(state.cache_pitchf), c(sal), controls)
            errs = {
                "buf16": rel(buf16, cbuf16),
                "features": rel(phone, cpu.stage_features(c(buf16))),
                "mel": rel(mel, cpu.stage_mel(c(buf16))),
                "salience": rel(sal, cpu.stage_salience(c(mel))),
                "pitchf": rel(pitchf, cpitchf),
                "synth_audio": rel(audio, cpu.stage_synth(c(phone), c(pitch), c(pitchf), controls.sid)),
                "emitted": rel(emitted, cpu.stage_post(c(buf), c(audio), c(state.sola_buffer),
                                                       controls.rms_mix_rate)[0]),
            }
            same_codes = bool(torch.equal(pitch.cpu(), cpitch))
            codes_equal &= same_codes
            for k, v in errs.items():
                worst[k] = max(worst[k], v)
            log("main", f"chunk {i} card vs CPU, relative max errors: "
                        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                        + f"; f0 codes equal: {same_codes}")
    report["cpu_compare"] = {"relative_max_err": worst, "tolerance": tol, "codes_equal": codes_equal}
    log("main", "stage tolerances (relative to max|cpu|): " + ", ".join(f"{k} {v:g}" for k, v in tol.items()))
    bad = [k for k in tol if worst[k] > tol[k]]
    if bad or not codes_equal:
        raise AssertionError(f"card and CPU disagree: {bad or 'f0 codes'} ({worst})")


# ---------------------------------------------------------------------------
# the serving front doors
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_metrics_settled(url, timeout_s=60.0) -> dict:
    """/metrics once two reads a second apart agree (the sessions are done)."""
    prev, deadline = None, time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with urllib.request.urlopen(url, timeout=30) as r:
            cur = json.loads(r.read())
        if prev is not None and cur["chunks"] == prev["chunks"]:
            return cur
        prev = cur
        time.sleep(1.0)
    raise AssertionError(f"/metrics did not settle within {timeout_s} s")


def stream_door(name, send_audio, wav, frame, chunk, want_chunks, sample_rate):
    """Push ``wav`` through a streaming door in ``frame``-sample messages,
    paced as an audio callback would push them, then silence until
    ``want_chunks`` chunks came back; checks each reply and the total."""
    out = []
    for i in range(0, wav.size, frame):
        out.append(send_audio(wav[i : i + frame]))
        time.sleep(frame / sample_rate)
    deadline = time.monotonic() + 120
    while sum(o.size for o in out) < want_chunks * chunk and time.monotonic() < deadline:
        out.append(send_audio(np.zeros(frame, np.float32)))
        time.sleep(frame / sample_rate)
    if any(o.size > frame or o.dtype != np.float32 for o in out):
        raise AssertionError(f"{name}: a reply was longer than its {frame}-sample message or not float32")
    streamed = np.concatenate(out)
    if streamed.size < want_chunks * chunk:
        raise AssertionError(f"{name}: {streamed.size} samples back, fewer than {want_chunks} chunks")
    tail = streamed[2 * chunk :]
    if not np.isfinite(streamed).all() or float(np.abs(tail).max()) < 1e-3:
        raise AssertionError(f"{name}: the streamed audio is not finite or is silent")
    return streamed


def phase_serve(report, main_pipe):
    """The port's server on a thread, driven through its front doors."""
    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.serve import cli, server
    from obs_rvc_tpu_torch.serve.rpc import RpcClient
    from obs_rvc_tpu_torch.serve.stream_server import StreamClient
    from obs_rvc_tpu_torch.serve.ws import WsStreamClient
    from obs_rvc_tpu_torch.stream import RvcEngine
    from obs_rvc_tpu_torch.utils import read_wav, write_wav

    host = "127.0.0.1"
    cfg = main_pipe.cfg
    ports = {name: free_port() for name in ("duplex", "ws", "rpc", "health")}
    # the defaults: the card, float32, v2 at 40 kHz, 0.3 s chunks; random weights from seed 0, fan-in
    # scaled, as the main phase's pipeline
    argv = ["--host", host, "--port", str(ports["duplex"]), "--ws-port", str(ports["ws"]),
            "--rpc-port", str(ports["rpc"]), "--health-port", str(ports["health"])]
    log("serve", "python -m obs_rvc_tpu_torch.serve.server " + " ".join(argv))
    stop, listening, bound, failed = threading.Event(), threading.Event(), {}, []

    def on_ready(b):
        bound.update(b)
        listening.set()

    def run():
        try:
            server.main(argv, ready=on_ready, stop_event=stop)
        except BaseException as e:  # reported on the main thread
            failed.append(e)
            listening.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True, name="chip-smoke-server")
    thread.start()
    try:
        if not listening.wait(600) or failed:
            raise AssertionError(f"the server did not come up: {failed}")
        log("serve", f"server listening in {time.perf_counter() - t0:.1f} s: {bound}")
        metrics_url = f"http://{host}:{bound['health']}/metrics"
        reset_launches()

        # 1. the duplex stream and 2. its WebSocket form, each converting whole chunks
        chunk, frame = cfg.sample_frame_size, 2400
        for door, connect, n in (
                ("duplex", lambda: StreamClient.connect_tcp(host, bound["duplex"], timeout=120), SERVE_CHUNKS),
                ("websocket", lambda: WsStreamClient.connect(host, bound["ws"], timeout=120), WS_CHUNKS)):
            wav = voiced_signal((n + 2) * chunk, cfg.sample_rate, seed=SEED + 2)
            client, t_stream = connect(), time.perf_counter()
            streamed = stream_door(door, client.send_audio, wav, frame, chunk, n, cfg.sample_rate)
            client.close()
            log("serve", f"{door}: {streamed.size} samples back ({streamed.size / chunk:.2f} chunks) in "
                         f"{time.perf_counter() - t_stream:.1f} s, all finite, tail max |y| "
                         f"{float(np.abs(streamed[2 * chunk :]).max()):.4f}")

        # 3. the reference RPC door at the launch geometry and at the 0.5 s chunk's
        cfg2 = ChunkConfig.build(sample_length=0.50)
        requests = []
        for i, c in enumerate([cfg, cfg, cfg, cfg2, cfg2]):
            x = voiced_signal(c.input_buffer_16k_size, 16000, seed=SEED + 10 + i)
            requests.append((c is cfg, (x, c.sample_frame_16k_size, 0, c.skip_head, c.return_length)))
        rpc = RpcClient.connect_tcp(host, bound["rpc"], timeout=300)
        replies, rtt = [], []
        for _, req in requests:
            t1 = time.perf_counter()
            y = rpc.infer(*req)
            rtt.append((time.perf_counter() - t1) * 1e3)
            if y.shape != (req[4] * 400,) or not np.isfinite(y).all():
                raise AssertionError(f"RPC reply of shape {y.shape} (want {(req[4] * 400,)}) or not finite")
            replies.append(y)
        rpc.close()
        log("serve", "rpc: replies " + ", ".join(f"{y.size}" for y in replies) + " samples, all finite; "
                     "round trips " + ", ".join(f"{v:.1f}" for v in rtt) + " ms")

        # 4. the offline CLI on a WAV file
        OUT_DIR.mkdir(exist_ok=True)
        src, dst = OUT_DIR / "serve_in.wav", OUT_DIR / "serve_out.wav"
        cli_chunks = 5
        write_wav(src, voiced_signal(cli_chunks * chunk, cfg.sample_rate, seed=SEED + 3), cfg.sample_rate)
        t1 = time.perf_counter()
        cli.main([str(src), str(dst), "--metrics-json"])
        converted, sr = read_wav(dst)
        if sr != cfg.sample_rate or converted.shape != (1, cli_chunks * chunk) or \
                not np.isfinite(converted).all() or float(np.abs(converted).max()) < 1e-3:
            raise AssertionError(f"serve.cli wrote {converted.shape} at {sr} Hz, or silence")
        log("serve", f"cli: {src.name} -> {dst.name}, {converted.shape[1]} samples in "
                     f"{time.perf_counter() - t1:.1f} s (pipeline set-up included)")

        metrics = wait_metrics_settled(metrics_url)
        launches = read_launches()
        served = metrics["chunks"] + len(requests) + cli_chunks
        log("serve", f"/metrics {metrics}")
        log("serve", f"launches {launches} for {metrics['chunks']} session chunks + {len(requests)} RPC "
                     f"requests + {cli_chunks} CLI chunks")
        check_launches("serve", launches, served)
        if metrics["chunks"] < SERVE_CHUNKS or metrics["errors"] != 0:
            raise AssertionError(f"/metrics counts {metrics['chunks']} chunks and {metrics['errors']} errors")
    finally:
        stop.set()
        thread.join(30)
    if thread.is_alive() or failed:
        raise AssertionError(f"the server did not stop cleanly: {failed}")

    # the launch-geometry replies against an in-process engine on the same
    # weights, inputs and f0 history (the server's engine saw them first)
    engine = RvcEngine(main_pipe)
    rel = []
    for (at_launch, req), y in zip(requests, replies):
        if at_launch:
            want = engine.infer(*req)
            rel.append(float(np.abs(y - want).max()) / max(float(np.abs(want).max()), 1e-12))
    log("serve", "rpc vs in-process engine, max|diff| / max|audio|: " + ", ".join(f"{r:.2e}" for r in rel)
                 + " (bound 1e-3: the card's float32 sums are not bitwise repeatable)")
    if max(rel) > 1e-3:
        raise AssertionError(f"RPC replies disagree with the in-process engine: {rel}")
    rtt_launch = [v for (at_launch, _), v in zip(requests, rtt) if at_launch]
    report["serve"] = {
        "ports": bound, "metrics": metrics, "launches": launches, "served_steps": served,
        "rpc_round_trip_ms": rtt, "rpc_round_trip_p50_ms": float(np.percentile(rtt_launch, 50)),
        "rpc_vs_engine_rel": rel, "session_chunk_p50_ms": metrics["p50_ms"],
    }
    log("serve", f"RPC round trip p50 {report['serve']['rpc_round_trip_p50_ms']:.2f} ms at the launch geometry; "
                 f"session chunk p50 {metrics['p50_ms']:.2f} ms, p95 {metrics['p95_ms']:.2f} ms (/metrics)")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def kernel_trace(fn, per: int, calls: int = 3):
    """torch.profiler's device events of ``calls`` eager calls of ``fn``
    that launch ``per`` kernels each, one list per call: ``(kernel name,
    device us, us since the call's first kernel started)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()  # the tracer can miss a call's first kernels right after it starts: not counted
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)[-per * calls :]
    out = []
    for c in range(calls):
        chunk = ev[c * per : (c + 1) * per]
        t0 = chunk[0].time_range.start if chunk else 0.0
        out.append([(e.name, e.time_range.end - e.time_range.start, e.time_range.start - t0) for e in chunk])
    return out


def phase_timing(report, trace=False):
    import torch
    import torch.nn.functional as F

    from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram
    from obs_rvc_tpu_torch.ops import resblock, stft_mel, unet_block

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    rows = {}

    def mel_library(x, win, basis):
        """One PyTorch composite of the same function: torch.stft (cuFFT),
        magnitude, the mel product, log of the clamp."""
        def run():
            spec = torch.stft(x, n_fft=1024, hop_length=160, win_length=1024, window=win, center=True,
                              pad_mode="reflect", return_complex=True).abs()
            return torch.log(torch.clamp(basis @ spec, min=1e-5))
        return run

    def chain_library(x, blocks):
        """cuDNN's best: NCHW channels_last convs, autotuned."""
        h = x.permute(0, 3, 1, 2)
        ws = [(w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), b1,
               w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), b2,
               None if wsc is None else wsc.T[:, :, None, None].contiguous(memory_format=torch.channels_last),
               bsc) for w1, b1, w2, b2, wsc, bsc in blocks]

        def run():
            y0 = h
            for w1, b1, w2, b2, wsc, bsc in ws:
                y = F.relu(F.conv2d(y0, w1, b1, padding=1))
                y = F.relu(F.conv2d(y, w2, b2, padding=1))
                y0 = (F.conv2d(y0, wsc, bsc) if wsc is not None else y0) + y
            return y0
        return run

    def bank_library(x, params):
        """cuDNN's best: the bank as autotuned conv1d calls on [B, C, L]."""
        xt = x.transpose(1, 2).contiguous()
        ws = [tuple((w[s].permute(2, 1, 0).contiguous(), b[s]) for s in range(len(BANK_DILS))
                    for w, b in ((w1, b1), (w2, b2))) for w1, b1, w2, b2 in params]

        def run():
            total = None
            for k, convs in zip(BANK_KS, ws):
                a = xt
                for s, d in enumerate(BANK_DILS):
                    (w1, b1), (w2, b2) = convs[2 * s], convs[2 * s + 1]
                    t = F.leaky_relu(F.conv1d(F.leaky_relu(a, 0.1), w1, b1, padding=d * (k - 1) // 2,
                                              dilation=d), 0.1)
                    a = a + F.conv1d(t, w2, b2, padding=(k - 1) // 2)
                total = a if total is None else total + a
            return total / len(BANK_KS)
        return run

    def measure(name, shape_label, kernel, plain, library, flops, nbytes, peak=F32_PEAK_FLOPS):
        """Kernel, plain version, library and kernel again, each as device
        time in a CUDA graph; the kernel's wrapper also eagerly, as the step
        calls it, where the host's launch cost shows."""
        torch.backends.cudnn.benchmark = False
        ms = graph_ms(kernel)
        plain_ms = graph_ms(plain)
        torch.backends.cudnn.benchmark = True
        library_ms = graph_ms(library)
        torch.backends.cudnn.benchmark = False
        ms2 = graph_ms(kernel)
        eager_ms = cuda_ms(kernel)
        b, by = bound_ms(flops, nbytes, peak)
        r = {"ms": min(ms, ms2), "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": b, "bound_by": by, "peak_tflops": peak / 1e12, "gflop": flops / 1e9,
             "mbytes": nbytes / 1e6}
        rows.setdefault(name, {})[shape_label] = r
        log("timing", f"{name} {shape_label}: kernel {r['ms']:.4f} ms on the device (runs {ms:.4f}, "
                      f"{ms2:.4f}), {eager_ms:.4f} ms called eagerly; plain {plain_ms:.4f} ms, "
                      f"library {library_ms:.4f} ms, bound {b:.4f} ms "
                      f"({by} at {peak / 1e12:.0f} TFLOP/s; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
                      f"{flops / (r['ms'] * 1e-3) / 1e12:.2f} TFLOP/s, {b / r['ms']:.1%} of the bound")

    for label, B, H, W, cin, C in CHAIN_SHAPES:
        x, blocks = chain_inputs(label, B, H, W, cin, C, dev, rng)
        packed = unet_block.pack_chain(blocks, x.dtype)  # as _Chain caches it per weight version
        flops, nbytes = chain_flops_bytes(B, H, W, cin, C)
        measure("conv_block_res_chain", label, lambda: unet_block.conv_block_res_chain(x, packed),
                lambda: unet_block.conv_block_res_chain_plain(x, blocks), chain_library(x, blocks),
                flops, nbytes, peak=TF32X3_PEAK_FLOPS)
        rows["conv_block_res_chain"][label]["bound_ms_f32_cuda_cores"] = bound_ms(flops, nbytes)[0]
        if trace:
            calls = kernel_trace(lambda: unet_block.conv_block_res_chain(x, packed), 2 * N_BLOCKS)
            last = calls[-1]
            rows["conv_block_res_chain"][label]["trace_us"] = last
            log("profile", f"chain {label}: {len(last)} kernels per call, span "
                           f"{last[-1][2] + last[-1][1]:.1f} us (last of {len(calls)} calls); each kernel "
                           + ", ".join(f"{d:.1f} us at +{t:.1f}" for _, d, t in last))
    chain_rows = rows["conv_block_res_chain"]
    for label, r in chain_rows.items():
        log("timing", f"chain level {label}: kernel {r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
                      f"({r['ms'] / r['library_ms']:.2f}x cuDNN's time), eager one-call wrapper "
                      f"{r['eager_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms at 3xTF32's 165 TFLOP/s, "
                      f"{r['bound_ms_f32_cuda_cores']:.4f} ms at float32's 67 TFLOP/s")
    log("timing", "chain per step (4 levels): kernel "
                  f"{sum(r['ms'] for r in chain_rows.values()):.4f} ms, eager "
                  f"{sum(r['eager_ms'] for r in chain_rows.values()):.4f} ms, cuDNN "
                  f"{sum(r['library_ms'] for r in chain_rows.values()):.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in chain_rows.values()):.4f} ms (3xTF32) / "
                  f"{sum(r['bound_ms_f32_cuda_cores'] for r in chain_rows.values()):.4f} ms (float32 CUDA cores)")
    for label, B, L, C in BANK_SHAPES + BANK_EXTRA_SHAPES:
        x, params = bank_inputs(label, B, L, C, dev, rng)
        packed = resblock.pack_bank(params, BANK_KS, BANK_DILS, x.dtype)  # as GeneratorNSF caches it
        flops, nbytes = bank_flops_bytes(B, L, C)
        measure("resblock_bank", label, lambda: resblock.resblock_bank(x, packed, BANK_KS, BANK_DILS),
                lambda: resblock.resblock_bank_plain(x, params, BANK_KS, BANK_DILS),
                bank_library(x, params), flops, nbytes, peak=TF32X3_PEAK_FLOPS)
        r = rows["resblock_bank"][label]
        r["bound_ms_f32_cuda_cores"] = bound_ms(flops, nbytes)[0]
        r["grid"] = bank_grid(B, L, C, x.dtype)
        for k, gr in r["grid"].items():
            log("timing", f"bank {label} k={k}: {gr['blocks']} blocks of {gr['threads']} threads, "
                          f"{gr['tile']} positions each, {gr['smem_bytes']} B shared memory at d={max(BANK_DILS)}, "
                          f"{gr['registers']} registers; {gr['blocks_per_sm']} blocks an SM, "
                          f"{gr['waves']:.2f} waves over {N_SMS} SMs; conv1 {gr['conv1_rows']} rows a block, "
                          f"{gr['recomputed']:.1%} of the conv rows recomputed as halo or past L")
        if trace:
            n = len(BANK_KS) * len(BANK_DILS)
            calls = kernel_trace(lambda: resblock.resblock_bank(x, packed, BANK_KS, BANK_DILS), n)
            last = calls[-1]
            r["trace_us"] = last
            log("profile", f"bank {label}: {len(last)} kernels per call, span "
                           f"{last[-1][2] + last[-1][1]:.1f} us (last of {len(calls)} calls); each kernel (k, d) "
                           + ", ".join(f"({k},{d}) {dur:.1f} us at +{t:.1f}" for (k, d), (_, dur, t)
                                       in zip([(k, d) for k in BANK_KS for d in BANK_DILS], last)))
    bank_rows = rows["resblock_bank"]
    for label, r in bank_rows.items():
        log("timing", f"bank level {label}: kernel {r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
                      f"({r['ms'] / r['library_ms']:.2f}x cuDNN's time), eager one-call wrapper "
                      f"{r['eager_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms at 3xTF32's 165 TFLOP/s, "
                      f"{r['bound_ms_f32_cuda_cores']:.4f} ms at float32's 67 TFLOP/s")
    main_banks = [bank_rows[s[0]] for s in BANK_SHAPES]
    log("timing", f"bank per step ({len(main_banks)} levels): kernel {sum(r['ms'] for r in main_banks):.4f} ms, "
                  f"eager {sum(r['eager_ms'] for r in main_banks):.4f} ms, cuDNN "
                  f"{sum(r['library_ms'] for r in main_banks):.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in main_banks):.4f} ms (3xTF32) / "
                  f"{sum(r['bound_ms_f32_cuda_cores'] for r in main_banks):.4f} ms (float32 CUDA cores)")
    mel = MelSpectrogram(device=dev)
    win, basis = mel.window, mel.mel_basis
    for label, L, kind in MEL_SHAPES:
        if label not in (MEL_MAIN, "offline"):
            continue
        x = mel_inputs(L, kind, dev, rng)
        library = mel_library(x, win, basis)
        err = check_close(f"log_mel library composite {label}", library(), stft_mel.log_mel_plain(x, basis, win),
                          *MEL_BOUND)
        log("timing", f"log_mel {label}: the torch.stft composite agrees with the plain version "
                      f"(max abs err {err:.3e})")
        measure("log_mel", label, lambda: stft_mel.log_mel(x, mel.log_mel_basis, win),
                lambda: stft_mel.log_mel_plain(x, basis, win),
                library, *mel_flops_bytes(L, basis, mel.log_mel_basis))
    report["timing"] = rows


def kernel_line(report):
    srcs = {"log_mel": ("obs_rvc_tpu_torch/csrc/stft_mel.cu", "obs_rvc_tpu/ops/stft_mel.py:70"),
            "conv_block_res_chain": ("obs_rvc_tpu_torch/csrc/unet_block.cu", "obs_rvc_tpu/ops/unet_block.py:155"),
            "resblock_bank": ("obs_rvc_tpu_torch/csrc/resblock.cu", "obs_rvc_tpu/ops/resblock.py:298")}
    kernels = []
    for name, (src, replaces) in srcs.items():
        main_labels = {s[0] for s in CHAIN_SHAPES + BANK_SHAPES} | {MEL_MAIN}
        rows = [r for label, r in report["timing"][name].items() if label in main_labels]
        f32_errs = [v for k, v in report["parity"][name].items() if k.endswith("float32")]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": report["main"]["launches"][name],
            "max_abs_err": max(f32_errs),
            # per step: the sum over the main path's calls of the kernel
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
        })
    return {"kernels": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few steps with torch.profiler (device busy share, top operators)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from obs_rvc_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the obs_rvc_tpu_torch package is not importable here: {e}", file=sys.stderr)
        return 2

    report = {}
    smi = nvidia_smi_line()
    log("device", smi)
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log("device", f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, nvcc: {nvcc}, "
                  f"triton {triton_version}, python {platform.python_version()}, "
                  f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    report["device"] = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                        "nvcc": nvcc, "triton": triton_version}

    t0 = time.perf_counter()
    _cuda.build()
    log("build", f"nvcc built {_cuda.sources()} in {time.perf_counter() - t0:.1f} s "
                 f"(flags: {' '.join(_cuda.NVCC_FLAGS)})")
    for name, text in _cuda.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                log("build", f"{name}: {line.strip()}")

    phase_parity(report)
    main_run = phase_main(report, N_CHUNKS)
    if args.profile:
        phase_profile(report, *main_run)
    phase_serve(report, main_run[0])
    phase_timing(report, trace=args.profile)
    m = report["main"]
    log("timing", f"step p50 {m['step_p50_ms']:.2f} ms, p95 {m['step_p95_ms']:.2f} ms over "
                  f"{m['chunks'] - 4} steady chunks; real-time factor {m['rtf']:.4f} of the 300 ms chunk; "
                  f"peak device memory {m['peak_mem_bytes'] / 2**20:.1f} MiB")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(kernel_line(report)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
