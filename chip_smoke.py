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
           streaming a voiced test signal, in float32 and then in bfloat16
           (compute_dtype, after cast_params_for_serving: the server's
           default); in each the kernels' launch counters must rise by 1
           (log-mel), 4 (U-Net chain) and 2 (resblock bank) per step; chunks
           are rerun stage by stage on the card and on the CPU in the same
           dtype with the same inputs and held to per-dtype bounds, and each
           stage's time is taken apart; the bfloat16 stream's deviation from
           the float32 one is printed; then a v1 step (ContentVec's final
           projection, a 256-feature synthesizer) in bfloat16 for a few chunks.
           After each, the graphed steps on the same pipeline and chunks:
           jit_step (one CUDA graph of the step) and staged_step (a graph per
           stage) against the eager step, bit-identical or within the float32
           bound of the emitted audio (the eager float32 step is itself not
           bitwise repeatable: cuDNN's float32 algorithms in RMVPE); capture
           times, step p50/p95, peak device memory and what the graphs hold;
           a torch.profiler trace of 5 replayed steps that must show 1
           log-mel, 32 chain and 18 bank kernel launches a step, and the
           device's busy share; MFU (utils/flops.py over step p50, against
           989 TFLOP/s in bfloat16 and 67 in float32); the controls changed
           mid-stream (pitch 0 -> 12 -> -5, rms_mix_rate 1 -> 0.5) with no
           capture; on v1, new weights after the capture reach both graphs
5. serve   the port's server (serve.server.main, at its defaults: bfloat16,
           staged graphs captured before it listens) on a thread at the same
           geometry and width, listening on the duplex, WebSocket, RPC and
           health ports: a StreamClient and a WsStreamClient stream the
           voiced signal (12 and 4 chunks at least), two duplex sessions at
           once must each equal its run alone, RpcClient requests come at two
           geometries (the launch one checked against an in-process bfloat16
           RvcEngine; the other captured at its first request), and serve.cli
           (float32, its default) converts a WAV file. Replays call no kernel
           wrapper, so the counters rise by 1/4/2 per call only in the
           warm-up and capture of the two graphs captured while serving; a
           device trace of replayed RPC requests and a duplex session must
           show 1/32/18 kernel launches each; /metrics must count no error;
           the session chunk times are read one by one. Then a second server
           with --step-mode fused --exec-cache, and an in-process engine's
           memory at one and two geometries
6. timing  step p50/p95 and peak device memory in both dtypes; each kernel's
           device time (CUDA events around a CUDA graph of its calls) beside
           its bound, its plain version, one PyTorch composite of the same
           function and its eager call; the U-Net chain and the resblock
           bank level by level beside cuDNN, in float32 (bounds at the 3xTF32
           rate their float32 paths run at, 165 TFLOP/s, with float32's 67
           TFLOP/s beside them) and in bfloat16 (bounds at the bf16 tensor
           cores' 989 TFLOP/s, cuDNN in bfloat16 beside), the bank's grid
           (blocks, blocks an SM holds, the share of conv1's rows recomputed
           as halo)

The line before the last is the card's name and power limit; before that a
JSON line describes every kernel (the chain's and the bank's bfloat16 paths
as entries of their own). The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import logging
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
#: H100 SXM, dense bfloat16 on the tensor cores, the rate the bfloat16 paths can reach
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
N_SMS = 132  # H100 SXM
SEED = 0
#: chunks streamed through the step on the card in each dtype (the first 4 are warm-up)
N_CHUNKS = 24
#: chunks of the v1 step (the first 4 are warm-up)
V1_CHUNKS = 6
#: chunks rerun stage by stage on the CPU, per dtype
CPU_CHUNKS = {"float32": 3, "bfloat16": 2}
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


def chain_flops_bytes(B, H, W, cin, C, elem=4, welem=4):
    """Operations, and bytes: activations of ``elem`` bytes, weights of
    ``welem`` (bfloat16 packs hold 2), biases float32."""
    flops, wbytes, ci = 0, 0, cin
    for _ in range(N_BLOCKS):
        flops += 2 * 9 * ci * C * H * W + 2 * 9 * C * C * H * W
        wbytes += welem * (9 * ci * C + 9 * C * C) + 4 * 2 * C
        if ci != C:
            flops += 2 * ci * C * H * W
            wbytes += welem * ci * C + 4 * C
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


def bank_flops_bytes(B, L, C, elem=4, welem=4):
    """As :func:`chain_flops_bytes`."""
    flops = B * sum(len(BANK_DILS) * 2 * 2 * k * C * C * L for k in BANK_KS)
    wbytes = sum(len(BANK_DILS) * 2 * (welem * k * C * C + 4 * C) for k in BANK_KS)
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


def phase_main(report, key, n_chunks, dtype, version="v2", cpu_chunks=0, breakdown=False, reference=None):
    """Stream ``n_chunks`` through ``RvcPipeline.step`` at full width in
    ``dtype``; returns what later phases use: the pipeline, its last state,
    the chunks, the controls, the emitted audio, the pitch codes of the
    chunks after warm-up and the CPU pipeline of the stage comparison
    (``reference`` is the float32 one, for a bfloat16 run)."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig, RvcModelVersion
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

    cfg = ChunkConfig.build()
    t0 = time.perf_counter()
    # the card, full width: ContentVec (v2, or v1 with its final projection), full RMVPE, 40 kHz synthesizer
    pipe = RvcPipeline(cfg, RvcModelVersion.from_str(version), compute_dtype=getattr(torch, dtype))
    pipe.init_params(SEED, std=None)
    if dtype == "bfloat16":
        cast_params_for_serving(pipe)
    log(key, f"{version} pipeline on {pipe.device} in {dtype}, random fan-in-scaled weights from seed {SEED} "
             f"({time.perf_counter() - t0:.1f} s); chunk {cfg.sample_frame_size} samples, "
             f"16 kHz ring {cfg.input_buffer_16k_size}, RMVPE window {cfg.rmvpe_frame_16k} "
             f"({cfg.rmvpe_n_frames} frames), T={cfg.return_length} -> {cfg.model_return_size} samples")
    log(key, f"networks in {dtype} (the log-mel, rings, pitch and SOLA in float32); TF32 off for cuDNN and "
             "matmul (set in the parity phase), which leaves bfloat16 unchanged")
    controls = StepControls.default(pitch_shift=0.0, rms_mix_rate=1.0)
    wav = torch.from_numpy(voiced_signal(n_chunks * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size].to(pipe.device)
              for i in range(n_chunks)]
    compare_at = set(range(n_chunks // 2, n_chunks // 2 + cpu_chunks))
    saved = {}
    state = pipe.new_state()
    outs, times, pitch_inputs = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i, chunk in enumerate(chunks):
        if i in compare_at:
            saved[i] = state
        t0 = time.perf_counter()
        new, out = pipe.step(state, chunk, controls)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        pitch_inputs.append((state.cache_pitchf, new.input_buffer_16k))
        state = new
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    audio = torch.cat(outs).cpu()
    log(key, f"streamed {n_chunks} chunks; kernel launches {launches}")
    check_launches(key, launches, n_chunks)
    if audio.shape != (n_chunks * cfg.sample_frame_size,) or not bool(torch.isfinite(audio).all()):
        raise AssertionError(f"{key}: output shape {tuple(audio.shape)} or non-finite values")
    tail = audio[4 * cfg.sample_frame_size :]
    log(key, f"output {tuple(audio.shape)} all finite, max |y| {float(audio.abs().max()):.4f}, "
             f"rms after warm-up {float(tail.pow(2).mean().sqrt()):.4f}")
    if float(tail.abs().max()) < 1e-3:
        raise AssertionError(f"{key}: the converted audio is silent")
    with torch.no_grad():  # after the counters were read: these reruns of the pitch stages are not the step's
        codes = torch.cat([pipe._pitch_cache_update(c, b, controls)[1].cpu() for c, b in pitch_inputs[4:]])
    steady = np.asarray(times[4:])
    report[key] = {
        "dtype": dtype, "version": version, "chunks": n_chunks, "launches": launches, "peak_mem_bytes": int(peak),
        "step_ms": times, "step_p50_ms": float(np.percentile(steady, 50)),
        "step_p95_ms": float(np.percentile(steady, 95)),
        "rtf": float(np.percentile(steady, 50)) / (1e3 * cfg.sample_frame_size / cfg.sample_rate),
    }
    log(key, f"step p50 {report[key]['step_p50_ms']:.2f} ms, p95 {report[key]['step_p95_ms']:.2f} ms over "
             f"{len(steady)} steady chunks; peak device memory {peak / 2**20:.1f} MiB")
    cpu = compare_with_cpu(report, key, pipe, saved, chunks, controls, reference) if cpu_chunks else None
    if breakdown:
        stage_breakdown(report, key, pipe, state, chunks[:12], controls)
    return dict(pipe=pipe, state=state, chunks=chunks, controls=controls, audio=audio, codes=codes, cpu=cpu)


def compare_dtypes(report, f32, bf16):
    """The bfloat16 stream against the float32 one on the card (the same
    seed's weights, rounded; the same chunks), after warm-up."""
    n = 4 * (f32["audio"].numel() // len(f32["chunks"]))
    a, b = f32["audio"][n:], bf16["audio"][n:]
    rel = float((b - a).abs().max()) / float(a.abs().max())
    agree = float((f32["codes"] == bf16["codes"]).float().mean())
    off = (f32["codes"].long() - bf16["codes"].long()).abs()
    report["bf16_vs_f32"] = {"audio_rel_max_err": rel, "codes_agree": agree, "codes_max_diff": int(off.max()),
                             "frames": int(off.numel())}
    log("main", f"bfloat16 vs float32 on the card, {len(f32['chunks']) - 4} chunks after warm-up: emitted audio "
                f"max|diff| / max|float32| {rel:.3e}; pitch codes agree on {agree:.1%} of {off.numel()} frames "
                f"(largest difference {int(off.max())} codes)")


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


#: each hand kernel's device function and its launches per step (and per engine request): the C
#: calls of LAUNCHES_PER_STEP launch 1 log-mel, 8 chain (per level) and 9 bank (per level) kernels
KERNELS_PER_STEP = {"log_mel_kernel": 1, "conv3x3_kernel": 32, "resblock_step_kernel": 18}
#: the schedule of live controls the graphs are streamed with: (first chunk, pitch shift, rms_mix_rate)
CONTROL_SCHEDULE = [(0, 0.0, 1.0), (4, 12.0, 1.0), (6, 12.0, 0.5), (8, -5.0, 0.5)]


def controls_at(i):
    from obs_rvc_tpu_torch.stream import StepControls

    _, ps, mix = [c for c in CONTROL_SCHEDULE if c[0] <= i][-1]
    return StepControls.default(pitch_shift=ps, rms_mix_rate=mix)


def stream(step, pipe, chunks, controls, timed=False):
    """Stream ``chunks`` from a zeroed state through ``step`` (the eager
    step, ``jit_step`` or ``staged_step``); ``controls`` is one StepControls
    or a function of the chunk's index. Returns the emitted audio on the
    CPU and, with ``timed``, each step's ms (host clock, synchronized)."""
    import torch

    state, outs, times = pipe.new_state(), [], []
    for i, chunk in enumerate(chunks):
        t0 = time.perf_counter()
        state, out = step(state, chunk, controls(i) if callable(controls) else controls)
        if timed:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return torch.cat(outs).cpu(), times


def kernel_counts(events):
    """Launches of each hand kernel among torch.profiler's device events."""
    return {k: sum(1 for e in events if k in e.name) for k in KERNELS_PER_STEP}


def trace_steps(step, pipe, chunks, controls):
    """torch.profiler (device activity) over ``len(chunks)`` steps: the hand
    kernels' launches, and per step the device's busy ms (the union of the
    device events' intervals), their summed durations and the wall ms with
    the tracer on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = pipe.new_state()
    state, _ = step(state, chunks[0], controls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernels after it starts: a step not counted, then a marker kernel
        state, _ = step(state, chunks[0], controls)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk in chunks:
            state, _ = step(state, chunk, controls)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if not marks:
        raise AssertionError("the trace holds no marker kernel: torch.profiler recorded no device activity")
    events = events[marks[-1] + 1 :]
    summed = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    n = len(chunks)
    return kernel_counts(events), device_busy_ms(events) / n, summed / n, wall / n


def device_busy_ms(events):
    """The time some device activity of ``events`` runs: the union of their
    intervals (in a replayed graph, kernels' intervals can overlap, so their
    sum can exceed the wall time)."""
    busy, end = 0.0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if end is None or start >= end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3


def check_same(name, got, want, tol):
    """Bit-identical, or within ``tol`` of max|want|; returns (bit-identical, relative max error)."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or values not finite")
    rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
    if rel > tol:
        raise AssertionError(f"{name}: relative max error {rel:.3e} (bound {tol})")
    return bool((got == want).all()), rel


def phase_graphs(report, key, run, reload_weights=False):
    """The graphed steps (``jit_step``, one CUDA graph of the step;
    ``staged_step``, a graph per stage) against the eager step on the same
    pipeline, chunks and controls: each stream bit-identical to the eager
    one or within the float32 bound of the emitted audio; capture times,
    step p50/p95, the graphs' memory, a trace of replays counting the hand
    kernels' launches and the device's busy share, MFU; the live controls
    changed mid-stream with no recapture; with ``reload_weights``, new
    weights after the capture reach the graphs."""
    import torch

    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.stream import graphs
    from obs_rvc_tpu_torch.utils import pipeline_gflops_per_chunk

    pipe, chunks, controls = run["pipe"], run["chunks"], run["controls"]
    dtype = str(pipe.compute_dtype).removeprefix("torch.")
    n = len(chunks)
    eager, _ = stream(pipe.step, pipe, chunks, controls)
    same, rel = check_same(f"{key} eager vs eager", eager, run["audio"], CPU_TOL["emitted"])
    out = {"eager_repeat_bit_identical": same, "eager_repeat_rel": rel}
    log(key, f"eager step run twice: {'bit-identical' if same else f'relative max difference {rel:.3e}'}")
    gflop = pipeline_gflops_per_chunk(pipe.cfg, pipe.contentvec_cfg.out_dim)
    peak, peak_name = (BF16_PEAK_FLOPS, "bf16 989") if dtype == "bfloat16" else (F32_PEAK_FLOPS, "float32 67")
    eager_p50 = report[key]["step_p50_ms"]
    out["mfu_eager"] = gflop * 1e9 / (eager_p50 * 1e-3) / peak
    counts, busy, summed, wall = trace_steps(pipe.step, pipe, chunks[:5], controls)
    out["eager_trace"] = {"kernels_in_trace": counts, "device_busy_ms_per_step": busy,
                          "device_summed_ms_per_step": summed, "traced_step_ms": wall}
    log(key, f"eager trace of 5 steps: hand kernels {counts}; device busy {busy:.2f} ms a step (kernel times "
             f"summed {summed:.2f} ms) of {wall:.2f} ms with the tracer on ({busy / wall:.1%})")
    for mode, holder, step in (("fused", pipe.jit_step, pipe.jit_step), ("staged", pipe.staged_graphs,
                                                                          pipe.staged_step)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        holder.capture()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        per_graph = ({"jit_step": holder.graph.capture_seconds} if mode == "fused"
                     else {name: g.capture_seconds for name, g in holder.graphs.items()})
        captures0 = graphs.CAPTURES
        audio, times = stream(step, pipe, chunks, controls, timed=True)
        peak_mem = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved() - reserved0
        bit, rel = check_same(f"{key} {mode} vs eager", audio, eager, CPU_TOL["emitted"])
        steady = np.asarray(times[4:])
        p50 = float(np.percentile(steady, 50))
        counts, busy, summed, wall = trace_steps(step, pipe, chunks[:5], controls)
        want = {k: v * 5 for k, v in KERNELS_PER_STEP.items()}
        # the live controls changed mid-stream: the same as eager, and nothing captured again
        sched_eager, _ = stream(pipe.step, pipe, chunks[:12], controls_at)
        sched, _ = stream(step, pipe, chunks[:12], controls_at)
        sched_bit, sched_rel = check_same(f"{key} {mode} with controls changed", sched, sched_eager,
                                          CPU_TOL["emitted"])
        recaptures = graphs.CAPTURES - captures0
        r = out[mode] = {
            "capture_s": capture_s, "capture_s_per_graph": per_graph, "bit_identical": bit, "rel_max_err": rel,
            "step_ms": times, "step_p50_ms": p50, "step_p95_ms": float(np.percentile(steady, 95)),
            "peak_mem_bytes": int(peak_mem), "graph_pool_bytes": int(pool), "kernels_in_trace": counts,
            "device_busy_ms_per_step": busy, "device_summed_ms_per_step": summed, "traced_step_ms": wall,
            "mfu": gflop * 1e9 / (p50 * 1e-3) / peak, "controls_bit_identical": sched_bit,
            "controls_rel_max_err": sched_rel, "recaptures_after_controls": recaptures}
        log(key, f"{mode} graphs ({dtype}): captured in {capture_s:.2f} s ("
                 + ", ".join(f"{k} {v:.2f}" for k, v in per_graph.items()) + " s); "
                 + (f"{n} chunks bit-identical to the eager step" if bit else
                    f"{n} chunks within {rel:.3e} of max|eager| (bound {CPU_TOL['emitted']})")
                 + f"; step p50 {p50:.2f} ms, p95 {r['step_p95_ms']:.2f} ms (eager p50 {eager_p50:.2f}); "
                 f"peak device memory {peak_mem / 2**20:.1f} MiB, the graphs hold {pool / 2**20:.1f} MiB")
        log(key, f"{mode} trace of 5 replayed steps: hand kernels {counts} (want {want}); device busy "
                 f"{busy:.2f} ms a step (kernel times summed {summed:.2f} ms) of {wall:.2f} ms with the tracer on "
                 f"({busy / wall:.1%}); MFU "
                 f"{r['mfu']:.2%} ({gflop:.1f} GFLOP a chunk at step p50, against the {peak_name} TFLOP/s peak)")
        log(key, f"{mode} with pitch 0 -> 12 -> -5 and rms_mix_rate 1 -> 0.5 mid-stream: "
                 + ("bit-identical to eager" if sched_bit else f"within {sched_rel:.3e} of eager")
                 + f"; {recaptures} captures meanwhile")
        if counts != want:
            raise AssertionError(f"{key} {mode}: the trace of 5 steps shows {counts} hand kernel launches, want {want}")
        if recaptures:
            raise AssertionError(f"{key} {mode}: {recaptures} captures after the first; controls must not recapture")
    # the host's per-call check that the graphs' weights are the module's current ones
    version = pipe.jit_step.graph._version
    t0 = time.perf_counter()
    for _ in range(100):
        version.key()
    out["weights_check_ms"] = (time.perf_counter() - t0) * 10
    log(key, f"the per-call weights check ({len(version._tensors)} parameters and buffers): "
             f"{out['weights_check_ms']:.3f} ms on the host")
    log(key, f"MFU against the {peak_name} TFLOP/s peak: eager {out['mfu_eager']:.2%}, fused "
             f"{out['fused']['mfu']:.2%}, staged {out['staged']['mfu']:.2%}")
    if reload_weights:
        before = {"fused": pipe.jit_step.captures, "staged": pipe.staged_graphs.captures}
        old = stream(pipe.step, pipe, chunks[:3], controls)[0]
        pipe.init_params(SEED + 1, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        new = stream(pipe.step, pipe, chunks[:3], controls)[0]
        moved = float((new - old).abs().max()) / float(old.abs().max())
        reload = {"eager_moved_rel": moved}
        for mode, step, holder in (("fused", pipe.jit_step, pipe.jit_step),
                                   ("staged", pipe.staged_step, pipe.staged_graphs)):
            got = stream(step, pipe, chunks[:3], controls)[0]
            bit, rel = check_same(f"{key} {mode} after a weight reload", got, new, CPU_TOL["emitted"])
            reload[mode] = {"bit_identical": bit, "rel_max_err": rel,
                            "recaptures": holder.captures - before[mode]}
        out["weight_reload"] = reload
        log(key, f"after loading new weights (seed {SEED + 1}): the eager output moved {moved:.3e} of max|audio|; "
                 + "; ".join(f"{m} " + ("bit-identical to eager" if reload[m]["bit_identical"] else
                                          f"within {reload[m]['rel_max_err']:.3e} of eager")
                             + f", {reload[m]['recaptures']} graphs captured again" for m in ("fused", "staged")))
        if moved < 1e-3 or any(reload[m]["recaptures"] == 0 for m in ("fused", "staged")):
            raise AssertionError(f"{key}: the weight reload did not reach the graphs: {reload}")
    report[key]["graphs"] = out


def stage_breakdown(report, key, pipe, state, chunks, controls):
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
    report[key]["stages_p50_ms"] = p50
    log(key, f"stage p50 over {len(chunks) - 2} chunks, each ended by a synchronize: "
                + ", ".join(f"{n} {v:.2f} ms" for n, v in p50.items()) + f"; sum {sum(p50.values()):.2f} ms")


def phase_profile(report, key, run, steps: int = 5):
    """torch.profiler over a few steps of a main run's pipeline (``run``, as
    :func:`phase_main` returns it): the device's busy share of the wall time
    and the operators that take most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe, state, chunks, controls = run["pipe"], run["state"], run["chunks"], run["controls"]

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
    report[key]["profile"] = {"step_ms": step_ms, "device_busy_ms_per_step": busy,
                              "top": [{"ms_per_step": r[0], "calls_per_step": r[1], "name": r[2]} for r in rows[:25]]}
    if not rows:
        log("profile", f"{key}: torch.profiler recorded no device time: the device breakdown is not measured")
        return
    log("profile", f"{key} ({pipe.compute_dtype}): {steps} steps, {step_ms:.2f} ms each on the host clock; "
                   f"device busy {busy:.2f} ms "
                   f"per step ({busy / step_ms:.1%}), idle {1 - busy / step_ms:.1%}")
    for ms, calls, name in rows[:25]:
        log("profile", f"  {ms:8.3f} ms/step {calls:5d} calls/step  {name[:110]}")


#: card vs CPU bounds per stage in float32, relative to max|cpu|: the card
#: reorders float32 sums (cuDNN, cuBLAS, the two kernels) through 12 + 20 + 30
#: layers; the log-mel's ln(max(|X|, 1e-5)) turns the reordering's relative
#: error in the smallest spectral magnitudes into an absolute one near
#: ln(1e-5) = -11.5
CPU_TOL = {"buf16": 1e-5, "features": 1e-4, "mel": 1e-4, "salience": 1e-4, "pitchf": 1e-5,
           "synth_audio": 1e-3, "emitted": 1e-3}
#: the least share of pitch codes the card and the CPU must agree on, per dtype
CPU_CODES_AGREE = {"float32": 1.0, "bfloat16": 0.9}


def compare_with_cpu(report, key, pipe, saved, chunks, controls, reference=None):
    """Rerun chunks stage by stage on the card and on the CPU, in the
    pipeline's dtype, each stage fed the card's inputs to it, and hold the
    two against each other. float32: each stage within ``CPU_TOL``.
    bfloat16, which rounds at other places on the card (cuDNN, the kernels)
    than on the CPU (oneDNN, the plain versions): ``reference`` is the CPU
    float32 pipeline on the same seed's weights, fed the same inputs, and
    each stage is held to an error budget as the CPU tests hold the port to
    the JAX package: ``e_card = rel(card bf16, CPU f32)`` at most ``2 e_cpu +
    CPU_TOL``, ``e_cpu = rel(CPU bf16, CPU f32)``. Returns the CPU pipeline."""
    import torch

    from obs_rvc_tpu_torch.stream import RvcPipeline

    dtype = str(pipe.compute_dtype).removeprefix("torch.")
    cpu = RvcPipeline(pipe.cfg, pipe.version, device="cpu", compute_dtype=pipe.compute_dtype)
    for name, module in pipe.modules().items():
        cpu.modules()[name].load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    worst = {k: 0.0 for k in CPU_TOL}
    slack = {k: float("inf") for k in CPU_TOL}  # bfloat16: the least room of e_card under 2 e_cpu + CPU_TOL
    same, frames = 0, 0

    def rel(a, b):
        b = b.float()
        return float((a.float().cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-12)

    t0 = time.perf_counter()
    with torch.no_grad():
        for i, state in sorted(saved.items()):
            c = lambda t: t.cpu()  # noqa: E731
            buf, buf16 = pipe.stage_pre(state, chunks[i])
            phone = pipe.stage_features(buf16)
            mel = pipe.stage_mel(buf16)
            sal = pipe.stage_salience(mel)
            cache, pitch, pitchf = pipe.stage_pitch_post(state.cache_pitchf, sal, controls)
            audio = pipe.stage_synth(phone, pitch, pitchf, controls.sid)
            emitted, _ = pipe.stage_post(buf, audio, state.sola_buffer, controls.rms_mix_rate)
            card = {"buf16": buf16, "features": phone, "mel": mel, "salience": sal, "pitchf": pitchf,
                    "synth_audio": audio, "emitted": emitted}

            def on_cpu(p):
                """Each stage of ``p`` on the card's inputs to it; and the pitch codes."""
                _, cpitch, cpitchf = p.stage_pitch_post(c(state.cache_pitchf), c(sal), controls)
                return {
                    "buf16": p.stage_pre(state.to("cpu"), c(chunks[i]))[1],
                    "features": p.stage_features(c(buf16)),
                    "mel": p.stage_mel(c(buf16)),
                    "salience": p.stage_salience(c(mel)),
                    "pitchf": cpitchf,
                    "synth_audio": p.stage_synth(c(phone), c(pitch), c(pitchf), controls.sid),
                    "emitted": p.stage_post(c(buf), c(audio), c(state.sola_buffer), controls.rms_mix_rate)[0],
                }, cpitch

            got, cpitch = on_cpu(cpu)
            errs = {k: rel(card[k], got[k]) for k in CPU_TOL}
            agree = pitch.cpu() == cpitch
            same, frames = same + int(agree.sum()), frames + agree.numel()
            line = ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            if reference is not None:
                ref, _ = on_cpu(reference)
                e_card = {k: rel(card[k], ref[k]) for k in CPU_TOL}
                e_cpu = {k: rel(got[k], ref[k]) for k in CPU_TOL}
                for k in CPU_TOL:
                    slack[k] = min(slack[k], 2 * e_cpu[k] + CPU_TOL[k] - e_card[k])
                line += "; against the CPU in float32, e_card / e_cpu: " + ", ".join(
                    f"{k} {e_card[k]:.2e} / {e_cpu[k]:.2e}" for k in CPU_TOL)
            for k, v in errs.items():
                worst[k] = max(worst[k], v)
            log(key, f"chunk {i} card vs CPU in {dtype}, relative max errors: {line}; f0 codes equal on "
                     f"{int(agree.sum())} of {agree.numel()} frames")
    report[key]["cpu_compare"] = {"relative_max_err": worst, "tolerance": CPU_TOL, "codes_equal": same,
                                  "codes_frames": frames, "seconds": time.perf_counter() - t0}
    if reference is None:
        log(key, f"stage bounds in {dtype} (relative to max|cpu|): " + ", ".join(f"{k} {v:g}" for k, v in CPU_TOL.items())
                 + f"; f0 codes equal on at least {CPU_CODES_AGREE[dtype]:.0%} of the frames "
                 f"({time.perf_counter() - t0:.1f} s)")
        bad = [k for k in CPU_TOL if worst[k] > CPU_TOL[k]]
    else:
        report[key]["cpu_compare"]["budget_slack"] = slack
        log(key, "stage budgets in bfloat16, e_card <= 2 e_cpu + the float32 bound ("
                 + ", ".join(f"{k} {v:g}" for k, v in CPU_TOL.items()) + "); least slack "
                 + ", ".join(f"{k} {v:.2e}" for k, v in slack.items())
                 + f"; f0 codes equal on at least {CPU_CODES_AGREE[dtype]:.0%} of the frames "
                 f"({time.perf_counter() - t0:.1f} s)")
        bad = [k for k in CPU_TOL if slack[k] < 0]
    if bad or same < CPU_CODES_AGREE[dtype] * frames:
        raise AssertionError(f"{key}: card and CPU disagree: {bad or 'f0 codes'} ({worst}, codes {same}/{frames})")
    return cpu


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


def session_p95(times_ms):
    """p95 as ``/metrics`` takes it (``serve/metrics.py``)."""
    ts = sorted(times_ms)
    return ts[max(0, int(len(ts) * 0.95) - 1)]


class Server:
    """The port's server (``serve.server.main``) on a thread, for a ``with``
    block; ``bound`` maps each front door to its port."""

    def __init__(self, argv):
        self.argv, self.bound, self.failed = argv, {}, []
        self.stop, self.listening = threading.Event(), threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True, name="chip-smoke-server")

    def _run(self):
        from obs_rvc_tpu_torch.serve import server

        def on_ready(b):
            self.bound.update(b)
            self.listening.set()

        try:
            server.main(self.argv, ready=on_ready, stop_event=self.stop)
        except BaseException as e:  # reported on the main thread
            self.failed.append(e)
            self.listening.set()

    def __enter__(self):
        log("serve", "python -m obs_rvc_tpu_torch.serve.server " + " ".join(self.argv))
        t0 = time.perf_counter()
        self.thread.start()
        if not self.listening.wait(600) or self.failed:
            self.__exit__()
            raise AssertionError(f"the server did not come up: {self.failed}")
        self.startup_s = time.perf_counter() - t0
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(30)
        if self.thread.is_alive() or self.failed:
            raise AssertionError(f"the server did not stop cleanly: {self.failed}")


def server_argv(host, extra=()):
    ports = {name: free_port() for name in ("duplex", "ws", "rpc", "health")}
    return ["--host", host, "--port", str(ports["duplex"]), "--ws-port", str(ports["ws"]),
            "--rpc-port", str(ports["rpc"]), "--health-port", str(ports["health"]), *extra]


def duplex_session(host, port, wav, n, chunk, sample_rate):
    from obs_rvc_tpu_torch.serve.stream_server import StreamClient

    client = StreamClient.connect_tcp(host, port, timeout=120)
    try:
        return stream_door("duplex", client.send_audio, wav, 2400, chunk, n, sample_rate)
    finally:
        client.close()


def phase_serve(report, main_pipe):
    """The port's server on a thread, driven through its front doors;
    ``main_pipe`` is the main phase's pipeline in the server's default
    dtype, on the same seed's weights. Every door replays CUDA graphs, which
    the server captured before it listened (a new RPC geometry is captured
    at its first request, and the CLI's pipeline at its first chunk)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.serve import cli
    from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics
    from obs_rvc_tpu_torch.serve.rpc import RpcClient
    from obs_rvc_tpu_torch.serve.ws import WsStreamClient
    from obs_rvc_tpu_torch.stream import RvcEngine, graphs
    from obs_rvc_tpu_torch.utils import read_wav, write_wav

    host = "127.0.0.1"
    cfg = main_pipe.cfg
    chunk = cfg.sample_frame_size
    # every session chunk's time, in the order the sessions record them (/metrics gives only p50/p95),
    # and where each session's first is: a session steps on a worker thread of its own (the set holds
    # the thread objects, since a finished thread's ident can come back)
    chunk_ms, firsts, threads, record = [], [], set(), ChunkMetrics.record

    def record_each(self, ms):
        if threading.current_thread() not in threads:
            threads.add(threading.current_thread())
            firsts.append(len(chunk_ms))
        chunk_ms.append(ms)
        record(self, ms)

    # the defaults: the card, bfloat16, staged graphs, v2 at 40 kHz, 0.3 s chunks; random weights from
    # seed 0, fan-in scaled, as the main phase's pipeline
    captures0 = graphs.CAPTURES
    ChunkMetrics.record = record_each
    try:
        with Server(server_argv(host)) as srv:
            bound = srv.bound
            captured_at_start = graphs.CAPTURES - captures0
            log("serve", f"server listening in {srv.startup_s:.1f} s with {captured_at_start} graphs captured "
                         f"(the staged step's 7, the engine's 1): {bound}")
            metrics_url = f"http://{host}:{bound['health']}/metrics"
            reset_launches()
            captures1 = graphs.CAPTURES

            # 1. the duplex stream and 2. its WebSocket form, each converting whole chunks
            door_out = {}
            for door, n in (("duplex", SERVE_CHUNKS), ("websocket", WS_CHUNKS)):
                wav = voiced_signal((n + 2) * chunk, cfg.sample_rate, seed=SEED + 2)
                t_stream = time.perf_counter()
                if door == "duplex":
                    streamed = duplex_session(host, bound["duplex"], wav, n, chunk, cfg.sample_rate)
                else:
                    client = WsStreamClient.connect(host, bound["ws"], timeout=120)
                    streamed = stream_door(door, client.send_audio, wav, 2400, chunk, n, cfg.sample_rate)
                    client.close()
                door_out[door] = streamed
                log("serve", f"{door}: {streamed.size} samples back ({streamed.size / chunk:.2f} chunks) in "
                             f"{time.perf_counter() - t_stream:.1f} s, all finite, tail max |y| "
                             f"{float(np.abs(streamed[2 * chunk :]).max()):.4f}")

            # two duplex sessions at once, each against its own run alone
            pair = [voiced_signal(8 * chunk, cfg.sample_rate, seed=SEED + 20 + i) for i in range(2)]
            alone = [duplex_session(host, bound["duplex"], w, 6, chunk, cfg.sample_rate) for w in pair]
            together = [None, None]

            def concurrent(i):
                together[i] = duplex_session(host, bound["duplex"], pair[i], 6, chunk, cfg.sample_rate)

            workers = [threading.Thread(target=concurrent, args=(i,)) for i in range(2)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(180)
            if any(w.is_alive() for w in workers) or any(t is None for t in together):
                raise AssertionError("the two concurrent duplex sessions did not finish")
            pair_rel = []
            for a, b in zip(alone, together):
                m = min(a.size, b.size)
                pair_rel.append(check_same("concurrent vs sequential session", torch.from_numpy(b[:m]),
                                           torch.from_numpy(a[:m]), CPU_TOL["emitted"]))
            log("serve", "two concurrent duplex sessions against each one's sequential run: "
                         + ", ".join("bit-identical" if bit else f"relative max difference {rel:.3e}"
                                     for bit, rel in pair_rel))

            # 3. the reference RPC door at the launch geometry and at the 0.5 s chunk's (captured at its first)
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
            log("serve", "rpc: replies " + ", ".join(f"{y.size}" for y in replies) + " samples, all finite; "
                         "round trips " + ", ".join(f"{v:.1f}" for v in rtt) + " ms (the fourth: the first at "
                         "the 0.5 s geometry, its graph captured then)")

            # 4. the offline CLI on a WAV file (its own float32 pipeline, through jit_step)
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
                         f"{time.perf_counter() - t1:.1f} s (pipeline set-up and capture included)")

            metrics = wait_metrics_settled(metrics_url)
            launches = read_launches()
            captured = graphs.CAPTURES - captures1
            served = metrics["chunks"] + len(requests) + cli_chunks
            log("serve", f"/metrics {metrics}")
            # replays call no wrapper: only the graphs captured meanwhile (the new RPC geometry's and the
            # CLI's, each a whole step) called them, in their warm-up calls and their capture
            log("serve", f"wrapper calls {launches} for {metrics['chunks']} session chunks + {len(requests)} RPC "
                         f"requests + {cli_chunks} CLI chunks, {captured} graphs captured meanwhile")
            check_launches("serve", launches, (graphs.WARMUP_CALLS + 1) * captured)
            if captured != 2:
                raise AssertionError(f"serve: {captured} graphs captured while serving, want 2 (a new RPC geometry, "
                                     "the CLI)")
            if metrics["chunks"] < SERVE_CHUNKS or metrics["errors"] != 0:
                raise AssertionError(f"/metrics counts {metrics['chunks']} chunks and {metrics['errors']} errors")

            # replays launch the hand kernels: a device trace of 3 RPC requests and a duplex session
            chunks_before = metrics["chunks"]
            captures2 = graphs.CAPTURES
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # the tracer can miss the first kernels after it starts: a request not counted, then a marker
                rpc.infer(*requests[0][1])
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                for at_launch, req in requests[:3]:
                    rpc.infer(*req)
                duplex_session(host, bound["duplex"], pair[0], 4, chunk, cfg.sample_rate)
                traced_chunks = wait_metrics_settled(metrics_url)["chunks"] - chunks_before
                torch.cuda.synchronize()
            rpc.close()
            events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
            if not marks:
                raise AssertionError(f"serve: the trace holds no marker kernel among {len(events)} device events")
            counts = kernel_counts(events[marks[-1] + 1 :])
            want = {k: v * (3 + traced_chunks) for k, v in KERNELS_PER_STEP.items()}
            log("serve", f"device trace of 3 RPC requests and a {traced_chunks}-chunk duplex session, all replays: "
                         f"hand kernels {counts} (want {want}) among {len(events) - marks[-1] - 1} device events")
            if counts != want or graphs.CAPTURES != captures2:
                raise AssertionError(f"serve: the traced replays launched {counts}, want {want}; "
                                     f"{graphs.CAPTURES - captures2} captures")

        # the fused step shared through the exec cache: a second server
        with Server(server_argv(host, ["--step-mode", "fused", "--exec-cache"])) as srv2:
            wav = voiced_signal((WS_CHUNKS + 2) * chunk, cfg.sample_rate, seed=SEED + 2)
            fused = duplex_session(host, srv2.bound["duplex"], wav, WS_CHUNKS, chunk, cfg.sample_rate)
            m = min(fused.size, door_out["websocket"].size)
            fused_vs_staged = check_same("fused server vs staged server", torch.from_numpy(fused[:m]),
                                         torch.from_numpy(door_out["websocket"][:m]), CPU_TOL["emitted"])
            rpc2 = RpcClient.connect_tcp(host, srv2.bound["rpc"], timeout=300)
            fused_rtt = []
            for _, req in requests:
                t1 = time.perf_counter()
                y = rpc2.infer(*req)
                fused_rtt.append((time.perf_counter() - t1) * 1e3)
                if y.shape != (req[4] * 400,) or not np.isfinite(y).all():
                    raise AssertionError("--exec-cache RPC reply of the wrong shape or not finite")
            rpc2.close()
            with urllib.request.urlopen(f"http://{host}:{srv2.bound['health']}/metrics", timeout=30) as r:
                metrics2 = json.loads(r.read())
            log("serve", f"--step-mode fused --exec-cache: listening in {srv2.startup_s:.1f} s; duplex "
                         f"{fused.size} samples back, all finite, "
                         + ("bit-identical to" if fused_vs_staged[0] else f"within {fused_vs_staged[1]:.3e} of")
                         + " the staged server's WebSocket session on the same signal; RPC round trips "
                         + ", ".join(f"{v:.1f}" for v in fused_rtt) + f" ms; /metrics {metrics2}")
            if metrics2["errors"] != 0 or not np.isfinite(fused).all():
                raise AssertionError(f"--step-mode fused --exec-cache: /metrics counts {metrics2['errors']} errors")
    finally:
        ChunkMetrics.record = record

    # the launch-geometry replies against an in-process engine on the same
    # weights, inputs and f0 history (the server's engine saw them first)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    engine = RvcEngine(main_pipe)
    rel = []
    for (at_launch, req), y in zip(requests, replies):
        if at_launch:
            want = engine.infer(*req)
            rel.append(float(np.abs(y - want).max()) / max(float(np.abs(want).max()), 1e-12))
    engine_mem = []  # (peak allocated, what the graphs hold) with one geometry, then two
    for geometries, req in ((1, requests[0][1]), (2, requests[3][1])):
        engine.infer(*req)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        engine_mem.append((torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved() - reserved0))
    log("serve", "in-process engine: " + "; ".join(
        f"{g} geometr{'y' if g == 1 else 'ies'} captured: peak device memory {a / 2**20:.1f} MiB, the graphs hold "
        f"{h / 2**20:.1f} MiB" for g, (a, h) in zip((1, 2), engine_mem)))
    # the first request at a geometry no pipeline of this process has run: where its time goes
    cfg3 = ChunkConfig.build(sample_length=0.40)
    x3 = voiced_signal(cfg3.input_buffer_16k_size, 16000, seed=SEED + 30)
    t1 = time.perf_counter()
    engine.infer(x3, cfg3.sample_frame_16k_size, 0, cfg3.skip_head, cfg3.return_length)
    first_ms = (time.perf_counter() - t1) * 1e3
    graph3 = next(p for k, p in engine._pipelines.items() if k[0] == cfg3.input_buffer_16k_size).jit_infer
    new_geometry = {"first_request_ms": first_ms, "warmup_ms": graph3.warmup_seconds * 1e3,
                    "capture_ms": graph3.capture_seconds * 1e3}
    log("serve", f"in-process engine, first request at a new geometry (0.4 s chunks): {first_ms:.1f} ms, of which the "
                 f"eager warm-up call {new_geometry['warmup_ms']:.1f} ms and the recording and instantiation "
                 f"{new_geometry['capture_ms'] - new_geometry['warmup_ms']:.1f} ms")
    dtype = str(main_pipe.compute_dtype).removeprefix("torch.")
    log("serve", f"rpc vs in-process engine in {dtype}, max|diff| / max|audio|: " + ", ".join(f"{r:.2e}" for r in rel)
                 + " (bound 1e-3: the card's sums are not bitwise repeatable)")
    if max(rel) > 1e-3:
        raise AssertionError(f"RPC replies disagree with the in-process engine: {rel}")
    rtt_launch = [v for (at_launch, _), v in zip(requests, rtt) if at_launch]
    warm = [v for i, v in enumerate(chunk_ms) if i not in firsts]
    report["serve"] = {
        "ports": bound, "metrics": metrics, "launches": launches, "served_steps": served,
        "graphs_captured_at_start": captured_at_start, "graphs_captured_serving": captured,
        "kernels_in_trace": counts, "rpc_round_trip_ms": rtt, "rpc_round_trip_p50_ms": float(np.percentile(rtt_launch, 50)),
        "rpc_first_at_new_geometry_ms": rtt[3], "rpc_vs_engine_rel": rel, "session_chunk_p50_ms": metrics["p50_ms"],
        "dtype": dtype, "session_chunk_ms": chunk_ms, "session_firsts": firsts,
        "session_first_chunk_ms": [chunk_ms[i] for i in firsts],
        "session_chunk_p95_ms": session_p95(chunk_ms), "session_chunk_p50_warm_ms": float(np.percentile(warm, 50)),
        "session_chunk_p95_after_two_ms": session_p95(chunk_ms[2:]),
        "session_chunk_p95_warm_ms": session_p95(warm),
        "concurrent_vs_sequential": [{"bit_identical": b, "rel": r} for b, r in pair_rel],
        "engine_memory_bytes": engine_mem, "engine_new_geometry": new_geometry,
        "fused_exec_cache": {"metrics": metrics2, "rpc_round_trip_ms": fused_rtt, "startup_s": srv2.startup_s,
                             "vs_staged": {"bit_identical": fused_vs_staged[0], "rel": fused_vs_staged[1]}},
    }
    log("serve", f"RPC round trip p50 {report['serve']['rpc_round_trip_p50_ms']:.2f} ms at the launch geometry, "
                 f"{rtt[3]:.1f} ms for the first at a new geometry; session chunk p50 {metrics['p50_ms']:.2f} ms, "
                 f"p95 {metrics['p95_ms']:.2f} ms (/metrics)")
    srv = report["serve"]
    log("serve", f"session chunks one by one ({len(chunk_ms)}): p95 {srv['session_chunk_p95_ms']:.2f} ms over all, "
                 f"{srv['session_chunk_p95_after_two_ms']:.2f} ms after the first two, "
                 f"p50 {srv['session_chunk_p50_warm_ms']:.2f} and p95 {srv['session_chunk_p95_warm_ms']:.2f} ms "
                 "without each session's first; each session's first "
                 + ", ".join(f"{chunk_ms[i]:.1f}" for i in firsts) + " ms, the largest "
                 + ", ".join(f"{v:.1f}" for v in sorted(chunk_ms)[-3:]) + " ms")


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

    def cast(ts, dt):
        return tuple(None if t is None else t.to(dt) for t in ts)

    # float32: the 3xTF32 rate the float32 paths reach (float32's 67 TFLOP/s beside it); bfloat16: the
    # bf16 tensor cores' rate, activations and packed weights of 2 bytes, cuDNN in bfloat16 beside
    rates = {torch.float32: ("", TF32X3_PEAK_FLOPS, "3xTF32's 165", 4),
             torch.bfloat16: (" bfloat16", BF16_PEAK_FLOPS, "bf16's 989", 2)}
    chain_cases = [(shape, *chain_inputs(*shape, dev, rng)) for shape in CHAIN_SHAPES]
    for dt, (suffix, peak, rate, elem) in rates.items():
        name = "conv_block_res_chain" + suffix
        for (label, B, H, W, cin, C), x32, blocks32 in chain_cases:
            x, blocks = x32.to(dt), [cast(b, dt) for b in blocks32]
            packed = unet_block.pack_chain(blocks, dt)  # as _Chain caches it per weight version
            flops, nbytes = chain_flops_bytes(B, H, W, cin, C, elem, elem)
            measure(name, label, lambda: unet_block.conv_block_res_chain(x, packed),
                    lambda: unet_block.conv_block_res_chain_plain(x, blocks), chain_library(x, blocks),
                    flops, nbytes, peak=peak)
            rows[name][label]["bound_ms_f32_cuda_cores"] = bound_ms(flops, nbytes)[0]
            if trace and dt == torch.float32:
                calls = kernel_trace(lambda: unet_block.conv_block_res_chain(x, packed), 2 * N_BLOCKS)
                last = calls[-1]
                rows[name][label]["trace_us"] = last
                log("profile", f"chain {label}: {len(last)} kernels per call, span "
                               f"{last[-1][2] + last[-1][1]:.1f} us (last of {len(calls)} calls); each kernel "
                               + ", ".join(f"{d:.1f} us at +{t:.1f}" for _, d, t in last))
        chain_rows = rows[name]
        for label, r in chain_rows.items():
            log("timing", f"chain level {label}{suffix}: kernel {r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
                          f"({r['ms'] / r['library_ms']:.2f}x cuDNN's time), eager one-call wrapper "
                          f"{r['eager_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms at {rate} TFLOP/s, "
                          f"{r['bound_ms_f32_cuda_cores']:.4f} ms at float32's 67 TFLOP/s")
        log("timing", f"chain{suffix} per step (4 levels): kernel "
                      f"{sum(r['ms'] for r in chain_rows.values()):.4f} ms, eager "
                      f"{sum(r['eager_ms'] for r in chain_rows.values()):.4f} ms, cuDNN "
                      f"{sum(r['library_ms'] for r in chain_rows.values()):.4f} ms, bound "
                      f"{sum(r['bound_ms'] for r in chain_rows.values()):.4f} ms ({rate} TFLOP/s) / "
                      f"{sum(r['bound_ms_f32_cuda_cores'] for r in chain_rows.values()):.4f} ms (float32 CUDA cores)")
    bank_cases = [(shape, *bank_inputs(*shape, dev, rng)) for shape in BANK_SHAPES + BANK_EXTRA_SHAPES]
    for dt, (suffix, peak, rate, elem) in rates.items():
        name = "resblock_bank" + suffix
        for (label, B, L, C), x32, params32 in bank_cases:
            x, params = x32.to(dt), [cast(p, dt) for p in params32]
            packed = resblock.pack_bank(params, BANK_KS, BANK_DILS, dt)  # as GeneratorNSF caches it
            flops, nbytes = bank_flops_bytes(B, L, C, elem, elem)
            measure(name, label, lambda: resblock.resblock_bank(x, packed, BANK_KS, BANK_DILS),
                    lambda: resblock.resblock_bank_plain(x, params, BANK_KS, BANK_DILS),
                    bank_library(x, params), flops, nbytes, peak=peak)
            r = rows[name][label]
            r["bound_ms_f32_cuda_cores"] = bound_ms(flops, nbytes)[0]
            r["grid"] = bank_grid(B, L, C, dt)
            for k, gr in r["grid"].items():
                log("timing", f"bank {label}{suffix} k={k}: {gr['blocks']} blocks of {gr['threads']} threads, "
                              f"{gr['tile']} positions each, {gr['smem_bytes']} B shared memory at "
                              f"d={max(BANK_DILS)}, {gr['registers']} registers; {gr['blocks_per_sm']} blocks an "
                              f"SM, {gr['waves']:.2f} waves over {N_SMS} SMs; conv1 {gr['conv1_rows']} rows a "
                              f"block, {gr['recomputed']:.1%} of the conv rows recomputed as halo or past L")
            if trace and dt == torch.float32:
                n = len(BANK_KS) * len(BANK_DILS)
                calls = kernel_trace(lambda: resblock.resblock_bank(x, packed, BANK_KS, BANK_DILS), n)
                last = calls[-1]
                r["trace_us"] = last
                log("profile", f"bank {label}: {len(last)} kernels per call, span "
                               f"{last[-1][2] + last[-1][1]:.1f} us (last of {len(calls)} calls); each kernel "
                               "(k, d) " + ", ".join(f"({k},{d}) {dur:.1f} us at +{t:.1f}" for (k, d), (_, dur, t)
                                                     in zip([(k, d) for k in BANK_KS for d in BANK_DILS], last)))
        bank_rows = rows[name]
        for label, r in bank_rows.items():
            log("timing", f"bank level {label}{suffix}: kernel {r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
                          f"({r['ms'] / r['library_ms']:.2f}x cuDNN's time), eager one-call wrapper "
                          f"{r['eager_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms at {rate} TFLOP/s, "
                          f"{r['bound_ms_f32_cuda_cores']:.4f} ms at float32's 67 TFLOP/s")
        main_banks = [bank_rows[sh[0]] for sh in BANK_SHAPES]
        log("timing", f"bank{suffix} per step ({len(main_banks)} levels): kernel "
                      f"{sum(r['ms'] for r in main_banks):.4f} ms, eager {sum(r['eager_ms'] for r in main_banks):.4f} "
                      f"ms, cuDNN {sum(r['library_ms'] for r in main_banks):.4f} ms, bound "
                      f"{sum(r['bound_ms'] for r in main_banks):.4f} ms ({rate} TFLOP/s) / "
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
    """One entry per kernel and dtype on the main path: float32 for all
    three (the float32 main run's launches), bfloat16 for the chain and the
    bank (the bfloat16 run's; the log-mel stays float32 there)."""
    srcs = {"log_mel": ("obs_rvc_tpu_torch/csrc/stft_mel.cu", "obs_rvc_tpu/ops/stft_mel.py:70"),
            "conv_block_res_chain": ("obs_rvc_tpu_torch/csrc/unet_block.cu", "obs_rvc_tpu/ops/unet_block.py:155"),
            "resblock_bank": ("obs_rvc_tpu_torch/csrc/resblock.cu", "obs_rvc_tpu/ops/resblock.py:298")}
    entries = [(name, "float32", "main") for name in srcs] + [
        (name, "bfloat16", "main_bf16") for name in ("conv_block_res_chain", "resblock_bank")]
    main_labels = {s[0] for s in CHAIN_SHAPES + BANK_SHAPES} | {MEL_MAIN}
    kernels = []
    for name, dtype, run in entries:
        src, replaces = srcs[name]
        row_key = name if dtype == "float32" else f"{name} {dtype}"
        rows = [r for label, r in report["timing"][row_key].items() if label in main_labels]
        errs = [v for k, v in report["parity"][name].items() if k.endswith(dtype)]
        kernels.append({
            "name": row_key, "route": "cuda", "source": src, "replaces": replaces,
            "launches": report[run]["launches"][name],
            "max_abs_err": max(errs),
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

    # each graph's capture, as the port logs it (name, ms, the warm-up call's ms)
    logging.basicConfig(stream=sys.stdout, format="[graphs] %(message)s")
    logging.getLogger("obs_rvc_tpu_torch.stream.graphs").setLevel(logging.INFO)
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
    f32 = phase_main(report, "main", N_CHUNKS, "float32", cpu_chunks=CPU_CHUNKS["float32"], breakdown=True)
    if args.profile:
        phase_profile(report, "main", f32)
    phase_graphs(report, "main", f32)
    del f32["pipe"], f32["state"]  # the bfloat16 run's peak memory is its own (its graphs go with it)
    torch.cuda.empty_cache()
    bf16 = phase_main(report, "main_bf16", N_CHUNKS, "bfloat16", cpu_chunks=CPU_CHUNKS["bfloat16"],
                      breakdown=True, reference=f32["cpu"])
    compare_dtypes(report, f32, bf16)
    if args.profile:
        phase_profile(report, "main_bf16", bf16)
    phase_graphs(report, "main_bf16", bf16)
    v1 = phase_main(report, "v1", V1_CHUNKS, "bfloat16", version="v1")
    phase_graphs(report, "v1", v1, reload_weights=True)
    del v1
    torch.cuda.empty_cache()
    phase_serve(report, bf16["pipe"])
    phase_timing(report, trace=args.profile)
    for key in ("main", "main_bf16", "v1"):
        m = report[key]
        g = m["graphs"]
        log("timing", f"{key} ({m['version']}, {m['dtype']}): step p50 / p95 over {m['chunks'] - 4} steady chunks: "
                      f"eager {m['step_p50_ms']:.2f} / {m['step_p95_ms']:.2f} ms, fused graph "
                      f"{g['fused']['step_p50_ms']:.2f} / {g['fused']['step_p95_ms']:.2f} ms, staged graphs "
                      f"{g['staged']['step_p50_ms']:.2f} / {g['staged']['step_p95_ms']:.2f} ms; real-time factor "
                      f"{m['rtf']:.4f} eager, {m['rtf'] * g['fused']['step_p50_ms'] / m['step_p50_ms']:.4f} fused; peak device memory "
                      f"{m['peak_mem_bytes'] / 2**20:.1f} MiB eager, {g['fused']['peak_mem_bytes'] / 2**20:.1f} fused, "
                      f"{g['staged']['peak_mem_bytes'] / 2**20:.1f} staged")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(kernel_line(report)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
