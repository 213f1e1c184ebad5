#!/usr/bin/env python3
"""Drive the PyTorch port's streaming step on one CUDA card and check it.

    python3 chip_smoke.py            # every phase; needs one card (with more, the mesh phase runs across them)
    python3 chip_smoke.py --profile  # also torch.profiler traces: a few steps, one call of each chain level and bank
    python3 chip_smoke.py --only mesh,stage_repeat  # the build and these phases alone, no kernel line
    python3 chip_smoke.py --only bench  # scripts/torch_bench.py's three runs alone

Phases, each printing its own lines:

1. device  the card's name and power limit, CUDA, nvcc and Triton versions
2. build   compile the kernels under obs_rvc_tpu_torch/csrc with nvcc, one
           process per source, all at once
3. parity  each CUDA kernel against its plain PyTorch version on the card,
           at the main path's shapes (float32 and bfloat16 for the U-Net
           chain and the resblock bank; float32 for the log-mel frontend,
           also at a ragged and an offline length and on silence, on RMVPE's
           HTK basis and on FCPE's Slaney basis with fmin 0), TF32 off; and
           at the batched step's: the chain and the bank at 8 and 64
           streams, the log-mel on a stream axis (8 and 64 windows in one
           launch, a ragged length, silence), each row bit-identical to its
           own launch; and at widths past the main path's, in both dtypes:
           the chain 1->8, 8->8, 16->8 (its C=8 instance) and 12->24 (padded
           to 32), the bank at C=8 (its C=8 instance) and C=48 (padded to
           64), k=5 over d=(1, 2) and d=11 at k=11; and the chain's ring
           kernel at the six levels past C=32 (enc2 32->64, dec2 128->64,
           enc3 64->128, dec1 256->128, enc4 128->256, dec0 512->256) at 1,
           8 and 64 streams, and 24->48 and 96->96 (padded widths)
   widths  the step at the CPU tests' reduced widths (RMVPE levels of 8, 16
           and 32 channels, generator levels of 64, 32, 16 and 8) in float32
           and bfloat16: 8 chunks eagerly, the wrappers launched 1 / 6 / 4
           times a step, jit_step against the eager step, two chunks' stages
           against the CPU's (float32 by the main phase's bounds, bfloat16 by
           its budget)
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
           log-mel, 32 chain and 6 bank kernel launches a step, and the
           device's busy share; MFU (utils/flops.py over step p50, against
           989 TFLOP/s in bfloat16 and 67 in float32); the controls changed
           mid-stream (pitch 0 -> 12 -> -5, rms_mix_rate 1 -> 0.5) with no
           capture; on v1, new weights after the capture reach both graphs.
           Between the bfloat16 run and v1 ("stage_repeat"), a child process
           with cuDNN's API log on captures the bfloat16 stage graphs 4 times
           (each forced by loading the weights again), each stream within
           the float32 bound of the eager one (how many bit for bit is
           reported), every leaf module's output of an eager step on the
           graphs' capture thread against the main thread's, and the cuDNN
           log's engine lines compared capture by capture
5. bench   scripts/torch_bench.py (the port's counterpart of bench.py) in
           three child processes at PyTorch's TF32 defaults, RMVPE in
           bfloat16 at full width: one stream through jit_step with
           --profile (the trace must show 1 log-mel, 32 chain and 6 bank
           kernels a step), one stream through staged_step, and 8 streams
           through jit_step_batch; each JSON line must hold every key, finite
           numbers, the seven stages' device times and a p50 under 300 ms,
           and is logged beside the main phase's bfloat16 jit_step
   switch  RvcPipeline(pallas_resblocks=False) (the chain and bank levels on
           cuDNN) beside the kernel step on the same weights and 12 chunks,
           full width: one stream in float32 and bfloat16, eager and
           jit_step, and 8 streams through jit_step_batch in bfloat16; the
           wrappers launched 1 / 0 / 0 times a step, the eager step
           repeating bit for bit, the audio within 1e-3 of the kernel step's
           in float32 and in bfloat16 within twice the kernel step's error
           off the float32 one plus 1e-3; step p50/p95 and each stage's
           device time with and without the kernels. Beside them, on the same
           weights and chunks, RMVPEConfig(pallas_unet_max_ch=256) (every
           encoder and decoder level on the chain, the six past C=32 on its
           ring kernel) in both dtypes and 64 in bfloat16: at 256 the
           wrappers launched 1 / 10 / 2 times
           a step and the chain's 32 resident and 48 ring kernels counted in
           a trace, the eager step repeating bit for bit, jit_step against
           it, the audio against the default step's (float32 1e-3, bfloat16
           by the same rule), two of the main phase's chunks' float32 stages
           against the CPU's (its bounds; and, reported, both steps'
           salience against the CPU's at two switch chunks, where the default
           step's own error reaches the bound), 8 and 64 streams through
           jit_step_batch in bfloat16 (64 timed beside the default's; enc4
           and dec0 there on the ring's batch kernel); the salience stage's
           device ms and jit_step's p50 at
           max_ch 32, 64 and 256; then serve.cli --no-pallas-resblocks
           converts a WAV file
6. serve   the port's server (serve.server.main, at its defaults: bfloat16,
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
           show 1/32/6 kernel launches each; /metrics must count no error;
           the session chunk times are read one by one. Then a second server
           with --step-mode fused --exec-cache, and an in-process engine's
           memory at one and two geometries
7. pitch   the same for the CREPE (capacity "full") and FCPE (hidden 512, 6
           layers) pitch algorithms in place of RMVPE, at the same geometry
           and widths, in float32 and in bfloat16, 10 chunks each: launches
           (CREPE 0 log-mel, 0 chain, 2 bank calls a step; FCPE 1, 0, 2), the
           stages on the card against the CPU (bfloat16 by the budget, the
           pitch codes by its rule), eager, jit_step and staged_step against
           each other, a trace of 5 replayed steps (CREPE 0/0/6 kernels,
           FCPE 1/0/6), step p50/p95, busy share, MFU (CREPE and FCPE GFLOP
           counted here), capture times and memory; then a server with
           --pitch-algorithm fcpe at its defaults serves a duplex session
           (a device trace of a second one, /metrics with no error) and
           serve.cli --pitch-algorithm crepe converts a WAV file
8. pool    the batched step and StreamPool at the same geometry and width
           in bfloat16 with RMVPE: the eager batched step of 8 streams (the
           wrappers launched 1/4/2 times a step, as for one stream);
           jit_step_batch of 8 voices with their own controls against 8
           one-stream jit_step runs (float32 within 1e-3 of max|audio|;
           bfloat16 streams finite, not silent, each nearer its own float32
           one-stream step than any other's, and each one's error beside
           the bfloat16 one-stream step's); a float32 StreamPool of 8 with
           two slots starved against the same one-stream steps (1e-3); the
           batched graph at 1, 8 and 64 streams: p50/p95, ms a stream,
           audio-seconds a second, capture, peak and graph memory, a trace
           of 5 replays (1/32/6 hand kernels a step at every size, the busy
           share, the largest kernels), pos_conv alone at its shape and an
           eager step traced with each kernel's operator; a
           batched step with CREPE and with FCPE at 4 streams; a bfloat16
           StreamPool of 8, fused and staged, on the float32 and int16 wires
           and with pipelined ticks, two slots starved for 3 ticks, each
           slot within 1e-5 of its row of the bfloat16 batched step (tick
           p50/p95, last_tick_phases); then a server with --pool 8
           at its defaults: 4 duplex and 2 WebSocket sessions at once, each
           against its run alone, a ninth connection closed, /metrics with
           the pool's occupancy and no error
9. retrieval  a 1M x 768 table (v2 features; clustered, Student-t noise) from
           the seed: exact search over float32 and bfloat16 rows and IVF (k-means
           on the card at the default nlist, lists balanced to 64 rows), each
           blend on the card against the port's CPU blend on the same table and
           queries (1e-4, TF32 off), IVF's recall@8 against exact on correlated
           chunks (at least 0.9), each blend alone timed by CUDA events at 1 and
           8 streams beside its bound; the full-width step with the exact
           float32 table at index_rate 0.75 in both dtypes: eager against
           jit_step and staged_step (bfloat16 bit for bit, float32 within
           the float32 bound), the wrappers launched
           1/4/2 times a step, step p50 with and without the index, peak memory
           at 1 and 8 streams; jit_step_batch of 8 streams at 8 index rates
           against their one-stream steps (1e-3) and a StreamPool of 8 against
           it (1e-5); a server with --index <file>.index --index-mode ivf
           serves a duplex session with no error and serve.cli converts a WAV
           file with --index <file>.onnx (both on the table's first 65536 rows)
10. mesh   obs_rvc_tpu_torch/parallel at full width with RMVPE, TF32 off,
           every mesh the one card named more than once (each row's
           features as per-device graph segments, the path a row that spans
           cards takes): a data=2 x model=2
           StreamPool of 8, fused and staged, in float32 and bfloat16, two
           slots starved, against the one-device pool on the same chunks
           (float32 within 1e-3 of max|audio|; bfloat16 each stream nearer
           its own than any other, its error printed); the eager mesh step's
           wrapper launches (2 x 1/4/2 a tick); each row's segmented
           jit_step_batch against the eager row step over 3 chunks
           (bfloat16 bit-identical, float32 within 1e-3); a trace of 5 pool ticks
           (2 x 1/32/6 hand kernels a tick), tick p50/p95 and peak memory
           beside the one-device pool's; ContentVec split at model=2 against
           the unsharded network (2e-4); the exact blend over the retrieval
           phase's table split at model=2 against the unsharded blend (1e-4),
           both timed at 1 and 8 streams; dryrun_multichip(8) over the card
           named 8 times; a server with --pool 8 --mesh data=1,model=1 serves
           a duplex session with no error, --mesh data=<cards + 1> exits
           naming the device count; two processes of tests/torch_distributed_worker.py
           (gloo, full width, float32) against one process, and NCCL at
           world size 1 in a process of its own. Where two or more cards
           are visible, also: the three kernels on the second card while the
           first is current, against their plain versions; data=1 x model=2
           and data=2 x model=2 pools whose rows span cards, fused and
           staged, in both dtypes, against the one-device pool (tick
           p50/p95, each card's peak memory, each card's busy time and the
           peer copies' in a trace of 5 fused ticks); ContentVec and the
           exact blend split over two cards by CUDA events beside the
           unsharded ones; a server with --pool 8 --mesh data=N/2,model=2
           serving a duplex session; two processes over NCCL, one card
           each, against one process. A line says how many cards it saw
           and which cross-card parts ran
11. timing step p50/p95 and peak device memory in both dtypes; each kernel's
           device time (CUDA events around a CUDA graph of its calls) beside
           its bound, its plain version, one PyTorch composite of the same
           function and its eager call; the U-Net chain and the resblock
           bank level by level beside cuDNN, in float32 (bounds at the 3xTF32
           rate their float32 paths run at, 165 TFLOP/s, with float32's 67
           TFLOP/s beside them) and in bfloat16 (bounds at the bf16 tensor
           cores' 989 TFLOP/s, cuDNN in bfloat16 beside); the log-mel also
           on FCPE's basis; the chain, the bank and the log-mel also at the
           batched step's 8 streams, the chain and the bank at 64 streams
           too; each chain and bank level's launch shape (the wrapper's
           tile, on the ring kernel its streams a tile and wgmma or
           mma.sync, the blocks and their waves over the SMs, shared memory,
           registers, blocks an SM; the bank's ring, split last step and
           the share of its conv rows computed past the tiles), and the
           chain's four levels and the bank's two summed at 1, 8 and 64
           streams; the chain's ring kernel at its six levels (1, 8, 64
           streams) and two padded widths, beside its bound and cuDNN's
           composite, the six summed

The line before the last is the card's name and power limit; before that a
JSON line describes every kernel (the chain's and the bank's bfloat16 paths,
the log-mel on FCPE's basis, the three at the batched step's 8 streams, the
chain and the bank at each width past the main path's, and the chain's ring
kernels at each of its six levels and padded widths in both dtypes and at 8
and 64 streams, as entries of their own). The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import platform
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# the card's peaks and timing helpers, and the networks' GFLOP a chunk, shared with scripts/torch_bench.py
from obs_rvc_tpu_torch.utils.benchlib import (BF16_PEAK_FLOPS, F32_PEAK_FLOPS, HBM_BYTES_PER_S, N_SMS,
                                              TF32X3_PEAK_FLOPS, cuda_ms, device_busy_ms, events_after_mark,
                                              graph_ms, kernel_counts, mark_trace, nvidia_smi_line)
from obs_rvc_tpu_torch.utils.flops import chunk_gflops

SEED = 0
#: chunks streamed through the step on the card in each dtype (the first 4 are warm-up; at least the 12 of the
#: stage breakdown and the controls' schedule, and few enough that the whole run stays within 700 s)
N_CHUNKS = 16
#: chunks of the v1 step (the first 4 are warm-up)
V1_CHUNKS = 6
#: chunks rerun stage by stage on the CPU, per dtype
CPU_CHUNKS = {"float32": 3, "bfloat16": 2}
#: chunks the serve phase streams through the duplex door, at least
SERVE_CHUNKS = 12
#: chunks it streams through the WebSocket door, at least
WS_CHUNKS = 4
#: the pitch phase: chunks streamed per algorithm and dtype (the first 4 are warm-up), and rerun stage by
#: stage on the CPU
PITCH_CHUNKS = 10
PITCH_CPU_CHUNKS = {"float32": 2, "bfloat16": 1}
#: chunks the FCPE server's duplex session streams, at least
PITCH_SERVE_CHUNKS = 6
OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
# the same kernel on FCPE's basis (Slaney scale, fmin 0: its first triangle starts at bin 0), at the
# FCPE step's window (T=64), one frame short of it, and on silence
FCPE_MEL_SHAPES = [("fcpe-slaney", 10080, "voiced"), ("fcpe-slaney-T63", 9920, "voiced"),
                   ("fcpe-slaney-silence", 10080, "silence")]
FCPE_MEL_MAIN = "fcpe-slaney"
MEL_BOUND = (2e-4, 1e-4)  # the JAX package's own bound for its Pallas kernel
#: streams of the pool phase's batched step and its pool's capacity; the batched step launches each kernel
#: once for all of them, at these shapes
POOL_B = 8
CHAIN_SHAPES_BATCH = [(f"{label}-b{POOL_B}", POOL_B, H, W, cin, C) for label, _, H, W, cin, C in CHAIN_SHAPES]
#: the chain at the pool phase's largest batch, 64 streams (gated and timed; its launches are the same C calls)
CHAIN_B64 = 64
CHAIN_SHAPES_B64 = [(f"{label}-b{CHAIN_B64}", CHAIN_B64, H, W, cin, C) for label, _, H, W, cin, C in CHAIN_SHAPES]
#: the chain kernel against its plain version (abs, rel): float32 and bfloat16, the CUDA tests' BOUNDS["chain"]
CHAIN_BOUNDS = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 2e-2)}
BANK_SHAPES_BATCH = [(f"{label}-b{POOL_B}", POOL_B, L, C) for label, _, L, C in BANK_SHAPES]
#: the bank at the pool phase's largest batch, 64 streams (gated and timed; its launches are the same C calls)
BANK_B64 = 64
BANK_SHAPES_B64 = [(f"{label}-b{BANK_B64}", BANK_B64, L, C) for label, _, L, C in BANK_SHAPES]
#: the timing phase's CUDA graphs at 64 streams: 2 calls replayed 3 times (each call takes milliseconds)
LARGE_DEPTH = (2, 3)
#: the bank kernel against its plain version (abs, rel): the JAX package's own bounds, the CUDA tests' BOUNDS["bank"]
BANK_BOUNDS = {"float32": (1e-4, 1e-3), "bfloat16": (3e-2, 2e-2)}
# (label, B, L, signal): the log-mel on a stream axis, one launch for B windows ("mixed": voiced, normal and
# silent rows in turn); B=64 is the pool phase's largest batch
MEL_BATCH_SHAPES = [(f"batch-main-b{POOL_B}", POOL_B, 10080, "mixed"), ("batch-main-b64", 64, 10080, "mixed"),
                    ("batch-T63-b3", 3, 9920, "mixed"), (f"batch-silence-b{POOL_B}", POOL_B, 10080, "silence")]
MEL_BATCH_MAIN = f"batch-main-b{POOL_B}"
#: (label, B, H, W, Cin, C): the chain at widths past the main path's, each held to its plain version and
#: timed as the main path's levels are: a reduced-width RMVPE's C=8 levels (the kernel's C=8 instance) at
#: the main path's first level's 64 x 128 (the encoder's 1 -> 8, an identity block's 8 -> 8, the decoder's
#: 2C concat 16 -> 8), and 12 -> 24 (C padded to the kernel's 32)
CHAIN_WIDTH_SHAPES = [("c8-enc", 1, 64, 128, 1, 8), ("c8-id", 1, 64, 128, 8, 8), ("c8-dec", 1, 64, 128, 16, 8),
                      ("c24-pad", 1, 32, 64, 12, 24)]
#: (label, B, H, W, Cin, C): the six levels of the full RMVPE past C=32 (its decoder's 2C concat beside each
#: encoder level), which RvcPipeline(rmvpe_cfg=RMVPEConfig(pallas_unet_max_ch=256)) sends to the chain's ring
#: kernel, at one stream, the batched step's 8 and 64; then two padded widths: C=48 on 64 and an identity
#: first block on 96 (three groups of 32, no 64-channel tile)
CHAIN_WIDE_LEVELS = [("enc2", 16, 32, 32, 64), ("dec2", 16, 32, 128, 64), ("enc3", 8, 16, 64, 128),
                     ("dec1", 8, 16, 256, 128), ("enc4", 4, 8, 128, 256), ("dec0", 4, 8, 512, 256)]
CHAIN_WIDE_SHAPES = [(label, 1, H, W, cin, C) for label, H, W, cin, C in CHAIN_WIDE_LEVELS]
CHAIN_WIDE_SHAPES_BATCH = [(f"{label}-b{POOL_B}", POOL_B, H, W, cin, C) for label, H, W, cin, C in CHAIN_WIDE_LEVELS]
CHAIN_WIDE_SHAPES_B64 = [(f"{label}-b{CHAIN_B64}", CHAIN_B64, H, W, cin, C) for label, H, W, cin, C in CHAIN_WIDE_LEVELS]
CHAIN_WIDE_PAD_SHAPES = [("c48-pad", 1, 16, 32, 24, 48), ("c96-id", 1, 8, 16, 96, 96)]
CHAIN_WIDE_ALL = CHAIN_WIDE_SHAPES + CHAIN_WIDE_SHAPES_BATCH + CHAIN_WIDE_SHAPES_B64 + CHAIN_WIDE_PAD_SHAPES
#: (label, B, L, C, kernel sizes, dilations): the bank likewise: a reduced-width generator's C=8 level (T=35
#: at 128 initial channels: L=14000; the kernel's C=8 instance), C=48 (padded to 64) at the C=64 level's
#: length, k=5 over d=(1, 2), and d=11 at k=11 (conv1's halo of 110 rows)
BANK_WIDTH_SHAPES = [("c8", 1, 14000, 8, BANK_KS, BANK_DILS), ("c48-pad", 1, 7000, 48, BANK_KS, BANK_DILS),
                     ("c32-k5", 1, 14000, 32, (5,), (1, 2)), ("c32-k11-d11", 1, 14000, 32, (11,), (11,))]


def bank_shape(shape):
    """A bank shape as ``(label, B, L, C, kernel sizes, dilations)``: the main path's ``(label, B, L, C)``
    at its (3, 7, 11) / (1, 3, 5)."""
    return tuple(shape) if len(shape) == 6 else (*shape, BANK_KS, BANK_DILS)


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


def chain_library(x, blocks):
    """One PyTorch composite of the chain, timed beside the kernel: cuDNN's
    best (NCHW channels_last convs, autotuned), its convs unfused."""
    import torch
    import torch.nn.functional as F

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


def bank_inputs(label, B, L, C, device, rng, ks=BANK_KS, dils=BANK_DILS):
    import torch

    params, S = [], len(dils)
    for k in ks:
        s = 1.0 / np.sqrt(k * C)
        params.append(tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            rng.standard_normal((S, k, C, C)) * s, rng.standard_normal((S, C)) * 0.05,
            rng.standard_normal((S, k, C, C)) * s, rng.standard_normal((S, C)) * 0.05)))
    x = torch.from_numpy((rng.standard_normal((B, L, C)) * 0.5).astype(np.float32)).to(device)
    return x, params


def bank_library(x, params, ks=BANK_KS, dils=BANK_DILS):
    """One PyTorch composite of the bank, timed beside the kernel: cuDNN's
    best (autotuned conv1d calls on [B, C, L]), its convs unfused."""
    import torch.nn.functional as F

    xt = x.transpose(1, 2).contiguous()
    ws = [tuple((w[s].permute(2, 1, 0).contiguous(), b[s]) for s in range(len(dils))
                for w, b in ((w1, b1), (w2, b2))) for w1, b1, w2, b2 in params]

    def run():
        total = None
        for k, convs in zip(ks, ws):
            a = xt
            for s, d in enumerate(dils):
                (w1, b1), (w2, b2) = convs[2 * s], convs[2 * s + 1]
                t = F.leaky_relu(F.conv1d(F.leaky_relu(a, 0.1), w1, b1, padding=d * (k - 1) // 2, dilation=d), 0.1)
                a = a + F.conv1d(t, w2, b2, padding=(k - 1) // 2)
            total = a if total is None else total + a
        return total / len(ks)
    return run


def bank_flops_bytes(B, L, C, elem=4, welem=4, ks=BANK_KS, dils=BANK_DILS):
    """As :func:`chain_flops_bytes`; at the level's own C (a padded width's
    zero channels are no work the function needs)."""
    flops = B * sum(len(dils) * 2 * 2 * k * C * C * L for k in ks)
    wbytes = sum(len(dils) * 2 * (welem * k * C * C + 4 * C) for k in ks)
    return flops, 2 * B * L * C * elem + wbytes


def chain_launch(B, H, W, cin, C, dtype):
    """The chain kernel's launch at one level: the wrapper's tiling (on the
    ring kernel its streams a tile and its instruction path, ``wgmma`` or
    ``mma.sync``), the card's occupancy at it, and the waves of its blocks
    (a tile each) over the blocks the card holds at once."""
    import torch

    from obs_rvc_tpu_torch.ops import unet_block

    tl = unet_block.chain_tiling(B, H, W, cin, C, dtype,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
    info = unet_block.launch_info(cin, C, dtype, tl)
    blocks = tl.tiles * max(tl.splits)  # the ring kernel's split launches: a block a tile and slice of K
    return dict(tl._asdict(), **info, blocks=blocks, waves=blocks / (N_SMS * max(1, info["blocks_per_sm"])))


def bank_grid(B, L, C, dtype, ks=BANK_KS, dils=BANK_DILS):
    """The bank kernel's launches at one level: the wrapper's tiling, the
    card's occupancy at it (at the largest dilation, whose halo takes the
    most shared memory), the waves of the launches before the last (a block
    a bank and tile) and of the last (a block a tile, every bank) over the
    blocks the card holds at once, and the share of the conv rows computed
    past the blocks' tiles (conv2's halo, and past L)."""
    import torch

    from obs_rvc_tpu_torch.ops import resblock

    tl = resblock.bank_tiling(B, L, C, dtype, torch.cuda.get_device_properties(0).multi_processor_count, ks, dils)
    info = resblock.launch_info(C, dtype, tl, ks, dils)
    return dict(tl._asdict(), **info, waves=tl.blocks / (N_SMS * max(1, info["blocks_per_sm"])),
                waves_last=tl.blocks / len(ks) / (N_SMS * max(1, info["blocks_per_sm_last"])),
                recomputed=1.0 - B * L * len(ks) / (tl.blocks * tl.rows), width=resblock.kernel_width(C))


def mel_inputs(L, kind, device, rng, B=None):
    """One window ``[L]``, or ``B`` of them ``[B, L]`` (``"mixed"``: voiced,
    normal and silent rows in turn)."""
    import torch

    def row(kind, b=0):
        return {"voiced": voiced_signal(L, 16000, seed=SEED + b), "normal": rng.standard_normal(L).astype(np.float32),
                "silence": np.zeros(L, np.float32)}[kind]

    if B is None:
        return torch.from_numpy(row(kind)).to(device)
    kinds = ["voiced", "normal", "silence"] if kind == "mixed" else [kind]
    return torch.from_numpy(np.stack([row(kinds[b % len(kinds)], b) for b in range(B)])).to(device)


def mel_flops_bytes(L, basis, packed, n_fft=1024, hop=160, B=1):
    """What the function needs per frame: the window product, one real FFT
    of 1024 points (2.5 N log2 N, the usual count for a real transform), the
    513 bins' magnitudes, the mel product over the basis's nonzero entries
    (the triangles) and the 128 logs; bytes: the signal, the window, the
    basis as the kernel reads it (``packed``: the weights of each row's run
    and the rows' int32 starts, offsets and pieces) and the output, each
    once; for ``B`` streams, B windows and outputs, the window and basis
    once."""
    T = 1 + L // hop
    n_bins = n_fft // 2 + 1
    nnz = int((basis != 0).sum())
    n_mels = basis.shape[0]
    per_frame = n_fft + 2.5 * n_fft * np.log2(n_fft) + 4 * n_bins + 2 * nnz + n_mels
    basis_bytes = sum(t.numel() * t.element_size() for t in packed[:4])
    return B * T * per_frame, 4 * (B * (L + n_mels * T) + n_fft) + basis_bytes


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
    bounds = {"chain": {dt: CHAIN_BOUNDS[str(dt)[6:]] for dt in (torch.float32, torch.bfloat16)},
              "bank": {dt: BANK_BOUNDS[str(dt)[6:]] for dt in (torch.float32, torch.bfloat16)}}
    out = {"conv_block_res_chain": {}, "resblock_bank": {}, "log_mel": {}}
    # RMVPE's basis (HTK, fmin 30) and FCPE's (Slaney, fmin 0), each with its window and packed basis
    htk, slaney = MelSpectrogram(device=dev), MelSpectrogram(f_min=0.0, htk=False, device=dev)
    for label, L, kind, mel in [(*m, htk) for m in MEL_SHAPES] + [(*m, slaney) for m in FCPE_MEL_SHAPES]:
        win, basis = mel.window, mel.mel_basis
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
    # the stream axis: one launch for B windows, each row the one-window launch's result bit for bit
    for label, B, L, kind in MEL_BATCH_SHAPES:
        x = mel_inputs(L, kind, dev, rng, B=B)
        before = stft_mel.LAUNCHES
        got = stft_mel.log_mel(x, htk.log_mel_basis, htk.window)
        if stft_mel.LAUNCHES != before + 1:
            raise AssertionError(f"log_mel {label}: {stft_mel.LAUNCHES - before} launches for one batched call")
        want = stft_mel.log_mel_plain(x, htk.mel_basis, htk.window)
        rows_equal = all(torch.equal(got[b], stft_mel.log_mel(x[b], htk.log_mel_basis, htk.window)) for b in range(B))
        torch.cuda.synchronize()
        err = check_close(f"log_mel {label}", got, want, *MEL_BOUND)
        if not rows_equal:
            raise AssertionError(f"log_mel {label}: a row differs from the kernel's one-window result")
        if kind == "silence":
            check_close("log_mel silence = ln(1e-5)", got, torch.full_like(got, float(np.log(1e-5))), 1e-5, 0.0)
        out["log_mel"][f"{label} float32"] = err
        log("parity", f"log_mel {label} [{B}, {L}] -> {list(got.shape)} {kind} float32, one launch: max abs err "
                      f"{err:.3e} (bound {MEL_BOUND[0]}/{MEL_BOUND[1]}); every row bit-identical to its own launch")
    for label, B, H, W, cin, C in CHAIN_SHAPES + CHAIN_SHAPES_BATCH + CHAIN_SHAPES_B64 + CHAIN_WIDTH_SHAPES \
            + CHAIN_WIDE_ALL:
        x, blocks = chain_inputs(label, B, H, W, cin, C, dev, rng)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            packed = unet_block.pack_chain(blocks, dt)
            got = unet_block.conv_block_res_chain(xd, packed)
            want = unet_block.conv_block_res_chain_plain(xd, blocks)
            torch.cuda.synchronize()
            atol, rtol = bounds["chain"][dt]
            err = check_close(f"chain {label} {dt}", got, want, atol, rtol)
            out["conv_block_res_chain"][f"{label} {str(dt)[6:]}"] = err
            log("parity", f"conv_block_res_chain {label} [{B},{H},{W},{cin}]->{C} on the "
                          f"{'ring' if packed.ring else 'resident'} kernel's C={packed.width} {str(dt)[6:]}: "
                          f"max abs err {err:.3e} (bound {atol}/{rtol}), |ref| max {float(want.float().abs().max()):.3g}")
    for label, B, L, C, ks, dils in map(bank_shape, BANK_SHAPES + BANK_EXTRA_SHAPES + BANK_SHAPES_BATCH
                                         + BANK_SHAPES_B64 + BANK_WIDTH_SHAPES):
        x, params = bank_inputs(label, B, L, C, dev, rng, ks, dils)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            packed = resblock.pack_bank(params, ks, dils, dt)
            got = resblock.resblock_bank(xd, packed, ks, dils)
            want = resblock.resblock_bank_plain(xd, params, ks, dils)
            torch.cuda.synchronize()
            atol, rtol = bounds["bank"][dt]
            err = check_close(f"bank {label} {dt}", got, want, atol, rtol)
            out["resblock_bank"][f"{label} {str(dt)[6:]}"] = err
            log("parity", f"resblock_bank {label} [{B},{L},{C}] k={ks} d={dils} on the kernel's C={packed.width} "
                          f"{str(dt)[6:]}: max abs err {err:.3e} (bound {atol}/{rtol}), "
                          f"|ref| max {float(want.float().abs().max()):.3g}")
    report["parity"] = out


# CREPE's first two blocks on their kernel (ops/crepe_conv.py): (label, capacity, block, frames). 64 frames are
# one stream's pitch window; 128 two streams'; 300 an offline clip's share, where conv2 splits K no more (S = 1)
CREPE_CONV_SHAPES = [("conv1-full-64", "full", 1, 64), ("conv2-full-64", "full", 2, 64),
                     ("conv1-full-128", "full", 1, 128), ("conv2-full-128", "full", 2, 128),
                     ("conv1-full-300", "full", 1, 300), ("conv2-full-300", "full", 2, 300),
                     ("conv1-tiny-64", "tiny", 1, 64)]
#: the kernel's error off the float32 block of the same bf16 operands, against cuDNN bf16's: e <= 2 e_cudnn + tol
CREPE_CONV_TOL = 1e-3


def crepe_conv_model(capacity, dev):
    """CREPE at ``capacity`` in bfloat16 on ``dev`` (eval): fan-in-scaled
    random weights from :data:`SEED`, then each block's conv bias and norm
    (weight of either sign, bias, running mean and variance) drawn too, so
    the epilogue's every term counts."""
    import torch

    from obs_rvc_tpu_torch.models.crepe import Crepe, CrepeConfig
    from obs_rvc_tpu_torch.models.weights import load_state_dict
    from obs_rvc_tpu_torch.stream.pipeline import _random_state_dict

    model = Crepe(CrepeConfig(capacity))
    rng = np.random.default_rng(SEED)
    load_state_dict(model, _random_state_dict(model, rng, None))
    with torch.no_grad():
        for i in range(1, 7):
            conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
            C = conv.out_channels
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32) * 0.1))
            bn.weight.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32) * 0.1))
            bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32) * 0.1))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32)))
    return model.to(dev, torch.bfloat16).eval()


def crepe_conv_case(model, block, N, dev):
    """Block ``block`` (1 or 2) of ``model`` at ``N`` frames of the voiced
    signal: its input (conv2's: conv1's plain block, blocked), the kernel's
    call, its plain version and cuDNN's bfloat16 form (the module's own
    code: conv, ReLU, BatchNorm, pool), and the float32 block of the same
    bfloat16 operands."""
    import torch
    import torch.nn.functional as F

    from obs_rvc_tpu_torch.models.crepe import _PADS, extract_crepe_frames
    from obs_rvc_tpu_torch.ops import crepe_conv

    sig = torch.from_numpy(voiced_signal(160 * (N - 1) + 1, 16000)).to(dev)
    frames = extract_crepe_frames(sig[None], N)[0].to(torch.bfloat16).contiguous()
    conv1, bn1 = model.conv1, model.conv1_BN
    f1 = crepe_conv.fold(conv1, bn1)
    if block == 1:
        x, x_ncl, kind = frames, frames[:, None], "frames"
    else:
        x = crepe_conv.block_frames_plain(frames, f1)
        x_ncl, kind = crepe_conv.from_blocked(x).contiguous(), "taps"
    conv, bn = getattr(model, f"conv{block}"), getattr(model, f"conv{block}_BN")
    folded = crepe_conv.fold(conv, bn)
    packed = crepe_conv.pack(folded, kind)
    kernel = crepe_conv.block_frames if block == 1 else crepe_conv.block_taps
    plain = crepe_conv.block_frames_plain if block == 1 else crepe_conv.block_taps_plain
    stride = conv.stride[0]

    def cudnn():
        y = conv(F.pad(x_ncl, _PADS[block - 1])[..., None])[..., 0]
        return F.max_pool1d(bn(F.relu(y)), 2, 2)

    with torch.no_grad():
        y = F.conv1d(F.pad(x_ncl.float(), _PADS[block - 1]), folded.w, stride=stride)
        ref = F.max_pool1d(torch.relu(y + folded.bias[:, None]) * folded.scale[:, None] + folded.shift[:, None], 2, 2)
    as_ncl = (lambda t: crepe_conv.from_blocked(t)) if block == 1 else (lambda t: t)
    return {"x": x, "kind": kind, "packed": packed, "kernel": lambda: kernel(x, packed),
            "plain": lambda: plain(x, folded), "cudnn": cudnn, "ref": ref, "as_ncl": as_ncl,
            "flops": 2 * N * y.shape[-1] * conv.in_channels * conv.out_channels * conv.kernel_size[0],
            "bytes": 2 * (x.numel() + conv.weight.numel() + ref.numel())}


def phase_crepe_conv(report, timing=True):
    """CREPE's conv kernel (``ops/crepe_conv.py``) on the card at
    :data:`CREPE_CONV_SHAPES`: against the float32 block of the same
    bfloat16 operands by the rule ``e <= 2 e_cudnn + tol`` (cuDNN's
    bfloat16 block, the module's code, as ``e_cudnn``), against its plain
    version (bfloat16 steps), bit for bit across two launches and inside a
    CUDA graph's replays, one launch counted a call; with ``timing``, its
    device time beside its bound, the plain version's, cuDNN's
    (deterministic, as the port runs it) and, for conv2, cuDNN's in eight
    convolutions of 128 channels summed in float32 (``split8``, as
    ``scripts/torch_crepe_probe.py`` times it)."""
    import torch
    import torch.nn.functional as F

    from obs_rvc_tpu_torch.ops import crepe_conv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    models, out = {}, {}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, capacity, block, N in CREPE_CONV_SHAPES:
        model = models.setdefault(capacity, crepe_conv_model(capacity, dev))
        case = crepe_conv_case(model, block, N, dev)
        with torch.no_grad():
            before = crepe_conv.LAUNCHES
            got = case["kernel"]()
            again = case["kernel"]()
            if crepe_conv.LAUNCHES != before + 2:
                raise AssertionError(f"crepe_conv {label}: {crepe_conv.LAUNCHES - before} launches for 2 calls")
            plain = case["plain"]()
            cudnn = case["cudnn"]()
            torch.cuda.synchronize()
        got_ncl, plain_ncl, ref = case["as_ncl"](got).float(), case["as_ncl"](plain).float(), case["ref"]
        if not bool(torch.isfinite(got_ncl).all()):
            raise AssertionError(f"crepe_conv {label}: non-finite outputs")
        scale = float(ref.abs().max())
        e_k = float((got_ncl - ref).abs().max()) / scale
        e_c = float((cudnn.float() - ref).abs().max()) / scale
        # the kernel against its plain version, in bf16 steps at each output's magnitude (floored at 2^-8 of the
        # largest): the two sum in other orders, so a value may round the other way
        mag = plain_ncl.abs().clamp_min(scale * 2**-8)
        steps = float(((got_ncl - plain_ncl).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())
        differ = float((got_ncl != plain_ncl).float().mean())
        row = {"e_kernel": e_k, "e_cudnn_bf16": e_c, "bf16_steps_off_plain": steps, "share_off_plain": differ,
               "repeat_bit_identical": bool(torch.equal(got, again)), "ref_max": scale}
        if e_k > 2 * e_c + CREPE_CONV_TOL or steps > 2 or not row["repeat_bit_identical"]:
            raise AssertionError(f"crepe_conv {label}: {row}")
        if case["kind"] == "taps":
            row["splits"] = crepe_conv.taps_splits(N, case["packed"].cin, n_sms)
        # inside a CUDA graph: its replays equal the eager launch bit for bit
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            case["kernel"]()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), torch.no_grad():
            graphed = case["kernel"]()
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(graphed.clone())
        row["graph_bit_identical"] = all(torch.equal(r, got) for r in replays)
        if not row["graph_bit_identical"]:
            raise AssertionError(f"crepe_conv {label}: a CUDA graph's replay differs from the eager launch")
        del graph, graphed
        if timing:
            with torch.no_grad():
                row["kernel_ms"] = graph_ms(case["kernel"])
                row["plain_ms"] = graph_ms(case["plain"])
                row["cudnn_ms"] = graph_ms(case["cudnn"])
                if block == 2:
                    conv, x4 = model.conv2, F.pad(crepe_conv.from_blocked(case["x"]), (31, 32))[..., None]

                    def split8(x4=x4, c=conv):
                        parts = [F.conv2d(x4[:, g : g + 128], c.weight[:, g : g + 128]).float()
                                 for g in range(0, c.in_channels, 128)]
                        return (torch.stack(parts).sum(0) + c.bias.float()[:, None, None]).to(x4.dtype)

                    row["cudnn_split8_ms"] = graph_ms(split8)
            row["gflop"] = case["flops"] / 1e9
            row["mb"] = case["bytes"] / 1e6
            row["bound_ms"], row["bound_by"] = bound_ms(case["flops"], case["bytes"], BF16_PEAK_FLOPS)
            row["tflops"] = case["flops"] / row["kernel_ms"] / 1e9
        out[label] = row
        log("crepe_conv", f"{label} [{N} frames]: e {e_k:.3e} vs cuDNN bf16 {e_c:.3e} (rule 2e + {CREPE_CONV_TOL}); "
                          f"off the plain version by {steps:.2f} bf16 steps at most, {differ:.2%} of outputs; two "
                          "launches and a graph's replays bit-identical"
                          + (f"; splits {row['splits']}" if "splits" in row else "")
                          + (f"; kernel {row['kernel_ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, bound "
                             f"{row['bound_ms']:.4f} by {row['bound_by']}), plain {row['plain_ms']:.4f}, cuDNN "
                             f"{row['cudnn_ms']:.4f}" + (f", cuDNN split8 {row['cudnn_split8_ms']:.4f}"
                                                        if "cudnn_split8_ms" in row else "") if timing else ""))
    torch.backends.cudnn.deterministic = deterministic
    report["crepe_conv"] = out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def voiced_signal(n, sr, seed=SEED, f0=180.0):
    """A harmonic tone at ``f0`` (180 Hz) with 5 Hz vibrato and a little noise."""
    t = np.arange(n) / sr
    f = f0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def phase_main(report, key, n_chunks, dtype, version="v2", cpu_chunks=0, breakdown=False, reference=None,
               pitch="rmvpe", nets=None, per_step=None):
    """Stream ``n_chunks`` through ``RvcPipeline.step`` at full width in
    ``dtype`` with the ``pitch`` algorithm's network; returns what later
    phases use: the pipeline, its last state, the chunks, the controls, the
    emitted audio, the pitch codes of the chunks after warm-up and the CPU
    pipeline of the stage comparison (``reference`` is the float32 one, for a
    bfloat16 run). ``nets``: the networks' configs (``contentvec_cfg``,
    ``rmvpe_cfg``, ``synth_cfg``) in place of the full widths, whose step
    launches the wrappers ``per_step`` times (default
    :data:`LAUNCHES_PER_STEP`)."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig, RvcModelVersion
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

    cfg = ChunkConfig.build()
    t0 = time.perf_counter()
    # the card, full width: ContentVec (v2, or v1 with its final projection), the pitch network (full
    # RMVPE, CREPE "full" or FCPE at hidden 512, 6 layers), the 40 kHz synthesizer
    pipe = RvcPipeline(cfg, RvcModelVersion.from_str(version), compute_dtype=getattr(torch, dtype),
                       pitch_algorithm=pitch, **(nets or {}))
    pipe.init_params(SEED, std=None)
    if dtype == "bfloat16":
        cast_params_for_serving(pipe)
    if nets:
        log(key, f"reduced widths: {pipe.contentvec_cfg}, {pipe.synth_cfg}")
    log(key, f"{version} pipeline with {getattr(pipe, f'{pitch}_cfg')} on {pipe.device} in {dtype}, random "
             f"fan-in-scaled weights from seed {SEED} "
             f"({time.perf_counter() - t0:.1f} s); chunk {cfg.sample_frame_size} samples, "
             f"16 kHz ring {cfg.input_buffer_16k_size}, pitch window {cfg.rmvpe_frame_16k} "
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
    check_launches(key, launches, n_chunks, pitch, per_step, dtype)
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
        "dtype": dtype, "version": version, "pitch_algorithm": pitch, "chunks": n_chunks, "launches": launches,
        "peak_mem_bytes": int(peak),
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


def compare_dtypes(report, f32, bf16, key="bf16_vs_f32"):
    """The bfloat16 stream against the float32 one on the card (the same
    seed's weights, rounded; the same chunks), after warm-up."""
    n = 4 * (f32["audio"].numel() // len(f32["chunks"]))
    a, b = f32["audio"][n:], bf16["audio"][n:]
    rel = float((b - a).abs().max()) / float(a.abs().max())
    agree = float((f32["codes"] == bf16["codes"]).float().mean())
    off = (f32["codes"].long() - bf16["codes"].long()).abs()
    report[key] = {"audio_rel_max_err": rel, "codes_agree": agree, "codes_max_diff": int(off.max()),
                             "frames": int(off.numel())}
    log(key, f"bfloat16 vs float32 on the card, {len(f32['chunks']) - 4} chunks after warm-up: emitted audio "
                f"max|diff| / max|float32| {rel:.3e}; pitch codes agree on {agree:.1%} of {off.numel()} frames "
                f"(largest difference {int(off.max())} codes)")


#: launches of each kernel's wrapper per step (and per engine request), by pitch algorithm: CREPE
#: and FCPE replace RMVPE's U-Net chain; FCPE's Slaney log-mel runs the log-mel kernel, CREPE's frames do not.
#: CREPE's conv kernel runs in bfloat16 only (CREPE_BF16_LAUNCHES)
LAUNCHES_PER_STEP = {"rmvpe": {"log_mel": 1, "conv_block_res_chain": 4, "resblock_bank": 2, "crepe_conv": 0},
                     "crepe": {"log_mel": 0, "conv_block_res_chain": 0, "resblock_bank": 2, "crepe_conv": 0},
                     "fcpe": {"log_mel": 1, "conv_block_res_chain": 0, "resblock_bank": 2, "crepe_conv": 0}}
#: CREPE in bfloat16: its conv1 and conv2 blocks on the conv kernel, a wrapper call each a step
CREPE_BF16_LAUNCHES = {"crepe_conv": 2}


def launches_per_step(pitch="rmvpe", dtype="float32"):
    """:data:`LAUNCHES_PER_STEP` of ``pitch`` in ``dtype``."""
    return dict(LAUNCHES_PER_STEP[pitch], **(CREPE_BF16_LAUNCHES if (pitch, dtype) == ("crepe", "bfloat16") else {}))


def _counter_modules():
    from obs_rvc_tpu_torch.ops import crepe_conv, resblock, stft_mel, unet_block

    return {"log_mel": stft_mel, "conv_block_res_chain": unet_block, "resblock_bank": resblock,
            "crepe_conv": crepe_conv}


def reset_launches():
    for mod in _counter_modules().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in _counter_modules().items()}


def check_launches(phase, launches, steps, pitch="rmvpe", per_step=None, dtype="float32"):
    """``launches`` against ``per_step`` (default :func:`launches_per_step`) times ``steps``; a wrapper
    ``per_step`` does not name launches 0 times."""
    per = dict.fromkeys(_counter_modules(), 0) | (per_step or launches_per_step(pitch, dtype))
    want = {k: v * steps for k, v in per.items()}
    if launches != want:
        raise AssertionError(f"{phase}: expected {want} launches for {steps} steps, got {launches}")


#: each hand kernel's device function and its launches per step (and per engine request), by pitch
#: algorithm: the C calls of LAUNCHES_PER_STEP launch 1 log-mel, 8 chain (per level) and 3 bank (per level, one a
#: dilation) kernels, and the bank's sum kernel where its tiling splits a level's last step; CREPE in bfloat16
#: 2 conv kernels and the sum of conv2's split parts where it splits K (kernels_per_step)
KERNELS_PER_STEP = {"rmvpe": {"log_mel_kernel": 1, "conv3x3_kernel": 32, "resblock_bank_kernel": 6,
                              "crepe_conv_kernel": 0},
                    "crepe": {"log_mel_kernel": 0, "conv3x3_kernel": 0, "resblock_bank_kernel": 6,
                              "crepe_conv_kernel": 0},
                    "fcpe": {"log_mel_kernel": 1, "conv3x3_kernel": 0, "resblock_bank_kernel": 6,
                             "crepe_conv_kernel": 0}}


def kernels_per_step(pitch="rmvpe", B=1, dtype="bfloat16"):
    """:data:`KERNELS_PER_STEP` at ``B`` streams a step in ``dtype``: with
    one bank sum kernel for each of the generator's bank levels
    (``BANK_SHAPES``) whose last step ``bank_tiling`` splits at that batch
    (one stream's levels, on this card); for CREPE in bfloat16 its two conv
    kernels, and the sum of conv2's parts where ``taps_splits`` splits its
    K at the step's frames."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.ops import crepe_conv, resblock

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    sums = sum(resblock.bank_tiling(B, L, C, torch.bfloat16, n_sms).split for _, _, L, C in BANK_SHAPES)
    out = dict(KERNELS_PER_STEP[pitch], resblock_bank_sum_kernel=sums, crepe_conv_reduce_kernel=0)
    if (pitch, dtype) == ("crepe", "bfloat16"):
        frames = B * ChunkConfig.build().rmvpe_n_frames
        out.update(crepe_conv_kernel=2, crepe_conv_reduce_kernel=int(crepe_conv.taps_splits(frames, 1024, n_sms) > 1))
    return out
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


def trace_steps(step, pipe, chunks, controls, state=None):
    """torch.profiler (device activity) over ``len(chunks)`` steps from
    ``state`` (a new one by default): the hand kernels' launches, per step
    the device's busy ms (the union of the device events' intervals), their
    summed durations and the wall ms with the tracer on, and the events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = state if state is not None else pipe.new_state()
    state, _ = step(state, chunks[0], controls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernels after it starts: a step not counted, then a marker kernel
        state, _ = step(state, chunks[0], controls)
        mark_trace()
        t0 = time.perf_counter()
        for chunk in chunks:
            state, _ = step(state, chunk, controls)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = events_after_mark(prof)
    summed = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    n = len(chunks)
    return kernel_counts(events), device_busy_ms(events) / n, summed / n, wall / n, events


def trace_replays(key, step, pipe, chunks, controls, want, make_state=None):
    """:func:`trace_steps` of a replayed graph, whose hand-kernel counts the
    caller holds to ``want``. A graph launches the same kernels at every
    replay, so a trace that shows fewer lost device records (one such trace
    in the runs of PR 9: 80 bank kernels of 90, the same graph 90 in every
    other): it is taken once more, both logged. Returns trace_steps' tuple
    and whether it traced again."""
    traced = trace_steps(step, pipe, chunks, controls, state=make_state and make_state())
    counts = traced[0]
    short = counts != want and all(counts[k] <= v for k, v in want.items())
    if short:
        log(key, f"the trace shows {counts} hand kernels, fewer than the replayed graph launches ({want}): "
                 "the tracer lost device records; traced again")
        traced = trace_steps(step, pipe, chunks, controls, state=make_state and make_state())
    return traced, short


def check_same(name, got, want, tol, chunk=None):
    """Bit-identical, or within ``tol`` of max|want|; returns (bit-identical, relative max error).
    With ``chunk`` (the samples of a chunk of a stream's audio), a failure names the first chunk that differs."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or values not finite")
    rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
    if rel > tol:
        where = ""
        if chunk:
            off = (got != want).reshape(-1, chunk).any(dim=1).nonzero().flatten().tolist()
            where = f"; chunks that differ: {off} of {got.numel() // chunk}"
        raise AssertionError(f"{name}: relative max error {rel:.3e} (bound {tol}){where}")
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
    from obs_rvc_tpu_torch.serve.metrics import process_counter

    pipe, chunks, controls = run["pipe"], run["chunks"], run["controls"]
    dtype = str(pipe.compute_dtype).removeprefix("torch.")
    n = len(chunks)
    eager, _ = stream(pipe.step, pipe, chunks, controls)
    same, rel = check_same(f"{key} eager vs eager", eager, run["audio"], CPU_TOL["emitted"],
                           chunk=pipe.cfg.sample_frame_size)
    out = {"eager_repeat_bit_identical": same, "eager_repeat_rel": rel}
    log(key, f"eager step run twice: {'bit-identical' if same else f'relative max difference {rel:.3e}'}")
    gflop = chunk_gflops(pipe)
    peak, peak_name = (BF16_PEAK_FLOPS, "bf16 989") if dtype == "bfloat16" else (F32_PEAK_FLOPS, "float32 67")
    eager_p50 = report[key]["step_p50_ms"]
    out["mfu_eager"] = gflop * 1e9 / (eager_p50 * 1e-3) / peak
    counts, busy, summed, wall, _ = trace_steps(pipe.step, pipe, chunks[:5], controls)
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
        captures0 = process_counter("captures")
        audio, times = stream(step, pipe, chunks, controls, timed=True)
        peak_mem = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved() - reserved0
        bit, rel = check_same(f"{key} {mode} vs eager", audio, eager, CPU_TOL["emitted"],
                              chunk=pipe.cfg.sample_frame_size)
        steady = np.asarray(times[4:])
        p50 = float(np.percentile(steady, 50))
        want = {k: v * 5 for k, v in kernels_per_step(pipe.pitch_algorithm, dtype=dtype).items()}
        (counts, busy, summed, wall, _), retraced = trace_replays(key, step, pipe, chunks[:5], controls, want)
        # the live controls changed mid-stream: the same as eager, and nothing captured again
        sched_eager, _ = stream(pipe.step, pipe, chunks[:12], controls_at)
        sched, _ = stream(step, pipe, chunks[:12], controls_at)
        sched_bit, sched_rel = check_same(f"{key} {mode} with controls changed", sched, sched_eager,
                                          CPU_TOL["emitted"])
        recaptures = process_counter("captures") - captures0
        r = out[mode] = {
            "capture_s": capture_s, "capture_s_per_graph": per_graph, "bit_identical": bit, "rel_max_err": rel,
            "step_ms": times, "step_p50_ms": p50, "step_p95_ms": float(np.percentile(steady, 95)),
            "peak_mem_bytes": int(peak_mem), "graph_pool_bytes": int(pool), "kernels_in_trace": counts,
            "device_busy_ms_per_step": busy, "device_summed_ms_per_step": summed, "traced_step_ms": wall,
            "traced_again": retraced, "mfu": gflop * 1e9 / (p50 * 1e-3) / peak, "controls_bit_identical": sched_bit,
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
    log(key, f"the per-call weights check ({version.tensors} parameters and buffers): "
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
    """Device ms of each stage of the eager step, between CUDA events on the
    step's stream around its launches (the step's ``stage_times``: one wait
    a step, no synchronize a stage), p50 over the chunks: where the step's
    time goes."""
    times = {n: [] for n in ("pre", "features", "mel", "salience", "pitch_post", "synth", "post")}
    for chunk in chunks:
        stage_times = {}
        state, _ = pipe.step(state, chunk, controls, stage_times=stage_times)
        for n, ms in stage_times.items():
            times[n].append(ms)
    p50 = {n: float(np.percentile(v[2:], 50)) for n, v in times.items()}
    report[key]["stages_p50_ms"] = p50
    log(key, f"stage device ms p50 over {len(chunks) - 2} chunks, by CUDA events around each stage: "
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
#: the least share of pitch codes the card and the CPU must agree on, per dtype (RMVPE's bfloat16
#: step; CREPE's and FCPE's are held to the codes budget of compare_with_cpu)
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
    CPU_TOL``, ``e_cpu = rel(CPU bf16, CPU f32)``. The pitch codes: in
    float32 all equal; in bfloat16 at least ``CPU_CODES_AGREE`` of them for
    RMVPE, and for CREPE and FCPE by the budget's rule, as
    ``tests/test_torch_port_pitch_step.py`` holds the port to JAX: the frames
    whose card code differs from the CPU float32 one at most twice those whose
    CPU bf16 code does, and one (a random network's top salience bins lie
    within bf16's rounding of each other, so bf16 moves some frames' argmax
    on either device, not the same ones). Returns the CPU pipeline."""
    import torch

    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

    dtype = str(pipe.compute_dtype).removeprefix("torch.")
    cpu = RvcPipeline(pipe.cfg, pipe.version, device="cpu", compute_dtype=pipe.compute_dtype,
                      contentvec_cfg=pipe.contentvec_cfg, rmvpe_cfg=pipe.rmvpe_cfg, synth_cfg=pipe.synth_cfg,
                      pitch_algorithm=pipe.pitch_algorithm, crepe_cfg=pipe.crepe_cfg, fcpe_cfg=pipe.fcpe_cfg,
                      pallas_resblocks=pipe.synth_cfg.pallas_resblocks)
    for name, module in pipe.modules().items():
        cpu.modules()[name].load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    worst = {k: 0.0 for k in CPU_TOL}
    slack = {k: float("inf") for k in CPU_TOL}  # bfloat16: the least room of e_card under 2 e_cpu + CPU_TOL
    same, frames = 0, 0
    off_card, off_cpu = 0, 0  # bfloat16: frames whose code differs from the CPU float32 one

    def rel(a, b):
        b = b.float()
        return float((a.float().cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-12)

    t0 = time.perf_counter()
    # the stages take a stream axis: one stream here
    card_controls, cpu_controls = (StepControls.stack([controls], d) for d in (pipe.device, "cpu"))
    with torch.no_grad():
        for i, state in sorted(saved.items()):
            c = lambda t: t.cpu()  # noqa: E731
            state, chunk = state.map(lambda t: t[None]), chunks[i][None]
            buf, buf16 = pipe.stage_pre(state, chunk)
            phone = pipe.stage_features(buf16)
            mel = pipe.stage_mel(buf16)
            sal = pipe.stage_salience(mel)
            cache, pitch, pitchf = pipe.stage_pitch_post(state.cache_pitchf, sal, card_controls)
            audio = pipe.stage_synth(phone, pitch, pitchf, card_controls.sid)
            emitted, _ = pipe.stage_post(buf, audio, state.sola_buffer, card_controls.rms_mix_rate)
            card = {"buf16": buf16, "features": phone, "mel": mel, "salience": sal, "pitchf": pitchf,
                    "synth_audio": audio, "emitted": emitted}

            def on_cpu(p):
                """Each stage of ``p`` on the card's inputs to it; and the pitch codes."""
                _, cpitch, cpitchf = p.stage_pitch_post(c(state.cache_pitchf), c(sal), cpu_controls)
                return {
                    "buf16": p.stage_pre(state.to("cpu"), c(chunk))[1],
                    "features": p.stage_features(c(buf16)),
                    "mel": p.stage_mel(c(buf16)),
                    "salience": p.stage_salience(c(mel)),
                    "pitchf": cpitchf,
                    "synth_audio": p.stage_synth(c(phone), c(pitch), c(pitchf), cpu_controls.sid),
                    "emitted": p.stage_post(c(buf), c(audio), c(state.sola_buffer), cpu_controls.rms_mix_rate)[0],
                }, cpitch

            got, cpitch = on_cpu(cpu)
            errs = {k: rel(card[k], got[k]) for k in CPU_TOL}
            agree = pitch.cpu() == cpitch
            same, frames = same + int(agree.sum()), frames + agree.numel()
            line = ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            if reference is not None:
                ref, rpitch = on_cpu(reference)
                off_card += int((pitch.cpu() != rpitch).sum())
                off_cpu += int((cpitch != rpitch).sum())
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
    codes_budget = reference is not None and pipe.pitch_algorithm != "rmvpe"
    if reference is None:
        log(key, f"stage bounds in {dtype} (relative to max|cpu|): " + ", ".join(f"{k} {v:g}" for k, v in CPU_TOL.items())
                 + f"; f0 codes equal on at least {CPU_CODES_AGREE[dtype]:.0%} of the frames "
                 f"({time.perf_counter() - t0:.1f} s)")
        bad = [k for k in CPU_TOL if worst[k] > CPU_TOL[k]]
    else:
        report[key]["cpu_compare"].update(budget_slack=slack, codes_off_f32_card=off_card, codes_off_f32_cpu=off_cpu)
        log(key, "stage budgets in bfloat16, e_card <= 2 e_cpu + the float32 bound ("
                 + ", ".join(f"{k} {v:g}" for k, v in CPU_TOL.items()) + "); least slack "
                 + ", ".join(f"{k} {v:.2e}" for k, v in slack.items())
                 + (f"; f0 codes off the CPU float32 ones on {off_card} frames on the card, {off_cpu} on the CPU "
                    f"(bound 2 x {off_cpu} + 1)" if codes_budget else
                    f"; f0 codes equal on at least {CPU_CODES_AGREE[dtype]:.0%} of the frames")
                 + f" ({time.perf_counter() - t0:.1f} s)")
        bad = [k for k in CPU_TOL if slack[k] < 0]
    codes_ok = off_card <= 2 * off_cpu + 1 if codes_budget else same >= CPU_CODES_AGREE[dtype] * frames
    if bad or not codes_ok:
        raise AssertionError(f"{key}: card and CPU disagree: {bad or 'f0 codes'} ({worst}, codes {same}/{frames})")
    return cpu


# ---------------------------------------------------------------------------
# the kernels at reduced widths, and the pallas_resblocks switch
# ---------------------------------------------------------------------------

#: the CPU tests' reduced widths (tests/test_torch_port_pipeline.py CV, RM, SY): RMVPE levels of 8, 16 and 32
#: channels, the 40 kHz generator's upsample stack at 128 initial channels (bank levels of 64, 32, 16 and 8)
WIDTHS_CV = dict(dim=64, num_layers=2, tap_layer=2, num_heads=4, ffn_dim=128, out_dim=64)
WIDTHS_RM = dict(en_de_layers=3, inter_layers=1, n_blocks=2, en_out_channels=8, gru_hidden=32)
WIDTHS_SY = dict(feature_dim=64, inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=2,
                 upsample_initial_channel=128, gin_channels=16, spk_embed_dim=4)
#: its wrapper calls a step: the log-mel, the six chain levels of 8, 16 and 32 channels (encoder and
#: decoder; the intermediate level's 64 runs its modules), the four bank levels of 64, 32, 16 and 8
WIDTHS_LAUNCHES = {"log_mel": 1, "conv_block_res_chain": 6, "resblock_bank": 4}
WIDTHS_CHUNKS = 8
#: with pallas_resblocks=False the chain and bank levels run the networks' own convolutions (cuDNN): only the
#: log-mel kernel is left, as in the JAX pipeline
SWITCH_LAUNCHES = {"log_mel": 1, "conv_block_res_chain": 0, "resblock_bank": 0}
SWITCH_CHUNKS = 12


def phase_widths(report):
    """The port at the CPU tests' reduced widths on the card, whose C=8
    chain and bank levels run the kernels' C=8 instances: a few chunks
    eagerly (the wrappers launched 1 / 6 / 4 times a step) and through
    ``jit_step`` against the eager step, each stage held to the CPU's as the
    main phase holds it (float32 by its bounds; bfloat16 by its budget
    against the CPU float32 step). Returns the launches of each dtype's
    eager run, for the kernel line's width entries."""
    import torch

    from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
    from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
    from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig

    nets = dict(contentvec_cfg=ContentVecConfig(**WIDTHS_CV), rmvpe_cfg=RMVPEConfig(**WIDTHS_RM),
                synth_cfg=SynthesizerConfig(**WIDTHS_SY))
    reference = None
    for dtype in ("float32", "bfloat16"):
        key = "widths" if dtype == "float32" else "widths_bf16"
        run = phase_main(report, key, WIDTHS_CHUNKS, dtype, cpu_chunks=2, reference=reference, nets=nets,
                         per_step=WIDTHS_LAUNCHES)
        pipe = run["pipe"]
        graphed, _ = stream(pipe.jit_step, pipe, run["chunks"], run["controls"])
        bit, rel = check_same(f"{key} jit_step vs eager", graphed, run["audio"], CPU_TOL["emitted"],
                              chunk=pipe.cfg.sample_frame_size)
        report[key]["jit_step"] = {"bit_identical": bit, "rel_max_err": rel}
        log(key, f"jit_step over {WIDTHS_CHUNKS} chunks: " + ("bit-identical to the eager step" if bit else
                                                                f"within {rel:.3e} of max|eager|"))
        reference = run["cpu"]
        del run
        torch.cuda.empty_cache()


def stage_ms(pipe, batch, state, chunk, controls):
    """Each stage graph's device ms at ``batch`` streams, as the bench
    takes them (``scripts/torch_bench.py:stage_device_ms``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_bench", pathlib.Path(__file__).resolve().parent / "scripts" / "torch_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.stage_device_ms(pipe, batch, state, chunk, controls)[0]


SWITCH_STAGES = ("features", "salience", "synth_audio", "emitted")


def switch_stages(key, ref, pipes, chunks, controls, at):
    """The main phase's bfloat16 rule for the switch: at the chunks ``at``,
    each bfloat16 pipeline of ``pipes`` (with and without the kernels) runs
    the stages on the float32 kernel pipeline ``ref``'s inputs to them, and
    the one without the kernels is held to the one with them: its error off
    ``ref`` at most twice theirs plus the float32 bound (``CPU_TOL``), at
    every chunk. ``chunks`` ``[n]`` (one stream) or ``[B, n]``."""
    import torch

    from obs_rvc_tpu_torch.stream import StepControls, StreamState

    batched = chunks[0].dim() == 2
    ctl = controls if batched else StepControls.stack([controls], ref.device)
    state = StreamState.init_batch(ref.cfg, chunks[0].shape[0] if batched else 1, device=ref.device)
    worst = {name: dict.fromkeys(SWITCH_STAGES, 0.0) for name in pipes}
    slack = dict.fromkeys(SWITCH_STAGES, float("inf"))
    with torch.no_grad():
        for i, chunk in enumerate(chunks[: max(at) + 1]):
            chunk = chunk if batched else chunk[None]
            if i in at:
                buf, buf16 = ref.stage_pre(state, chunk)
                mel = ref.stage_mel(buf16)
                phone, sal = ref.stage_features(buf16), ref.stage_salience(mel)
                _, pitch, pitchf = ref.stage_pitch_post(state.cache_pitchf, sal, ctl)

                def stages(p):
                    audio = p.stage_synth(phone, pitch, pitchf, ctl.sid)
                    return {"features": p.stage_features(buf16), "salience": p.stage_salience(mel),
                            "synth_audio": audio,
                            "emitted": p.stage_post(buf, audio, state.sola_buffer, ctl.rms_mix_rate)[0]}

                want = stages(ref)
                errs = {name: {k: rel_err(v.float(), want[k].float()) for k, v in stages(p).items()}
                        for name, p in pipes.items()}
                for k in SWITCH_STAGES:
                    for name in pipes:
                        worst[name][k] = max(worst[name][k], errs[name][k])
                    slack[k] = min(slack[k], 2 * errs["kernels"][k] + CPU_TOL[k] - errs["no_kernels"][k])
            state, _ = ref.step(state, chunk, ctl, batched=True)
    log("switch", f"{key}: bfloat16 stages off the float32 kernel step's on its inputs, with / without the "
                  "kernels: " + ", ".join(f"{k} {worst['kernels'][k]:.2e} / {worst['no_kernels'][k]:.2e}"
                                          for k in SWITCH_STAGES)
                  + "; least slack under 2 x with + the float32 bound: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in slack.items()))
    bad = [k for k, v in slack.items() if v < 0]
    if bad:
        raise AssertionError(f"switch {key}: without the kernels the stages {bad} are off the float32 kernel step "
                             f"by more than twice the kernels' error plus the float32 bound ({worst})")
    return {"rel_max_err": worst, "budget_slack": slack}


#: the pallas_unet_max_ch settings stepped beside the default 32 (the JAX package's, whose levels of 16 and 32
#: channels run on the resident chain kernel), by dtype: 64 adds enc2 and dec2, 256 every encoder and decoder
#: level (the six past C=32 on the ring kernel); the intermediate levels run their modules at every setting
MAX_CH = {"float32": (256,), "bfloat16": (64, 256)}
#: their steps' wrapper calls: the log-mel, 6 or 10 chain levels, the two bank levels
MAX_CH_LAUNCHES = {64: {"log_mel": 1, "conv_block_res_chain": 6, "resblock_bank": 2},
                   256: {"log_mel": 1, "conv_block_res_chain": 10, "resblock_bank": 2}}
#: the device kernels of one max_ch=256 step's chain calls, 8 a level: the resident kernel at the four C <= 32
#: levels, the ring kernel at the six wider (the profiler's names; "conv3x3_kernel" is in both)
MAX_CH_KERNELS = {"resident": 32, "ring": 48}
#: the report keys of the max_ch=256 eager runs whose launches the kernel line gives the wide chain entries,
#: by (dtype, streams)
MAX_CH_RUNS = {("float32", 1): "max_ch_256", ("bfloat16", 1): "max_ch_256_bf16",
               ("bfloat16", POOL_B): "max_ch_256_b8", ("bfloat16", CHAIN_B64): "max_ch_256_b64"}
#: chunks of the max_ch=256 float32 step rerun stage by stage on the CPU and held to the main phase's bounds:
#: the main phase's chunks (its voiced signal, the chunks its own comparison starts at)
MAX_CH_CPU_CHUNKS = (N_CHUNKS // 2, N_CHUNKS // 2 + 1)
#: the switch phase's chunks at which the salience of the max_ch=256 and the default float32 steps is put
#: beside the CPU's and reported: on these the default step's own error reaches the bound (PERF.md)
MAX_CH_SALIENCE_CHUNKS = (6, 7)


def chain_kernel_launches(pipe, chunk, controls):
    """The chain's device kernels in one eager step, by kernel (a trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, _ = pipe.step(pipe.new_state(), chunk, controls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.step(state, chunk, controls)  # the tracer can miss a call's first kernels right after it starts
        torch.cuda.synchronize()
        mark_trace()
        pipe.step(state, chunk, controls)
        torch.cuda.synchronize()
    events = events_after_mark(prof)
    ring = sum(1 for e in events if "ring_conv3x3_kernel" in e.name)
    return {"resident": sum(1 for e in events if "conv3x3_kernel" in e.name) - ring, "ring": ring}


def salience_vs_cpu(base, pipe, cpu, chunks, controls, at):
    """The float32 salience stage of ``pipe`` (max_ch 256) and of ``base``
    (the default 32), each on its own step's mel at the chunks of ``at``
    (``pipe``'s states before them), against the CPU pipeline's ``cpu`` on
    the same mel, relative to max|CPU|: reported beside the main phase's
    bound, which the default step reaches on some chunks."""
    import torch

    states, state = {}, base.new_state()
    for i, chunk in enumerate(chunks[: max(at) + 1]):
        if i in at:
            states[i] = state
        state, _ = base.step(state, chunk, controls)
    out = {}
    with torch.no_grad():
        for name, p, sts in (("max_ch_32", base, states), ("max_ch_256", pipe, at)):
            errs = []
            for i in sorted(at):
                _, buf16 = p.stage_pre(sts[i].map(lambda t: t[None]), chunks[i][None])
                mel = p.stage_mel(buf16)
                want = cpu.stage_salience(mel.cpu())
                errs.append(float((p.stage_salience(mel).cpu() - want).abs().max()) / float(want.abs().max()))
            out[name] = errs
    log("switch", "float32 salience off the CPU's at the switch phase's chunks " + str(sorted(at)) + ": max_ch 32 "
                  + ", ".join(f"{e:.3e}" for e in out["max_ch_32"]) + "; max_ch 256 "
                  + ", ".join(f"{e:.3e}" for e in out["max_ch_256"]) + f" (the main phase's bound {CPU_TOL['salience']}, "
                  "held on its own chunks above)")
    return out


def max_ch_runs(report, dtype, base, base_row, on, ref, chunks, controls, chunks8=None, stacked8=None,
                base8=None):
    """``RvcPipeline(rmvpe_cfg=RMVPEConfig(pallas_unet_max_ch=mc))`` for
    ``mc`` in :data:`MAX_CH` of ``dtype`` on the switch phase's kernel pipeline's weights
    (``base``, at the default 32) and chunks, in ``dtype``. At 256 (every
    encoder and decoder level on the chain, the six past C=32 on its ring
    kernel): the wrappers launched 1 / 10 / 2 times a step and the chain's
    device kernels counted in a trace; the eager step repeating bit for
    bit; ``jit_step`` against it; the audio against the default step's
    (``on``): float32 within 1e-3 of max|audio|, bfloat16 by the main
    phase's rule against the float32 default step (``ref``); in float32 two
    of the main phase's chunks' stages against the CPU's under its bounds
    (and, reported, the salience of this and the default step against the
    CPU's at two of the switch phase's chunks, :func:`salience_vs_cpu`); in
    bfloat16 also 8 streams through ``jit_step_batch`` against the float32
    default step's (``base8``: the bfloat16 default's errors), and 64 (the 8
    streams' voices 8 times over) by the same rule, timed beside the
    default's ``jit_step_batch`` at 64. At 64: the
    launches and ``jit_step`` against the default's audio. At each, the
    salience stage's device ms and ``jit_step``'s p50 beside the default's
    (``base_row``)."""
    import torch

    from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
    from obs_rvc_tpu_torch.stream import RvcPipeline, StreamState

    n = base.cfg.sample_frame_size
    out = report.setdefault("max_ch", {}).setdefault(dtype, {})
    out[32] = {k: base_row[k] for k in ("jit_step_p50_ms", "jit_step_p95_ms", "stage_device_ms")}
    for mc in MAX_CH[dtype]:
        t0 = time.perf_counter()
        pipe = RvcPipeline(base.cfg, compute_dtype=base.compute_dtype, rmvpe_cfg=RMVPEConfig(pallas_unet_max_ch=mc))
        for mod, other in zip(pipe.modules().values(), base.modules().values()):
            mod.load_state_dict(other.state_dict())
        row = out[mc] = {}
        reset_launches()
        if mc == 256:
            state, outs, at = pipe.new_state(), [], {}
            for i, chunk in enumerate(chunks):
                if i in MAX_CH_SALIENCE_CHUNKS:
                    at[i] = state
                state, o = pipe.step(state, chunk, controls)
                outs.append(o)
            eager = torch.cat(outs).cpu()
            launches = read_launches()
            check_launches(f"max_ch 256 {dtype}", launches, len(chunks), per_step=MAX_CH_LAUNCHES[mc])
            again, _ = stream(pipe.step, pipe, chunks, controls)
            if not torch.equal(again, eager):
                raise AssertionError(f"max_ch 256 {dtype}: the eager step did not repeat bit for bit "
                                     f"({rel_err(again, eager):.3e} of max|audio|)")
            kernels = chain_kernel_launches(pipe, chunks[5], controls)
            if kernels != MAX_CH_KERNELS:
                raise AssertionError(f"max_ch 256 {dtype}: chain kernels a step {kernels}, expected {MAX_CH_KERNELS}")
            key = MAX_CH_RUNS[(dtype, 1)]
            report[key] = {"launches": launches, "chain_kernels_per_step": kernels}
            row.update(launches=launches, eager_repeat_bit_identical=True, chain_kernels_per_step=kernels)
            if dtype == "float32":
                _, rel = check_same("max_ch 256 float32 vs max_ch 32", eager, on, CPU_TOL["emitted"], chunk=n)
                row["rel_vs_max_ch_32"] = rel
                # stage by stage against the CPU on the main phase's chunks, under its bounds
                main = voiced_signal((max(MAX_CH_CPU_CHUNKS) + 1) * n, base.cfg.sample_rate)
                state, saved = pipe.new_state(), {}
                main_chunks = [torch.from_numpy(main[i * n : (i + 1) * n]).to(pipe.device)
                               for i in range(max(MAX_CH_CPU_CHUNKS) + 1)]
                for i, chunk in enumerate(main_chunks):
                    if i in MAX_CH_CPU_CHUNKS:
                        saved[i] = state
                    state, _ = pipe.step(state, chunk, controls)
                cpu = compare_with_cpu(report, key, pipe, saved, main_chunks, controls)
                row["cpu_compare"] = report[key]["cpu_compare"]
                row["salience_vs_cpu"] = salience_vs_cpu(base, pipe, cpu, chunks, controls, at)
            else:
                e_wide, e_32 = rel_err(eager, ref["one"]), rel_err(on, ref["one"])
                row.update(rel_vs_f32_max_ch_32=e_wide, max_ch_32_rel_vs_f32=e_32)
                if not e_wide <= 2 * e_32 + CPU_TOL["emitted"]:
                    raise AssertionError(f"max_ch 256 bfloat16: {e_wide:.3e} off the float32 default step, over "
                                         f"2 x {e_32:.3e} + {CPU_TOL['emitted']}")
                rel = e_wide
            log("switch", f"max_ch 256 {dtype} one stream: launches {launches} ({MAX_CH_LAUNCHES[mc]} a step), "
                          f"chain device kernels a step {kernels}; the eager step repeats bit for bit; audio "
                          + (f"within {rel:.3e} of max|audio| of the max_ch 32 step (bound {CPU_TOL['emitted']})"
                             if dtype == "float32" else
                             f"{rel:.3e} off the float32 max_ch 32 step, the bfloat16 max_ch 32 step's "
                             f"{row['max_ch_32_rel_vs_f32']:.3e} (bound 2 x that + {CPU_TOL['emitted']})"))
        else:
            pipe.step(pipe.new_state(), chunks[0], controls)
            launches = read_launches()
            check_launches(f"max_ch {mc} {dtype}", launches, 1, per_step=MAX_CH_LAUNCHES[mc])
            eager = on
            row["launches_one_step"] = launches
        graphed, gtimes = stream(pipe.jit_step, pipe, chunks, controls, timed=True)
        if mc == 256 or dtype == "float32":  # against its eager step, or (64) the default's audio
            g_bit, g_rel = check_same(f"max_ch {mc} {dtype} jit_step vs " + ("eager" if mc == 256 else "max_ch 32"),
                                      graphed, eager, CPU_TOL["emitted"], chunk=n)
        else:  # bfloat16 at 64: the main phase's rule against the float32 default step
            g_bit, g_rel, e_32 = False, rel_err(graphed, ref["one"]), rel_err(on, ref["one"])
            if not g_rel <= 2 * e_32 + CPU_TOL["emitted"]:
                raise AssertionError(f"max_ch {mc} bfloat16: {g_rel:.3e} off the float32 default step, over "
                                     f"2 x {e_32:.3e} + {CPU_TOL['emitted']}")
        row.update(jit_step_p50_ms=float(np.percentile(gtimes[4:], 50)),
                   jit_step_p95_ms=float(np.percentile(gtimes[4:], 95)), jit_step_bit_identical=g_bit,
                   jit_step_rel=g_rel, stage_device_ms=stage_ms(pipe, 1, pipe.new_state(), chunks[5], controls))
        if mc == 256 and chunks8 is not None:
            reset_launches()
            pipe.step(StreamState.init_batch(pipe.cfg, POOL_B, device=pipe.device), chunks8[0], stacked8,
                      batched=True)
            launches = read_launches()
            check_launches(f"max_ch 256 {dtype} batched", launches, 1, per_step=MAX_CH_LAUNCHES[mc])
            report[MAX_CH_RUNS[(dtype, POOL_B)]] = {"launches": launches}
            audio, times = stream_batch(pipe.jit_step_batch, pipe, chunks8, stacked8, timed=True)
            errs = [rel_err(audio[k], ref["eight"][k]) for k in range(POOL_B)]
            for k, (e, e_32) in enumerate(zip(errs, base8)):
                if not e <= 2 * e_32 + CPU_TOL["emitted"]:
                    raise AssertionError(f"max_ch 256 bfloat16 at {POOL_B} streams, stream {k}: {e:.3e} off the "
                                         f"float32 default step, over 2 x {e_32:.3e} + {CPU_TOL['emitted']}")
            row["batch8"] = {"launches_eager": launches, "p50_ms": float(np.percentile(times[1:], 50)),
                             "p95_ms": float(np.percentile(times[1:], 95)), "rel_vs_f32_max_ch_32": errs}
            log("switch", f"max_ch 256 {dtype} {POOL_B} streams (jit_step_batch): launches {launches} a step; p50 / "
                          f"p95 {row['batch8']['p50_ms']:.2f} / {row['batch8']['p95_ms']:.2f} ms; each stream off "
                          f"the float32 default step {max(errs):.3e} at most (the default's {max(base8):.3e})")
            # 64 streams, the 8 streams' voices and controls 8 times over (enc4 and dec0 on the ring's batch
            # kernel): each stream against its voice's float32 default step by the same rule, and the default
            # (max_ch 32) beside it
            rep = CHAIN_B64 // POOL_B
            chunks64 = [c.repeat(rep, 1) for c in chunks8]
            stacked64 = stacked8.map(lambda t: t.repeat(rep))
            reset_launches()
            pipe.step(StreamState.init_batch(pipe.cfg, CHAIN_B64, device=pipe.device), chunks64[0], stacked64,
                      batched=True)
            launches = read_launches()
            check_launches(f"max_ch 256 {dtype} batched at {CHAIN_B64}", launches, 1, per_step=MAX_CH_LAUNCHES[mc])
            report[MAX_CH_RUNS[(dtype, CHAIN_B64)]] = {"launches": launches}
            audio, times = stream_batch(pipe.jit_step_batch, pipe, chunks64, stacked64, timed=True)
            errs = [rel_err(audio[k], ref["eight"][k % POOL_B]) for k in range(CHAIN_B64)]
            for k, e in enumerate(errs):
                if not e <= 2 * base8[k % POOL_B] + CPU_TOL["emitted"]:
                    raise AssertionError(f"max_ch 256 bfloat16 at {CHAIN_B64} streams, stream {k}: {e:.3e} off the "
                                         f"float32 default step, over 2 x {base8[k % POOL_B]:.3e} + "
                                         f"{CPU_TOL['emitted']}")
            _, base_times = stream_batch(base.jit_step_batch, base, chunks64, stacked64, timed=True)
            row["batch64"] = {"launches_eager": launches, "p50_ms": float(np.percentile(times[1:], 50)),
                              "p95_ms": float(np.percentile(times[1:], 95)),
                              "max_ch_32_p50_ms": float(np.percentile(base_times[1:], 50)),
                              "max_ch_32_p95_ms": float(np.percentile(base_times[1:], 95)),
                              "rel_vs_f32_max_ch_32": errs}
            log("switch", f"max_ch 256 {dtype} {CHAIN_B64} streams (jit_step_batch): launches {launches} a step; "
                          f"p50 / p95 {row['batch64']['p50_ms']:.2f} / {row['batch64']['p95_ms']:.2f} ms (max_ch 32: "
                          f"{row['batch64']['max_ch_32_p50_ms']:.2f} / {row['batch64']['max_ch_32_p95_ms']:.2f}); "
                          f"each stream off its voice's float32 default step {max(errs):.3e} at most")
        del pipe
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
    runs_s = ", ".join(f"{out[mc]['seconds']:.1f}" for mc in MAX_CH[dtype])
    log("switch", f"{dtype} one stream by pallas_unet_max_ch (the runs of {MAX_CH[dtype]}: {runs_s} s): " + "; ".join(
        f"{mc}: salience stage {r['stage_device_ms']['salience']:.3f} ms, jit_step p50 / p95 "
        f"{r['jit_step_p50_ms']:.2f} / {r['jit_step_p95_ms']:.2f} ms" for mc, r in sorted(out.items())))


def phase_switch(report):
    """``RvcPipeline(pallas_resblocks=False)`` at full width, beside the
    kernel step on the same weights and chunks, in one call: one stream in
    float32 and bfloat16, eagerly and through ``jit_step``, and 8 streams
    through ``jit_step_batch`` in bfloat16. The switch-off step launches the
    wrappers 1 / 0 / 0 times a step and repeats bit for bit; its graphs
    hold its eager step; its audio holds the kernel step's: float32 within
    1e-3 of max|audio|, bfloat16 by the main phase's rule against the
    float32 kernel step: stage by stage on the float32 kernel step's inputs
    (:func:`switch_stages`), and the emitted stream end to end (its error
    at most twice the bfloat16 kernel step's plus 1e-3). Step p50/p95 and the salience and synth stages'
    device ms with and without the kernels. Then one ``serve.cli
    --no-pallas-resblocks`` conversion."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.serve import cli
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState, pipeline
    from obs_rvc_tpu_torch.utils import read_wav, write_wav

    cfg = ChunkConfig.build()
    n = cfg.sample_frame_size
    dev = pipeline.resolve_device(None)  # the card, as every pipeline here takes it
    wav = torch.from_numpy(voiced_signal(SWITCH_CHUNKS * n, cfg.sample_rate, seed=SEED + 7))
    chunks = [wav[i * n : (i + 1) * n].to(dev) for i in range(SWITCH_CHUNKS)]
    controls = StepControls.default(pitch_shift=0.0, rms_mix_rate=1.0)
    _, chunks8, controls8 = pool_streams(cfg, POOL_B, SWITCH_CHUNKS // 2, dev)
    stacked8 = StepControls.stack(controls8, dev)
    out, ref = {}, {}
    for dtype in ("float32", "bfloat16"):
        pipes = {}
        for name, switch in (("kernels", None), ("no_kernels", False)):
            pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype), pallas_resblocks=switch)
            if "kernels" in pipes:  # the same weights: the kernel pipeline's, copied
                for mod, other in zip(pipe.modules().values(), pipes["kernels"].modules().values()):
                    mod.load_state_dict(other.state_dict())
            else:
                pipe.init_params(SEED, std=None)
                if dtype == "bfloat16":
                    cast_params_for_serving(pipe)
            pipes[name] = pipe
        r = out[dtype] = {}
        for name, pipe in pipes.items():
            reset_launches()
            eager, times = stream(pipe.step, pipe, chunks, controls, timed=True)
            launches = read_launches()
            graphed, gtimes = stream(pipe.jit_step, pipe, chunks, controls, timed=True)
            g_bit, g_rel = check_same(f"switch {name} {dtype} jit_step vs eager", graphed, eager,
                                      CPU_TOL["emitted"], chunk=n)
            row = r[name] = {
                "launches": launches, "eager_p50_ms": float(np.percentile(times[4:], 50)),
                "eager_p95_ms": float(np.percentile(times[4:], 95)),
                "jit_step_p50_ms": float(np.percentile(gtimes[4:], 50)),
                "jit_step_p95_ms": float(np.percentile(gtimes[4:], 95)),
                "jit_step_bit_identical": g_bit, "jit_step_rel": g_rel,
                "stage_device_ms": stage_ms(pipe, 1, pipe.new_state(), chunks[5], controls)}
            if name == "no_kernels":
                check_launches(f"switch {dtype}", launches, SWITCH_CHUNKS, per_step=SWITCH_LAUNCHES)
                again, _ = stream(pipe.step, pipe, chunks, controls)
                if not torch.equal(again, eager):
                    raise AssertionError(f"switch {dtype}: the eager step without the kernels did not repeat bit "
                                         f"for bit ({rel_err(again, eager):.3e} of max|audio|)")
                row["eager_repeat_bit_identical"] = True
            row["audio"] = eager
            log("switch", f"{dtype} one stream, {name}: launches {launches}; eager p50 / p95 {row['eager_p50_ms']:.2f}"
                          f" / {row['eager_p95_ms']:.2f} ms, jit_step {row['jit_step_p50_ms']:.2f} / "
                          f"{row['jit_step_p95_ms']:.2f} ms ("
                          + ("bit-identical to eager" if g_bit else f"within {g_rel:.3e} of eager") + "); stage "
                          "device ms " + ", ".join(f"{k} {v:.3f}" for k, v in row["stage_device_ms"].items()))
        on, off = r["kernels"].pop("audio"), r["no_kernels"].pop("audio")
        if dtype == "float32":
            max_ch_runs(report, dtype, pipes["kernels"], r["kernels"], on, None, chunks, controls)
            ref["one"] = on
            _, rel = check_same("switch float32: no kernels vs kernels", off, on, CPU_TOL["emitted"], chunk=n)
            r["rel_vs_kernels"] = rel
            log("switch", f"float32: the step without the kernels within {rel:.3e} of max|audio| of the kernel "
                          f"step (bound {CPU_TOL['emitted']})")
            ref["eight"], _ = stream_batch(pipes["kernels"].jit_step_batch, pipes["kernels"], chunks8, stacked8)
            ref["pipe"] = pipes["kernels"]
        else:
            e_on, e_off = rel_err(on, ref["one"]), rel_err(off, ref["one"])
            r.update(rel_vs_f32_kernels=e_off, kernels_rel_vs_f32_kernels=e_on)
            log("switch", f"bfloat16: off the float32 kernel step, without the kernels {e_off:.3e}, with them "
                          f"{e_on:.3e} (bound 2 x {e_on:.3e} + {CPU_TOL['emitted']})")
            if not e_off <= 2 * e_on + CPU_TOL["emitted"]:
                raise AssertionError(f"switch bfloat16: {e_off:.3e} off the float32 kernel step, over 2 x {e_on:.3e} "
                                     f"+ {CPU_TOL['emitted']}")
            r["stages"] = switch_stages("one stream", ref["pipe"], pipes, chunks, controls, at=(6, 9))
            b8 = r["batch8"] = {}
            for name, pipe in pipes.items():
                reset_launches()
                state = StreamState.init_batch(cfg, POOL_B, device=pipe.device)
                pipe.step(state, chunks8[0], stacked8, batched=True)
                launches = read_launches()
                check_launches(f"switch {name} batched", launches, 1,
                               per_step=SWITCH_LAUNCHES if name == "no_kernels" else LAUNCHES_PER_STEP["rmvpe"])
                audio, times = stream_batch(pipe.jit_step_batch, pipe, chunks8, stacked8, timed=True)
                errs = [rel_err(audio[k], ref["eight"][k]) for k in range(POOL_B)]
                b8[name] = {"launches_eager": launches, "p50_ms": float(np.percentile(times[1:], 50)),
                            "p95_ms": float(np.percentile(times[1:], 95)), "rel_vs_f32_kernels": errs,
                            "stage_device_ms": stage_ms(pipe, POOL_B, StreamState.init_batch(cfg, POOL_B, dev),
                                                        chunks8[1], stacked8)}
                log("switch", f"bfloat16 {POOL_B} streams (jit_step_batch), {name}: p50 / p95 "
                              f"{b8[name]['p50_ms']:.2f} / {b8[name]['p95_ms']:.2f} ms; each stream off the float32 "
                              f"kernel step {max(errs):.3e} at most; stage device ms "
                              + ", ".join(f"{k} {v:.3f}" for k, v in b8[name]["stage_device_ms"].items()))
            for k in range(POOL_B):
                e_on, e_off = b8["kernels"]["rel_vs_f32_kernels"][k], b8["no_kernels"]["rel_vs_f32_kernels"][k]
                if not e_off <= 2 * e_on + CPU_TOL["emitted"]:
                    raise AssertionError(f"switch bfloat16 at {POOL_B} streams, stream {k}: {e_off:.3e} off the "
                                         f"float32 kernel step, over 2 x {e_on:.3e} + {CPU_TOL['emitted']}")
            b8["stages"] = switch_stages(f"{POOL_B} streams", ref["pipe"], pipes, chunks8, stacked8, at=(3,))
            max_ch_runs(report, dtype, pipes["kernels"], r["kernels"], on, ref, chunks, controls, chunks8, stacked8,
                        b8["kernels"]["rel_vs_f32_kernels"])
        for name in ("salience", "synth"):
            log("switch", f"{dtype} one stream, {name} stage: kernels {r['kernels']['stage_device_ms'][name]:.3f} ms, "
                          f"without {r['no_kernels']['stage_device_ms'][name]:.3f} ms")
        del pipes
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    src, dst = OUT_DIR / "switch_in.wav", OUT_DIR / "switch_out.wav"
    write_wav(src, voiced_signal(5 * n, cfg.sample_rate, seed=SEED + 8), cfg.sample_rate)
    reset_launches()
    t0 = time.perf_counter()
    cli.main([str(src), str(dst), "--no-pallas-resblocks", "--metrics-json"])
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    converted, sr = read_wav(dst)
    for f in (src, dst):
        f.unlink()
    if sr != cfg.sample_rate or converted.shape != (1, 5 * n) or not np.isfinite(converted).all() or \
            float(np.abs(converted).max()) < 1e-3:
        raise AssertionError(f"serve.cli --no-pallas-resblocks wrote {converted.shape} at {sr} Hz, or silence")
    if launches["conv_block_res_chain"] or launches["resblock_bank"] or not launches["log_mel"]:
        raise AssertionError(f"serve.cli --no-pallas-resblocks launched {launches}")
    out["cli"] = {"seconds": cli_s, "launches": launches}
    log("switch", f"serve.cli --no-pallas-resblocks (float32): 5 chunks in {cli_s:.1f} s (set-up and capture "
                  f"included), launches {launches}, max |y| {float(np.abs(converted).max()):.4f}")
    report["switch"] = out


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
    from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics, process_counter
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
    captures0 = process_counter("captures")
    ChunkMetrics.record = record_each
    try:
        with Server(server_argv(host)) as srv:
            bound = srv.bound
            captured_at_start = process_counter("captures") - captures0
            log("serve", f"server listening in {srv.startup_s:.1f} s with {captured_at_start} graphs captured "
                         f"(the staged step's 7, the engine's 1): {bound}")
            metrics_url = f"http://{host}:{bound['health']}/metrics"
            reset_launches()
            captures1 = process_counter("captures")

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
            captured = process_counter("captures") - captures1
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
            captures2 = process_counter("captures")
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
            want = {k: v * (3 + traced_chunks) for k, v in kernels_per_step().items()}
            log("serve", f"device trace of 3 RPC requests and a {traced_chunks}-chunk duplex session, all replays: "
                         f"hand kernels {counts} (want {want}) among {len(events) - marks[-1] - 1} device events")
            if counts != want or process_counter("captures") != captures2:
                raise AssertionError(f"serve: the traced replays launched {counts}, want {want}; "
                                     f"{process_counter('captures') - captures2} captures")

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


def phase_pitch_serve(report):
    """The server with ``--pitch-algorithm fcpe`` at its defaults (bfloat16,
    staged graphs captured before it listens, random weights from seed 0):
    one duplex session, a device trace of a second one (its replays must
    launch 1 log-mel, 0 chain and 6 bank kernels a chunk), ``/metrics``
    with no error; then ``serve.cli --pitch-algorithm crepe`` (float32, its
    default) converts a WAV file."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.serve import cli
    from obs_rvc_tpu_torch.serve.metrics import process_counter
    from obs_rvc_tpu_torch.utils import read_wav, write_wav

    host = "127.0.0.1"
    cfg = ChunkConfig.build()
    chunk = cfg.sample_frame_size
    captures0 = process_counter("captures")
    out = report["pitch_serve"] = {}
    with Server(server_argv(host, ["--pitch-algorithm", "fcpe"])) as srv:
        out["fcpe_startup_s"] = srv.startup_s
        out["fcpe_graphs_captured_at_start"] = process_counter("captures") - captures0
        url = f"http://{host}:{srv.bound['health']}/metrics"
        wav = voiced_signal((PITCH_SERVE_CHUNKS + 2) * chunk, cfg.sample_rate, seed=SEED + 40)
        t0 = time.perf_counter()
        streamed = duplex_session(host, srv.bound["duplex"], wav, PITCH_SERVE_CHUNKS, chunk, cfg.sample_rate)
        log("pitch-serve", f"fcpe server (bfloat16, staged graphs) listening in {srv.startup_s:.1f} s with "
                           f"{out['fcpe_graphs_captured_at_start']} graphs captured; duplex: {streamed.size} samples "
                           f"back ({streamed.size / chunk:.2f} chunks) in {time.perf_counter() - t0:.1f} s, all finite, "
                           f"tail max |y| {float(np.abs(streamed[2 * chunk :]).max()):.4f}")
        before = wait_metrics_settled(url)
        captures1 = process_counter("captures")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the tracer can miss the first kernels after it starts (a lone spin of ~5 ms was missed): 500
            # small kernels and ~50 ms of spinning, not counted, then the marker (the trace's last spin kernel)
            warm = torch.zeros(1, device="cuda")
            for _ in range(500):
                warm += 1.0
            for cycles in [10**7] * 10 + [1000]:
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
            duplex_session(host, srv.bound["duplex"], wav[: 6 * chunk], 4, chunk, cfg.sample_rate)
            metrics = wait_metrics_settled(url)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if not marks:
            raise AssertionError(f"pitch-serve: the trace holds no marker kernel among {len(events)} device events "
                                 f"({sorted({e.name[:40] for e in events})[:8]})")
        counts = kernel_counts(events[marks[-1] + 1 :])
        traced = metrics["chunks"] - before["chunks"]
        want = {k: v * traced for k, v in kernels_per_step("fcpe").items()}
        log("pitch-serve", f"device trace of a {traced}-chunk duplex session, all replays: hand kernels {counts} "
                           f"(want {want}); /metrics {metrics}")
        if counts != want or process_counter("captures") != captures1:
            raise AssertionError(f"pitch-serve: the traced replays launched {counts}, want {want}; "
                                 f"{process_counter('captures') - captures1} captures")
        if metrics["chunks"] < PITCH_SERVE_CHUNKS or metrics["errors"] != 0:
            raise AssertionError(f"pitch-serve: /metrics counts {metrics['chunks']} chunks and {metrics['errors']} errors")
        out.update(metrics=metrics, kernels_in_trace=counts, traced_chunks=traced)

    OUT_DIR.mkdir(exist_ok=True)
    src, dst = OUT_DIR / "crepe_in.wav", OUT_DIR / "crepe_out.wav"
    cli_chunks = 5
    write_wav(src, voiced_signal(cli_chunks * chunk, cfg.sample_rate, seed=SEED + 41), cfg.sample_rate)
    t0 = time.perf_counter()
    cli.main([str(src), str(dst), "--pitch-algorithm", "crepe", "--metrics-json"])
    converted, sr = read_wav(dst)
    out["crepe_cli_s"] = time.perf_counter() - t0
    if sr != cfg.sample_rate or converted.shape != (1, cli_chunks * chunk) or \
            not np.isfinite(converted).all() or float(np.abs(converted).max()) < 1e-3:
        raise AssertionError(f"serve.cli --pitch-algorithm crepe wrote {converted.shape} at {sr} Hz, or silence")
    log("pitch-serve", f"cli --pitch-algorithm crepe (float32): {src.name} -> {dst.name}, {converted.shape[1]} "
                       f"samples in {out['crepe_cli_s']:.1f} s (pipeline set-up and capture included), "
                       f"max |y| {float(np.abs(converted).max()):.4f}")


# ---------------------------------------------------------------------------
# the batched step and the pool
# ---------------------------------------------------------------------------

#: the pool phase: the batch sizes the batched step is timed at, chunks per stream of its comparison with
#: one-stream steps (the first is not timed), the slots starved for 3 ticks in the pool runs, and the chunks
#: each pooled server session streams
POOL_BATCHES = (1, POOL_B, 64)
POOL_CHUNKS = 6
POOL_STARVED = (2, 5)
POOL_SERVE_CHUNKS = 4
#: the pool's streams: a tone each, and (pitch shift, rms mix rate) with the speaker id the stream's index
POOL_F0 = (110.0, 130.0, 150.0, 170.0, 190.0, 210.0, 235.0, 260.0)
POOL_CONTROLS = ((0.0, 1.0), (12.0, 0.5), (-5.0, 0.8), (3.0, 0.25), (7.0, 1.0), (-2.0, 0.6), (5.0, 0.3),
                 (-7.0, 0.9))
#: the slack of the bfloat16 comparison of the batched step with one-stream steps: a stream of the batched
#: step no farther from the float32 one-stream step than the bfloat16 one-stream step is, plus this share of
#: max|audio|. Reported, not a gate: bfloat16 rounds in other library kernels at 8 streams than at one, and a
#: random RMVPE's frames near the voicing threshold then flip on either side, not the same ones (stream 1,
#: 0.4039 against 0.3877, chip runs 2 and 9 of PR 9). The gates are in pool_parity.
POOL_BF16_SLACK = 1e-3
#: a pooled slot against the batched step of the same voices and controls (a starved slot resumes exactly)
POOL_SLOT_TOL = 1e-5


def pool_streams(cfg, B, n_chunks, device):
    """``B`` voiced streams as ``n_chunks`` tensors ``[B, chunk]`` on the
    card, and their controls (one StepControls each)."""
    import torch

    from obs_rvc_tpu_torch.stream import StepControls

    n = cfg.sample_frame_size
    wavs = np.stack([voiced_signal(n_chunks * n, cfg.sample_rate, seed=SEED + 40 + k, f0=POOL_F0[k % len(POOL_F0)])
                     for k in range(B)])
    chunks = [torch.from_numpy(np.ascontiguousarray(wavs[:, i * n : (i + 1) * n])).to(device)
              for i in range(n_chunks)]
    controls = [StepControls.default(pitch_shift=POOL_CONTROLS[k % 8][0], rms_mix_rate=POOL_CONTROLS[k % 8][1],
                                     sid=k % 8) for k in range(B)]
    return wavs, chunks, controls


def stream_batch(step, pipe, chunks, controls, timed=False):
    """Stream ``[B, chunk]`` chunks from a zeroed batched state through
    ``step`` (the eager batched step, ``jit_step_batch`` or the batched stage
    graphs); returns the emitted audio ``[B, n]`` on the CPU and, with
    ``timed``, each step's ms (host clock, synchronized)."""
    import torch

    from obs_rvc_tpu_torch.stream import StreamState

    state, outs, times = StreamState.init_batch(pipe.cfg, chunks[0].shape[0], device=pipe.device), [], []
    for chunk in chunks:
        t0 = time.perf_counter()
        state, out = step(state, chunk, controls)
        if timed:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return torch.cat(outs, dim=1).cpu(), times


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def rel_l2(got, want):
    return float((got - want).norm()) / max(float(want.norm()), 1e-12)


def pool_parity(name, got, bf16_single, f32_single):
    """The bfloat16 batched streams against the one-stream steps on the same
    voices and controls. Gates: every stream finite and not silent, and each
    nearer (relative L2) its own float32 one-stream step than any other
    stream's, so none was silenced or handed another's audio. Reported: each
    stream's max error off its float32 one-stream step beside the bfloat16
    one-stream step's, and whether it is within that plus
    :data:`POOL_BF16_SLACK`."""
    n = len(got)
    m = min(got.shape[-1], f32_single[0].numel())
    dist = [[rel_l2(got[k, :m], f32_single[j][:m]) for j in range(n)] for k in range(n)]
    out = {"rel": [], "single_rel": [], "within_single_plus_slack": [], "l2_own": [], "l2_nearest_other": []}
    for k in range(n):
        e, e_single = rel_err(got[k, :m], f32_single[k][:m]), rel_err(bf16_single[k][:m], f32_single[k][:m])
        other = min(dist[k][j] for j in range(n) if j != k)
        if not bool(got[k].isfinite().all()) or float(got[k, m // 6 :].abs().max()) < 1e-3:
            raise AssertionError(f"{name} stream {k}: not finite, or silent")
        if not dist[k][k] < other:
            raise AssertionError(f"{name} stream {k}: relative L2 {dist[k][k]:.3f} off its own float32 one-stream "
                                 f"step, {other:.3f} off another stream's")
        for key, v in (("rel", e), ("single_rel", e_single), ("within_single_plus_slack", e <= e_single + POOL_BF16_SLACK),
                       ("l2_own", dist[k][k]), ("l2_nearest_other", other)):
            out[key].append(v)
    return out


def same_slots(name, got, want):
    """Each pooled slot against its row of the batched step, within :data:`POOL_SLOT_TOL`."""
    return [check_same(f"{name} slot {k}", g, want[k, : g.numel()], POOL_SLOT_TOL) for k, g in enumerate(got)]


def pool_run(pipe, wavs, controls, starved=(), **pool_kw):
    """A StreamPool of ``len(wavs)`` slots over ``pipe``, each slot fed its
    stream chunk by chunk, the ``starved`` slots given nothing for 3 ticks
    after their second chunk; returns each slot's audio (CPU tensors) and
    the tick times and phases."""
    import torch

    from obs_rvc_tpu_torch.stream import StreamPool

    cfg = pipe.cfg
    n, n_chunks = cfg.sample_frame_size, wavs.shape[1] // cfg.sample_frame_size
    t0 = time.perf_counter()
    pool = StreamPool(pipe, capacity=len(wavs), output_capacity_chunks=n_chunks + 2, **pool_kw)
    pool.prepare()
    capture_s = time.perf_counter() - t0
    slots = [pool.attach(c) for c in controls]
    fed, ticks, tick_ms, phases, starved_ticks = [0] * len(slots), 0, [], [], 0
    with torch.no_grad():
        while min(fed) < n_chunks:
            starving = False
            for k, s in enumerate(slots):
                if k in starved and fed[k] == 2 and starved_ticks < 3:
                    starving = True
                    continue
                if fed[k] < n_chunks:
                    pool.push_audio(s, wavs[k, fed[k] * n : (fed[k] + 1) * n])
                    fed[k] += 1
            starved_ticks += starving
            t1 = time.perf_counter()
            pool.process_pending()
            tick_ms.append((time.perf_counter() - t1) * 1e3)
            phases.append(dict(pool.last_tick_phases))
            ticks += 1
        pool.stop()
    errors = pool.metrics.snapshot().errors
    if errors:
        raise AssertionError(f"pool {pool_kw}: {errors} errors")
    audio = [torch.from_numpy(pool.pull_audio(s, n_chunks * n)) for s in slots]
    if any(a.numel() != n_chunks * n for a in audio):
        raise AssertionError(f"pool {pool_kw}: slots returned {[a.numel() for a in audio]} samples, want {n_chunks * n}")
    steady = np.asarray(tick_ms[1:])
    stats = {"capture_s": capture_s, "ticks": ticks, "tick_ms": tick_ms,
             "tick_p50_ms": float(np.percentile(steady, 50)), "tick_p95_ms": float(np.percentile(steady, 95)),
             "phases_p50_ms": {k: float(np.median([p[k] for p in phases[1:]])) for k in phases[0]}}
    return audio, stats


def phase_pool(report):
    """The batched step and the StreamPool at full width in bfloat16 (the
    server's dtype) with RMVPE: the eager batched step's wrapper launches at
    ``POOL_B`` streams; ``jit_step_batch`` at ``POOL_B`` streams with their own
    voices and controls against one-stream graphed steps (float32 within
    1e-3 of max|audio|, bfloat16 by :func:`pool_parity`) and a float32 pool
    against the same steps (1e-3); timing at every batch size of
    :data:`POOL_BATCHES` (p50/p95, ms a stream, audio-seconds a second,
    capture, memory) with a trace of 5 replays (1/32/6 hand kernels a step
    at every size, the busy share, the largest kernels), ContentVec's
    ``pos_conv`` alone, and an eager step traced with each kernel's
    operator; a batched step with CREPE and with FCPE; a bfloat16
    pool of ``POOL_B`` slots, fused and staged, on the float32 and int16
    wires and with pipelined ticks, two slots starved for 3 ticks, each slot
    against its row of the bfloat16 batched step (:data:`POOL_SLOT_TOL`)."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState

    cfg = ChunkConfig.build()
    n = cfg.sample_frame_size
    chunk_s = n / cfg.sample_rate
    dev = torch.device("cuda")

    def make(dtype, pitch="rmvpe"):
        p = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype), pitch_algorithm=pitch)
        p.init_params(SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(p)
        return p

    pipes = {"float32": make("float32"), "bfloat16": make("bfloat16")}
    bf = pipes["bfloat16"]
    out = report["pool"] = {"dtype": "bfloat16", "streams": POOL_B, "chunks": POOL_CHUNKS}
    wavs, chunks, controls = pool_streams(cfg, POOL_B, POOL_CHUNKS, dev)
    stacked = StepControls.stack(controls, dev)

    # 1. the batched step eagerly: each wrapper launched once a step for every stream
    torch.cuda.synchronize()
    reset_launches()
    eager, _ = stream_batch(lambda s, c, k: bf.step(s, c, k, batched=True), bf, chunks, stacked)
    launches = read_launches()
    out["launches"] = launches
    log("pool", f"eager batched step of {POOL_B} streams, {POOL_CHUNKS} chunks: kernel launches {launches}")
    check_launches("pool", launches, POOL_CHUNKS)

    # 2. jit_step_batch against one-stream graphed steps on the same voices and controls; a float32 pool of
    # POOL_B slots, two starved, against the same one-stream steps
    singles = {d: [stream(p.jit_step, p, [c[k] for c in chunks], controls[k])[0] for k in range(POOL_B)]
               for d, p in pipes.items()}
    batched = {d: stream_batch(p.jit_step_batch, p, chunks, stacked)[0] for d, p in pipes.items()}
    f32 = [check_same(f"pool float32 batch stream {k}", batched["float32"][k], singles["float32"][k],
                      CPU_TOL["emitted"]) for k in range(POOL_B)]
    bf16 = pool_parity("pool bfloat16 batch", batched["bfloat16"], singles["bfloat16"], singles["float32"])
    graphed_vs_eager = check_same("pool bfloat16 jit_step_batch vs eager", batched["bfloat16"], eager,
                                  CPU_TOL["emitted"])
    out["parity"] = {"float32_rel": [r for _, r in f32], "float32_bit_identical": [b for b, _ in f32],
                     "bfloat16": bf16, "graphed_vs_eager_bit_identical": graphed_vs_eager[0]}
    log("pool", f"jit_step_batch of {POOL_B} voices (tones {POOL_F0[0]:.0f}-{POOL_F0[-1]:.0f} Hz, pitch shifts, mix "
                f"rates, speaker ids 0-7) against {POOL_B} one-stream jit_step runs: float32 max|diff| / max|audio| "
                + ", ".join(f"{r:.2e}" for _, r in f32) + " (bound " + f"{CPU_TOL['emitted']}); bfloat16 off the "
                "float32 one-stream step " + ", ".join(f"{e:.4f}" for e in bf16["rel"])
                + " (the bfloat16 one-stream step: " + ", ".join(f"{e:.4f}" for e in bf16["single_rel"])
                + f"; within it plus {POOL_BF16_SLACK}: {sum(bf16['within_single_plus_slack'])} of {POOL_B}); "
                "relative L2 off its own float32 one-stream step " + ", ".join(f"{e:.3f}" for e in bf16["l2_own"])
                + ", off the nearest other stream's " + ", ".join(f"{e:.3f}" for e in bf16["l2_nearest_other"])
                + "; the bfloat16 graph "
                + ("bit-identical to" if graphed_vs_eager[0] else f"within {graphed_vs_eager[1]:.2e} of")
                + " the eager batched step")
    f32_pool, stats = pool_run(pipes["float32"], wavs, controls, starved=POOL_STARVED, mode="fused")
    f32_pool_vs = {"single": [check_same(f"pool float32 fused slot {k}", a, singles["float32"][k][: a.numel()],
                                         CPU_TOL["emitted"]) for k, a in enumerate(f32_pool)],
                   "batched": [check_same(f"pool float32 fused slot {k} vs batch", a, batched["float32"][k, : a.numel()],
                                          CPU_TOL["emitted"]) for k, a in enumerate(f32_pool)]}
    stats.update(vs_one_stream=f32_pool_vs["single"], vs_batched=f32_pool_vs["batched"])
    out["float32_pool"] = stats
    log("pool", f"StreamPool({POOL_B}, float32, fused) slots {POOL_STARVED} starved for 3 ticks: tick p50 "
                f"{stats['tick_p50_ms']:.2f} ms; each slot against its float32 one-stream step "
                + ", ".join(f"{r:.2e}" for _, r in f32_pool_vs["single"]) + " of max|audio| (bound "
                f"{CPU_TOL['emitted']}), against the float32 batched step "
                + ", ".join("bit-identical" if b else f"{r:.2e}" for b, r in f32_pool_vs["batched"]))
    # the bfloat16 pool's reference on the int16 wire: the batched step on the voices rounded to int16
    int16_in = (np.clip(np.rint(wavs * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)
    int16_chunks = [torch.from_numpy(np.ascontiguousarray(int16_in[:, i * n : (i + 1) * n])).to(dev)
                    for i in range(POOL_CHUNKS)]
    batched_q = stream_batch(bf.jit_step_batch, bf, int16_chunks, stacked)[0]
    del pipes["float32"], f32_pool
    bf._graphs.clear()  # timed below from their captures, B=1 (jit_step) too
    torch.cuda.empty_cache()

    # 3. the batched graph at every batch size: time, memory, a trace of 5 replays
    timing = out["batches"] = {}
    for B in POOL_BATCHES:
        take = torch.arange(B, device=dev) % POOL_B
        ch = [c[take] for c in chunks] * 2
        ctl = StepControls.stack([controls[k % POOL_B] for k in range(B)], dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        graph = bf.batch_graph(B)
        graph.capture()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        audio, times = stream_batch(bf.jit_step_batch, bf, ch, ctl, timed=True)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        graph_bytes = torch.cuda.memory_reserved() - reserved0
        if not bool(audio.isfinite().all()) or bool((audio[:, n:].abs().amax(dim=1) < 1e-3).any()):
            raise AssertionError(f"pool B={B}: the batched audio is not finite, or a stream is silent")
        want = {k: v * 5 for k, v in kernels_per_step("rmvpe", B).items()}
        (counts, busy, summed, wall, events), retraced = trace_replays(
            "pool", bf.jit_step_batch, bf, ch[:5], ctl, want, lambda: StreamState.init_batch(cfg, B, device=dev))
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / 5
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        pos_conv = pos_conv_ms(bf, B)
        owners, mine = traced_step_owners(bf, ch[0], ctl)
        by_owner = {}
        for kname, ms, op, shapes in owners:
            key = f"{kname[:50]} <- {op} {shapes[:2]}"
            by_owner[key] = by_owner.get(key, 0.0) + ms
        top_owned = sorted(by_owner.items(), key=lambda kv: -kv[1])[:4]
        pos_conv_eager = sum(ms for _, ms, _, _ in mine)
        steady = np.asarray(times[2:])
        p50 = float(np.percentile(steady, 50))
        r = timing[B] = {
            "capture_s": capture_s, "step_ms": times, "step_p50_ms": p50,
            "step_p95_ms": float(np.percentile(steady, 95)), "ms_per_stream": p50 / B,
            "audio_seconds_per_second": B * chunk_s / (p50 / 1e3), "peak_mem_bytes": int(peak),
            "graph_pool_bytes": int(graph_bytes), "kernels_in_trace": counts, "device_busy_ms_per_step": busy,
            "device_summed_ms_per_step": summed, "traced_step_ms": wall, "traced_again": retraced,
            "top_kernels_ms_per_step": top, "pos_conv_ms_per_step": pos_conv[0],
            "pos_conv_contiguous_ms_per_step": pos_conv[1], "pos_conv_eager_traced_ms": pos_conv_eager,
            "pos_conv_eager_kernels": sorted({k for k, _, _, _ in mine}), "eager_top_kernels_by_operator": top_owned}
        log("pool", f"jit_step_batch B={B}: captured in {capture_s:.2f} s; step p50 {p50:.2f} ms, p95 "
                    f"{r['step_p95_ms']:.2f} ms over {len(steady)} steps, {r['ms_per_stream']:.3f} ms a stream, "
                    f"{r['audio_seconds_per_second']:.1f} audio-s/s; peak device memory {peak / 2**20:.1f} MiB, the "
                    f"graph holds {graph_bytes / 2**20:.1f} MiB")
        log("pool", f"B={B} trace of 5 replayed steps: hand kernels {counts} (want {want}); device busy {busy:.2f} ms "
                    f"a step of {wall:.2f} ms with the tracer on ({busy / wall:.1%}); ContentVec's pos_conv alone at "
                    f"the step's shape and layout {pos_conv[0]:.2f} ms (graphed; on a contiguous copy "
                    f"{pos_conv[1]:.2f}); the largest kernels: "
                    + "; ".join(f"{v:.2f} ms {k[:60]}" for k, v in top))
        log("pool", f"B={B} eager step traced with its operators: pos_conv's kernels' intervals sum to "
                    f"{pos_conv_eager:.2f} ms (" + ", ".join(sorted({k[:60] for k, _, _, _ in mine}))
                    + f"; they overlap: by CUDA events it takes {pos_conv[0]:.2f}); the largest summed intervals "
                    "by operator: " + "; ".join(f"{v:.2f} ms {k}" for k, v in top_owned))
        if counts != want:
            raise AssertionError(f"pool B={B}: the trace of 5 steps shows {counts} hand kernel launches, want {want}")
        del bf._graphs[f"jit_step_batch/{B}"], graph, audio
    torch.cuda.empty_cache()

    # 4. CREPE and FCPE through one batched step each, at 4 streams
    pitch = out["pitch"] = {}
    for algo in ("crepe", "fcpe"):
        p = make("bfloat16", algo)
        ch, ctl = [c[:4] for c in chunks[:2]], StepControls.stack(controls[:4], dev)
        reset_launches()
        eager_p, _ = stream_batch(lambda s, c, k: p.step(s, c, k, batched=True), p, ch, ctl)
        launched = read_launches()
        check_launches(f"pool {algo}", launched, len(ch), algo, dtype="bfloat16")
        graphed_p, _ = stream_batch(p.jit_step_batch, p, ch, ctl)
        same = check_same(f"pool {algo} jit_step_batch vs eager", graphed_p, eager_p, CPU_TOL["emitted"])
        if bool((eager_p[:, n:].abs().amax(dim=1) < 1e-3).any()):
            raise AssertionError(f"pool {algo}: a stream of the batched step is silent")
        pitch[algo] = {"launches": launched, "graphed_bit_identical": same[0], "graphed_rel": same[1]}
        log("pool", f"{algo} batched step of 4 streams, {len(ch)} chunks: launches {launched}; jit_step_batch "
                    + ("bit-identical to" if same[0] else f"within {same[1]:.2e} of") + " the eager batched step")
        del p
        torch.cuda.empty_cache()

    # 5. the pool in bfloat16: fused and staged, the float32 and int16 wires, pipelined ticks; two slots starved.
    # Each slot against its row of the batched step on the same voices (on the int16 wire: rounded to int16)
    runs = out["runs"] = {}
    audio = {}
    for name, kw, w, want in (
            ("fused", dict(mode="fused", exec_cache=True), wavs, batched["bfloat16"]),
            ("staged", dict(mode="staged"), wavs, batched["bfloat16"]),
            ("fused-int16", dict(mode="fused", io_dtype="int16"), wavs, None),
            ("fused-pipelined", dict(mode="fused", exec_cache=True, pipelined=True), wavs, batched["bfloat16"]),
            ("fused-on-int16-input", dict(mode="fused", exec_cache=True), int16_in, batched_q)):
        audio[name], stats = pool_run(bf, w, controls, starved=POOL_STARVED, **kw)
        runs[name] = stats
        if want is not None:  # the int16 wire is held below against the run on its rounded input
            stats["vs_batched"] = same_slots(f"pool {name}", audio[name], want)
        log("pool", f"StreamPool({POOL_B}, {kw}) slots {POOL_STARVED} starved for 3 ticks: {stats['ticks']} ticks, "
                    f"tick p50 {stats['tick_p50_ms']:.2f} ms, p95 {stats['tick_p95_ms']:.2f} ms, capture "
                    f"{stats['capture_s']:.2f} s; phases p50 "
                    + ", ".join(f"{k} {v:.2f}" for k, v in stats["phases_p50_ms"].items()) + " ms"
                    + ("" if want is None else "; each slot against the batched step "
                       + ", ".join("bit-identical" if b else f"{r:.2e}" for b, r in stats["vs_batched"])
                       + f" (bound {POOL_SLOT_TOL})"))
    for a, b in (("staged", "fused"), ("fused-pipelined", "fused")):
        same = [check_same(f"pool {a} vs {b} slot {k}", x, y, CPU_TOL["emitted"])
                for k, (x, y) in enumerate(zip(audio[a], audio[b]))]
        runs[a][f"vs_{b}"] = same
        log("pool", f"{a} vs {b}: " + ("every slot bit-identical" if all(s for s, _ in same) else
                                       "max relative difference " + f"{max(r for _, r in same):.2e}"))
    # the int16 wire: the same graph fed the int16-rounded input, its output rounded to int16 and back
    lsb = [float((i - torch.clamp(r, -1.0, 32767 / 32768)).abs().max()) * 32768
           for i, r in zip(audio["fused-int16"], audio["fused-on-int16-input"])]
    runs["fused-int16"]["lsb_off_the_rounded_input_run"] = lsb
    log("pool", "int16 wire against the float32 wire on the int16-rounded input: max |diff| "
                + ", ".join(f"{v:.3f}" for v in lsb) + " LSB (bound 0.5)")
    if max(lsb) > 0.5 + 1e-3:
        raise AssertionError(f"pool int16 wire: {max(lsb):.3f} LSB off the float32 wire on the same input")
    del singles, batched, batched_q, eager, audio
    bf._graphs.clear()
    torch.cuda.empty_cache()


def pos_conv_ms(pipe, B):
    """ContentVec's ``pos_conv`` as the step runs it (``conv_rounded`` of its
    grouped convolution), alone, at the shape it gets in a step of ``B``
    streams, graphed device ms a call: on the step's layout (the features
    ``[B, T, C]`` transposed, a strided view) and on a contiguous copy."""
    import torch
    import torch.nn.functional as F

    from obs_rvc_tpu_torch.ops._mma import conv_rounded

    cv = pipe.contentvec
    conv, dtype = cv.encoder.pos_conv[0], cv.post_extract_proj.weight.dtype
    x = torch.zeros(1, 1, pipe.cfg.input_buffer_16k_size, device=pipe.device, dtype=dtype)
    with torch.no_grad():
        for layer in cv.feature_extractor.conv_layers:
            x = layer(x)
        x = torch.randn(B, x.shape[-1], conv.in_channels, device=pipe.device).to(dtype).transpose(1, 2)
        return [graph_ms(lambda: conv_rounded(F.conv1d, v, conv.weight, conv.bias, padding=conv.padding,
                                              groups=conv.groups)) for v in (x, x.contiguous())]


def kernel_owners(prof):
    """Each device kernel of a torch.profiler run with the outermost aten
    operator that launched it: ``[(kernel, device ms, operator, its input
    shapes)]``."""
    out = []

    def walk(e, top):
        top = top or (e if e.name.startswith("aten::") else None)
        for k in e.kernels:
            out.append((k.name, k.duration / 1e3, (top or e).name, (top or e).input_shapes))
        for c in e.cpu_children:
            walk(c, top)

    for e in prof.events():
        if e.cpu_parent is None:
            walk(e, None)
    return out


def traced_step_owners(pipe, chunk, controls, activities=None):
    """One eager batched step of ``len(chunk)`` streams (after a warm-up one)
    under torch.profiler with shapes: :func:`kernel_owners`, and those of
    them launched by ContentVec's ``pos_conv`` (the operator whose weight
    has ``pos_conv``'s shape). A kernel's interval can overlap the next
    one's (its 16 group convolutions' do), so their sum is not a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from obs_rvc_tpu_torch.stream import StreamState

    wshape = list(pipe.contentvec.encoder.pos_conv[0].weight.shape)
    state = StreamState.init_batch(pipe.cfg, chunk.shape[0], device=pipe.device)
    pipe.step(state, chunk, controls, batched=True)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    with profile(activities=activities or [ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        pipe.step(state, chunk, controls, batched=True)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
    owners = kernel_owners(prof)
    ops = [e for e in prof.events() if e.name == "aten::conv1d" and len(e.input_shapes) > 1
           and list(e.input_shapes[1]) == wshape]
    if len(ops) != 1:
        raise AssertionError(f"the traced step shows {len(ops)} convolutions of pos_conv's weight {wshape}, want 1")
    mine = [o for o in owners if o[2] == "aten::conv1d" and len(o[3]) > 1 and list(o[3][1]) == wshape]
    return owners, mine


def phase_pool_serve(report):
    """The server with ``--pool POOL_B`` at its other defaults (bfloat16,
    staged pool ticks captured before it listens): 4 duplex and 2 WebSocket
    sessions at once, each against its own run alone; ``POOL_B``
    connections hold every slot and a ninth is closed; /metrics shows the
    pool's occupancy and counts no error."""
    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.serve.stream_server import StreamClient
    from obs_rvc_tpu_torch.serve.ws import WsStreamClient

    import torch

    host = "127.0.0.1"
    cfg = ChunkConfig.build()
    chunk = cfg.sample_frame_size
    with Server(server_argv(host, ["--pool", str(POOL_B)])) as srv:
        bound = srv.bound
        metrics_url = f"http://{host}:{bound['health']}/metrics"
        log("pool", f"server with --pool {POOL_B} listening in {srv.startup_s:.1f} s: {bound}")
        doors = ["duplex"] * 4 + ["websocket"] * 2
        sigs = [voiced_signal((POOL_SERVE_CHUNKS + 2) * chunk, cfg.sample_rate, seed=SEED + 60 + i,
                              f0=POOL_F0[i]) for i in range(len(doors))]

        def session(i):
            if doors[i] == "duplex":
                return duplex_session(host, bound["duplex"], sigs[i], POOL_SERVE_CHUNKS, chunk, cfg.sample_rate)
            client = WsStreamClient.connect(host, bound["ws"], timeout=120)
            try:
                return stream_door("websocket", client.send_audio, sigs[i], 2400, chunk, POOL_SERVE_CHUNKS,
                                   cfg.sample_rate)
            finally:
                client.close()

        t0 = time.perf_counter()
        alone = [session(i) for i in range(len(doors))]
        t_alone = time.perf_counter() - t0
        together = [None] * len(doors)

        def concurrent(i):
            together[i] = session(i)

        workers = [threading.Thread(target=concurrent, args=(i,)) for i in range(len(doors))]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(180)
        t_together = time.perf_counter() - t0
        if any(w.is_alive() for w in workers) or any(t is None for t in together):
            raise AssertionError("the concurrent pooled sessions did not finish")
        same = []
        for i, (a, b) in enumerate(zip(alone, together)):
            m = min(a.size, b.size)
            same.append(check_same(f"pooled {doors[i]} session {i} together vs alone", torch.from_numpy(b[:m]),
                                   torch.from_numpy(a[:m]), CPU_TOL["emitted"]))
        log("pool", f"4 duplex and 2 WebSocket sessions at once ({t_together:.1f} s; one by one {t_alone:.1f} s), "
                    "each against its run alone: " + ", ".join("bit-identical" if b else f"{r:.2e}" for b, r in same))

        # every slot held, then one connection too many
        clients = [StreamClient.connect_tcp(host, bound["duplex"], timeout=60) for _ in range(POOL_B)]
        for c in clients:
            c.send_audio(np.zeros(2400, np.float32))
        with urllib.request.urlopen(metrics_url, timeout=30) as r:
            held = json.loads(r.read())
        ninth = StreamClient.connect_tcp(host, bound["duplex"], timeout=60)
        try:
            ninth.send_audio(np.zeros(2400, np.float32))
            rejected = False
        except (EOFError, ConnectionError):
            rejected = True
        for c in clients + [ninth]:
            c.close()
        metrics = wait_metrics_settled(metrics_url)
        log("pool", f"{POOL_B} connections held: /metrics pool_active {held['pool_active']} of "
                    f"{held['pool_capacity']}; connection {POOL_B + 1} " + ("closed" if rejected else "ACCEPTED")
                    + f"; /metrics at the end {metrics}")
        if not rejected or held["pool_active"] != POOL_B or held["pool_capacity"] != POOL_B:
            raise AssertionError(f"--pool {POOL_B}: occupancy {held}, connection {POOL_B + 1} rejected: {rejected}")
        if metrics["errors"] != 0 or metrics["chunks"] < POOL_SERVE_CHUNKS:
            raise AssertionError(f"--pool {POOL_B}: /metrics {metrics}")
    report["pool_serve"] = {"ports": bound, "startup_s": srv.startup_s, "together_vs_alone":
                            [{"bit_identical": b, "rel": r} for b, r in same], "held_metrics": held,
                            "ninth_rejected": rejected, "metrics": metrics, "together_s": t_together,
                            "alone_s": t_alone}


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

    def measure(name, shape_label, kernel, plain, library, flops, nbytes, peak=F32_PEAK_FLOPS, depth=(10, 10)):
        """Kernel, plain version, library and kernel again, each as device
        time in a CUDA graph of ``depth[0]`` calls replayed ``depth[1]``
        times (fewer at 64 streams, whose calls take milliseconds); the
        kernel's wrapper also eagerly, as the step calls it, where the
        host's launch cost shows."""
        torch.backends.cudnn.benchmark = False
        ms = graph_ms(kernel, *depth)
        plain_ms = graph_ms(plain, *depth)
        torch.backends.cudnn.benchmark = True
        library_ms = graph_ms(library, *depth)
        torch.backends.cudnn.benchmark = False
        ms2 = graph_ms(kernel, *depth)
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
    chain_cases = [(shape, *chain_inputs(*shape, dev, rng))
                   for shape in CHAIN_SHAPES + CHAIN_SHAPES_BATCH + CHAIN_SHAPES_B64 + CHAIN_WIDTH_SHAPES + CHAIN_WIDE_ALL]
    for dt, (suffix, peak, rate, elem) in rates.items():
        name = "conv_block_res_chain" + suffix
        for (label, B, H, W, cin, C), x32, blocks32 in chain_cases:
            x, blocks = x32.to(dt), [cast(b, dt) for b in blocks32]
            packed = unet_block.pack_chain(blocks, dt)  # as _Chain caches it per weight version
            flops, nbytes = chain_flops_bytes(B, H, W, cin, C, elem, elem)
            measure(name, label, lambda: unet_block.conv_block_res_chain(x, packed),
                    lambda: unet_block.conv_block_res_chain_plain(x, blocks), chain_library(x, blocks),
                    flops, nbytes, peak=peak, depth=LARGE_DEPTH if B >= CHAIN_B64 else (10, 10))
            r = rows[name][label]
            r["bound_ms_f32_cuda_cores"] = bound_ms(flops, nbytes)[0]
            r["launch"] = chain_launch(B, H, W, cin, C, dt)
            ln = r["launch"]
            log("timing", f"chain {label}{suffix} launch ({'ring' if ln['ring'] else 'resident'} kernel, "
                          f"{'wgmma' if ln['wgmma'] else 'mma.sync'}): tiles of {ln['streams']} stream(s) x "
                          f"{ln['th']}x{ln['tw']} pixels and {ln['bn']} channels, {ln['wm']} m16 tiles a warp, "
                          f"{ln['threads']} threads; {ln['tiles']} tiles, K split {ln['splits']}, {ln['blocks']} "
                          f"blocks at most a launch, {ln['waves']:.2f} waves over {N_SMS} SMs; {ln['smem_bytes']} B "
                          f"shared memory, {ln['registers']} registers, {ln['blocks_per_sm']} blocks an SM")
            if trace and dt == torch.float32 and packed.width == C:  # a padded width adds the pad's copies
                # and a split K the zeroing of its counters
                calls = kernel_trace(lambda: unet_block.conv_block_res_chain(x, packed),
                                     2 * N_BLOCKS + (1 if ln["partial"] else 0))
                last = calls[-1]
                rows[name][label]["trace_us"] = last
                log("profile", f"chain {label}: {len(last)} kernels per call, span "
                               f"{last[-1][2] + last[-1][1]:.1f} us (last of {len(calls)} calls); each kernel "
                               + ", ".join(f"{d:.1f} us at +{t:.1f}" for _, d, t in last))
        for label, r in rows[name].items():
            log("timing", f"chain level {label}{suffix}: kernel {r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
                          f"({r['ms'] / r['library_ms']:.2f}x cuDNN's time), eager one-call wrapper "
                          f"{r['eager_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms at {rate} TFLOP/s, "
                          f"{r['bound_ms_f32_cuda_cores']:.4f} ms at float32's 67 TFLOP/s")
        for tag, shapes in (("", CHAIN_SHAPES), (f" at {POOL_B} streams", CHAIN_SHAPES_BATCH),
                            (f" at {CHAIN_B64} streams", CHAIN_SHAPES_B64), (" wide", CHAIN_WIDE_SHAPES),
                            (f" wide at {POOL_B} streams", CHAIN_WIDE_SHAPES_BATCH),
                            (f" wide at {CHAIN_B64} streams", CHAIN_WIDE_SHAPES_B64)):
            chain_rows = [rows[name][sh[0]] for sh in shapes]
            log("timing", f"chain{suffix} per step{tag} ({len(shapes)} levels): kernel "
                          f"{sum(r['ms'] for r in chain_rows):.4f} ms, eager "
                          f"{sum(r['eager_ms'] for r in chain_rows):.4f} ms, cuDNN "
                          f"{sum(r['library_ms'] for r in chain_rows):.4f} ms, bound "
                          f"{sum(r['bound_ms'] for r in chain_rows):.4f} ms ({rate} TFLOP/s) / "
                          f"{sum(r['bound_ms_f32_cuda_cores'] for r in chain_rows):.4f} ms (float32 CUDA cores)")
    bank_cases = [(shape, *bank_inputs(*shape[:4], dev, rng, *shape[4:]))
                  for shape in map(bank_shape, BANK_SHAPES + BANK_EXTRA_SHAPES + BANK_SHAPES_BATCH + BANK_SHAPES_B64
                                   + BANK_WIDTH_SHAPES)]
    for dt, (suffix, peak, rate, elem) in rates.items():
        name = "resblock_bank" + suffix
        for (label, B, L, C, ks, dils), x32, params32 in bank_cases:
            x, params = x32.to(dt), [cast(p, dt) for p in params32]
            packed = resblock.pack_bank(params, ks, dils, dt)  # as GeneratorNSF caches it
            flops, nbytes = bank_flops_bytes(B, L, C, elem, elem, ks, dils)
            measure(name, label, lambda: resblock.resblock_bank(x, packed, ks, dils),
                    lambda: resblock.resblock_bank_plain(x, params, ks, dils),
                    bank_library(x, params, ks, dils), flops, nbytes, peak=peak,
                    depth=LARGE_DEPTH if B >= BANK_B64 else (10, 10))
            r = rows[name][label]
            r["bound_ms_f32_cuda_cores"] = bound_ms(flops, nbytes)[0]
            r["grid"] = gr = bank_grid(B, L, C, dt, ks, dils)
            log("timing", f"bank {label}{suffix} launch (C={C} on the kernel's {gr['width']}, k={ks}, d={dils}): "
                          f"{gr['warps']} warps of {gr['wm']} m16 tiles, {gr['rows']} "
                          f"conv rows and {gr['tile']} positions a block; {gr['blocks']} blocks a launch before the "
                          f"last ({gr['waves']:.2f} waves over {N_SMS} SMs), {gr['blocks'] // len(ks)} in the "
                          f"last ({gr['waves_last']:.2f}); {gr['smem_bytes']} B shared memory at "
                          f"d={max(dils)}; {gr['registers']} / {gr['registers_last']} registers, "
                          f"{gr['blocks_per_sm']} / {gr['blocks_per_sm_last']} blocks an SM; "
                          f"{gr['recomputed']:.1%} of the conv rows computed past the tiles")
            if trace and dt == torch.float32 and packed.width == C:  # a padded width adds the pad's copies
                calls = kernel_trace(lambda: resblock.resblock_bank(x, packed, ks, dils), len(dils))
                last = calls[-1]
                r["trace_us"] = last
                log("profile", f"bank {label}: {len(last)} kernels per call, span "
                               f"{last[-1][2] + last[-1][1]:.1f} us (last of {len(calls)} calls); each kernel "
                               "(d) " + ", ".join(f"({d}) {dur:.1f} us at +{t:.1f}" for d, (_, dur, t)
                                                  in zip(dils, last)))
        bank_rows = rows[name]
        for label, r in bank_rows.items():
            log("timing", f"bank level {label}{suffix}: kernel {r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
                          f"({r['ms'] / r['library_ms']:.2f}x cuDNN's time), eager one-call wrapper "
                          f"{r['eager_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms at {rate} TFLOP/s, "
                          f"{r['bound_ms_f32_cuda_cores']:.4f} ms at float32's 67 TFLOP/s")
        for tag, shapes in (("", BANK_SHAPES), (f" at {POOL_B} streams", BANK_SHAPES_BATCH),
                            (f" at {BANK_B64} streams", BANK_SHAPES_B64)):
            main_banks = [bank_rows[sh[0]] for sh in shapes]
            log("timing", f"bank{suffix} per step{tag} ({len(main_banks)} levels): kernel "
                          f"{sum(r['ms'] for r in main_banks):.4f} ms, eager "
                          f"{sum(r['eager_ms'] for r in main_banks):.4f} ms, plain "
                          f"{sum(r['plain_ms'] for r in main_banks):.4f} ms, cuDNN "
                          f"{sum(r['library_ms'] for r in main_banks):.4f} ms, bound "
                          f"{sum(r['bound_ms'] for r in main_banks):.4f} ms ({rate} TFLOP/s) / "
                          f"{sum(r['bound_ms_f32_cuda_cores'] for r in main_banks):.4f} ms (float32 CUDA cores)")
    htk, slaney = MelSpectrogram(device=dev), MelSpectrogram(f_min=0.0, htk=False, device=dev)
    for label, L, kind, mel in [(*m, htk) for m in MEL_SHAPES if m[0] in (MEL_MAIN, "offline")] + \
            [(*m, slaney) for m in FCPE_MEL_SHAPES if m[0] == FCPE_MEL_MAIN]:
        win, basis = mel.window, mel.mel_basis
        x = mel_inputs(L, kind, dev, rng)
        library = mel_library(x, win, basis)
        err = check_close(f"log_mel library composite {label}", library(), stft_mel.log_mel_plain(x, basis, win),
                          *MEL_BOUND)
        log("timing", f"log_mel {label}: the torch.stft composite agrees with the plain version "
                      f"(max abs err {err:.3e})")
        measure("log_mel", label, lambda: stft_mel.log_mel(x, mel.log_mel_basis, win),
                lambda: stft_mel.log_mel_plain(x, basis, win),
                library, *mel_flops_bytes(L, basis, mel.log_mel_basis))
    # the batched step's log-mel: one launch for the pool's streams
    for label, B, L, kind in [m for m in MEL_BATCH_SHAPES if m[0] == MEL_BATCH_MAIN]:
        win, basis = htk.window, htk.mel_basis
        x = mel_inputs(L, kind, dev, rng, B=B)
        library = mel_library(x, win, basis)
        check_close(f"log_mel library composite {label}", library(), stft_mel.log_mel_plain(x, basis, win),
                    *MEL_BOUND)
        measure("log_mel", label, lambda: stft_mel.log_mel(x, htk.log_mel_basis, win),
                lambda: stft_mel.log_mel_plain(x, basis, win),
                library, *mel_flops_bytes(L, basis, htk.log_mel_basis, B=B))
    report["timing"] = rows


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

#: the retrieval phase's table: ContentVec v2 features (C=768), 1M rows (the JAX package's BASELINE config 4
#: on one card), exact search and IVF at the default nlist rule with lists balanced to RETRIEVAL_LCAP rows
RETRIEVAL_N = 1_000_000
RETRIEVAL_C = 768
RETRIEVAL_LCAP = 64
RETRIEVAL_RATE = 0.75
#: the card's blend against the port's CPU blend on the same table and queries, TF32 off
RETRIEVAL_TOL = 1e-4
RETRIEVAL_RECALL_FLOOR = 0.9
#: chunks each step comparison streams, and the index rates of the batched step's streams
RETRIEVAL_CHUNKS = 6
RETRIEVAL_RATES = (0.0, 0.25, 0.5, 0.75, 1.0, 0.6, 0.9, 0.3)
#: rows of the .index and .onnx files the server and the CLI load (a cut of the table: their load is plumbing)
RETRIEVAL_DOOR_N = 65536


def retrieval_table(n, c, seed, nclust=1024, spread=0.7):
    """``scripts/ivf_recall.py``'s ``make_table``: cluster centres ~ N(0, I),
    rows = centre + ``spread`` · Student-t(4) noise, a tenth of the rows
    diffuse background (1.5 · t(4)). t(4) is drawn as z / sqrt(chi²₄ / 4),
    chi²₄ = 2 (e₁ + e₂) with e exponential (numpy's ``standard_t`` takes
    minutes at this size), in blocks of rows, each block from its own
    generator spawned from ``seed``, on a thread each (numpy draws without
    the interpreter lock)."""
    import concurrent.futures

    block = 65536
    root, children = np.random.SeedSequence(seed), None
    rng = np.random.default_rng(root)
    centers = rng.standard_normal((nclust, c), dtype=np.float32)
    which = rng.integers(0, nclust, n)
    background = rng.random(n) < 0.1
    table = np.empty((n, c), np.float32)
    children = root.spawn(-(-n // block))

    def fill(j):
        g = np.random.default_rng(children[j])
        s = j * block
        rows = min(block, n - s)
        z = g.standard_normal((rows, c), dtype=np.float32)
        e = g.standard_exponential((2, rows, c), dtype=np.float32)
        t4 = z / np.sqrt(0.5 * (e[0] + e[1]))
        bg = background[s : s + rows, None]
        table[s : s + rows] = np.where(bg, 1.5 * t4, centers[which[s : s + rows]] + spread * t4)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, range(len(children))))
    return table


def retrieval_queries(table, rng, chunks, frames, walk=0.1):
    """Chunks of correlated frames ``[chunks, frames, C]``: random walks from table rows, as consecutive 10 ms
    ContentVec frames are (``scripts/ivf_recall.py``'s ``make_queries``)."""
    starts = table[rng.integers(0, len(table), chunks)]
    steps = walk * rng.standard_normal((chunks, frames, table.shape[1]), dtype=np.float32)
    return (starts[:, None, :] + np.cumsum(steps, axis=1)).astype(np.float32)


def blend_bound_ms(B, T, N, C, itemsize, mode, nlist=0, lcap=0, probes=0):
    """The least time of one blend of ``B`` streams of ``T`` frames: the bytes it must move (exact: every row
    and norm once; ivf: the centroids, and each stream's probed slabs) over the HBM rate, against its products
    over the peak rate of their type (2·B·T·C a row searched, and a centroid scored; float32 without TF32,
    the exact search of a bfloat16 table as three bf16 products on the tensor cores)."""
    io = 2 * B * T * C * 4  # the features in and the blend out
    if mode == "exact":
        nbytes, flops = N * (C * itemsize + 4) + io, 2.0 * B * T * N * C
        t_ops = flops * (3 / BF16_PEAK_FLOPS if itemsize == 2 else 1 / F32_PEAK_FLOPS)
    else:
        rows = B * probes * lcap
        nbytes = nlist * (C * 4 + 4) + rows * (C * itemsize + 4) + io
        t_ops = 2.0 * B * T * C * (nlist + probes * lcap) / F32_PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_retrieval(report, smi):
    """Retrieval at full width (ROADMAP item 12): a 1M x 768 table from the seed, searched exactly (float32 and
    bfloat16 rows) and by IVF (the quantizer trained on the card at the default nlist, lists balanced to
    RETRIEVAL_LCAP); each blend on the card held to the port's CPU blend on the same table and queries
    (RETRIEVAL_TOL, TF32 off); IVF's recall@8 against exact on correlated chunks (>= RETRIEVAL_RECALL_FLOOR);
    the blend timed alone by CUDA events at 1 and POOL_B streams. Then the full-width step with the exact
    float32 table at index_rate RETRIEVAL_RATE, in each dtype: eager against jit_step and staged_step
    (bfloat16 bit for bit; float32 within the float32 bound), the hand kernels
    counted, step p50 with and without the index, jit_step_batch of POOL_B streams each at its own rate, and
    peak memory at 1 and POOL_B streams; in float32 the batched streams against their one-stream steps (1e-3),
    in bfloat16 a StreamPool of POOL_B slots against the batched step (POOL_SLOT_TOL). Last, a server with
    --index <file>.index --index-mode ivf serves a duplex session with no error, and serve.cli converts a WAV
    file with --index <file>.onnx."""
    import dataclasses

    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.models.onnx_reader import write_onnx_weights
    from obs_rvc_tpu_torch.retrieval import IvfFlatIndex, RetrievalIndex, train_ivf
    from obs_rvc_tpu_torch.retrieval.build import default_nlist
    from obs_rvc_tpu_torch.retrieval.faiss_reader import write_ivf_flat
    from obs_rvc_tpu_torch.retrieval.index import ivf_search, table_products
    from obs_rvc_tpu_torch.serve import cli
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls
    from obs_rvc_tpu_torch.utils import read_wav, write_wav

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("retrieval: TF32 is on; the float32 comparisons need it off")
    dev = torch.device("cuda")
    cfg = ChunkConfig.build()
    T, N, C, K = cfg.return_length, RETRIEVAL_N, RETRIEVAL_C, 8
    t_phase = time.perf_counter()
    out = report["retrieval"] = {"n": N, "c": C, "t": T, "k": K, "nvidia_smi": smi, "mm_out_dtype": True}
    t0 = time.perf_counter()
    table = retrieval_table(N, C, SEED + 60)
    queries = retrieval_queries(table, np.random.default_rng(SEED + 61), POOL_B, T)
    out["table_s"] = time.perf_counter() - t0
    log("retrieval", f"table {N} x {C} float32 from seed {SEED + 60} in {out['table_s']:.1f} s (clustered, "
                     f"Student-t(4) noise, 10 % background rows); {POOL_B} correlated query chunks of {T} frames")

    def blend_fn(idx, q, rate):
        return lambda: idx.blend(q, rate)

    def compare(name, idx_card, idx_cpu):
        """The blend of one chunk and of POOL_B on the card against the CPU's; returns the max abs errors."""
        errs = {}
        for B in (1, POOL_B):
            q = torch.from_numpy(queries[:B])
            rate = torch.full((B,), RETRIEVAL_RATE)
            want = idx_cpu.blend(q, rate)
            got = idx_card.blend(q.to(dev), rate.to(dev)).cpu()
            errs[B] = check_close(f"retrieval {name} B={B} card vs cpu", got, want, RETRIEVAL_TOL, 0.0)
            if float((got - q).abs().max()) < 1e-3:
                raise AssertionError(f"retrieval {name}: the blend left the features as they were")
        return errs

    def timed(name, idx, mode, itemsize):
        rows = {}
        for B in (1, POOL_B):
            q = torch.from_numpy(queries[:B]).to(dev)
            rate = torch.full((B,), RETRIEVAL_RATE, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = graph_ms(blend_fn(idx, q, rate), calls=3, replays=5)
            nlist = 0 if idx.centroids is None else len(idx.centroids)
            bound, by = blend_bound_ms(B, T, N, C, itemsize, mode, nlist, idx.lcap or 0, max(64, T))
            rows[B] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                       "work_bytes": int(torch.cuda.max_memory_allocated() - base)}
        log("retrieval", f"{name} blend alone (CUDA events, a graph of its calls): "
                         + "; ".join(f"B={B} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                                     f"{r['work_bytes'] / 2**20:.0f} MiB working memory)" for B, r in rows.items())
                         + f" [{smi}]")
        return rows

    # 1. exact search, float32 and bfloat16 rows
    exact = {}
    for dtype in ("float32", "bfloat16"):
        params = RetrievalIndex.make_params(table, dtype=getattr(torch, dtype))
        card, cpu = RetrievalIndex().load(params, dev), RetrievalIndex().load(params, "cpu")
        scores = table_products(torch.from_numpy(queries[0, :2]).to(dev), card.vectors)
        if scores.dtype != torch.float32:
            raise AssertionError(f"retrieval: a {dtype} table's scores came back in {scores.dtype}")
        errs = compare(f"exact {dtype}", card, cpu)
        exact[dtype] = {"max_abs_err": errs,
                        "timing": timed(f"exact {dtype}", card, "exact", card.vectors.element_size())}
        # where one stream's exact blend spends its time: the products alone, the top-k alone
        q = torch.from_numpy(queries[0]).to(dev)
        neg = table_products(q, card.vectors)
        exact[dtype]["products_ms"] = graph_ms(lambda: table_products(q, card.vectors), calls=3, replays=5)
        exact[dtype]["topk_ms"] = graph_ms(lambda: torch.topk(neg, K, dim=-1), calls=3, replays=5)
        log("retrieval", f"exact {dtype}, one stream: the [{T}, {C}] x [{C}, {N}] products alone "
                         f"{exact[dtype]['products_ms']:.4f} ms, torch.topk of [{T}, {N}] alone "
                         f"{exact[dtype]['topk_ms']:.4f} ms [{smi}]")
        log("retrieval", f"exact {dtype} rows: the card's blend against the CPU's, max abs err "
                         + ", ".join(f"B={B} {e:.3e}" for B, e in errs.items()) + f" (bound {RETRIEVAL_TOL}); "
                         f"scores {scores.dtype}")
        if dtype == "float32":
            exact_index = card
        del card, cpu, params, neg
    out["exact"] = exact
    torch.cuda.empty_cache()

    # 2. IVF: the quantizer on the card, lists balanced on the host
    t0 = time.perf_counter()
    cent, assign = train_ivf(table, device=dev)
    out["train_ivf_s"] = time.perf_counter() - t0
    ivf = RetrievalIndex(mode="ivf")
    t0 = time.perf_counter()
    params = ivf.make_ivf_params(IvfFlatIndex(table, cent, assign), lcap=RETRIEVAL_LCAP)
    out["balance_s"] = time.perf_counter() - t0
    counts = np.bincount(assign, minlength=len(cent))
    out.update(nlist=int(len(cent)), nlist_balanced=int(len(params["lengths"])), longest_list=int(counts.max()))
    log("retrieval", f"train_ivf on the card: nlist {len(cent)} (default_nlist({N}) = {default_nlist(N)}), 10 "
                     f"iterations in {out['train_ivf_s']:.1f} s, longest list {counts.max()} rows; make_ivf_params "
                     f"(balance_lists at lcap {RETRIEVAL_LCAP}, host) in {out['balance_s']:.1f} s -> "
                     f"{out['nlist_balanced']} lists")
    ivf.load(params, dev)
    ivf_cpu = RetrievalIndex(mode="ivf").load(params, "cpu")
    # recall@8 against exact search on the float32 table, each chunk its own union (probes = max(64, T))
    truth = torch.topk(table_products(torch.from_numpy(queries).to(dev).flatten(0, 1), exact_index.vectors)
                       .mul_(2.0).sub_(exact_index.norms), K).indices.cpu().numpy()
    _, _, rows = ivf_search(ivf.vectors, ivf.norms, ivf.lengths, ivf.offsets, ivf.centroids, ivf.cnorms,
                            torch.from_numpy(queries).to(dev), k=K, probes=max(64, T), lcap=ivf.lcap)
    found = ivf.row_order[rows.flatten(0, 1).cpu().numpy()]
    recall = float(np.mean([len(set(f) & set(t)) / K for f, t in zip(found, truth)]))
    out["recall_at_8"] = recall
    log("retrieval", f"IVF recall@8 against exact over {POOL_B} correlated chunks of {T} frames (probes "
                     f"{max(64, T)}, lcap {ivf.lcap}): {recall:.4f} (floor {RETRIEVAL_RECALL_FLOOR}) [{smi}]")
    if recall < RETRIEVAL_RECALL_FLOOR:
        raise AssertionError(f"retrieval: IVF recall@8 {recall:.4f} below {RETRIEVAL_RECALL_FLOOR}")
    out["ivf"] = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            p16 = dict(params, vectors=params["vectors"].to(torch.bfloat16))
            ivf, ivf_cpu = RetrievalIndex(mode="ivf").load(p16, dev), RetrievalIndex(mode="ivf").load(p16, "cpu")
        errs = compare(f"ivf {dtype}", ivf, ivf_cpu)
        out["ivf"][dtype] = {"max_abs_err": errs,
                             "timing": timed(f"ivf {dtype}", ivf, "ivf", ivf.vectors.element_size())}
        log("retrieval", f"ivf {dtype} rows: the card's blend against the CPU's, max abs err "
                         + ", ".join(f"B={B} {e:.3e}" for B, e in errs.items()) + f" (bound {RETRIEVAL_TOL})")
    del ivf, ivf_cpu, params
    torch.cuda.empty_cache()

    # 3. the full-width step with the exact float32 table
    chunks = [c[0] for c in pool_streams(cfg, 1, RETRIEVAL_CHUNKS, dev)[1]]
    controls = StepControls.default(index_rate=RETRIEVAL_RATE)
    wavs, bchunks, bcontrols = pool_streams(cfg, POOL_B, RETRIEVAL_CHUNKS, dev)
    bcontrols = [dataclasses.replace(c, index_rate=r) for c, r in zip(bcontrols, RETRIEVAL_RATES)]
    stacked = StepControls.stack(bcontrols, dev)
    out["step"] = {}
    for dtype in ("float32", "bfloat16"):
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype), retrieval_index=exact_index)
        pipe.init_params(SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        res = out["step"][dtype] = {}
        torch.cuda.synchronize()
        reset_launches()
        eager, _ = stream(pipe.step, pipe, chunks, controls)
        launches = read_launches()
        check_launches("retrieval step", launches, RETRIEVAL_CHUNKS)
        torch.cuda.reset_peak_memory_stats()
        fused, times = stream(pipe.jit_step, pipe, chunks, controls, timed=True)
        res["peak_mem_bytes_b1"] = int(torch.cuda.max_memory_allocated())
        staged, _ = stream(pipe.staged_step, pipe, chunks, controls)
        tol = 0.0 if dtype == "bfloat16" else CPU_TOL["emitted"]
        res["fused_vs_eager"] = check_same(f"retrieval {dtype} jit_step vs eager", fused, eager, tol)
        res["staged_vs_eager"] = check_same(f"retrieval {dtype} staged_step vs eager", staged, eager, tol)
        plain = pipe.with_config(cfg)  # the same networks, graphs of its own, no index
        plain.retrieval_index = None
        plain.jit_step.capture()
        _, plain_times = stream(plain.jit_step, plain, chunks, StepControls.default(), timed=True)
        _, times = stream(pipe.jit_step, pipe, chunks, controls, timed=True)
        res.update(launches=launches, step_p50_ms=float(np.median(times[1:])),
                   step_p50_ms_without_index=float(np.median(plain_times[1:])))
        log("retrieval", f"{dtype} step with the exact 1M float32 index at index_rate {RETRIEVAL_RATE}: kernel "
                         f"launches {launches} over {RETRIEVAL_CHUNKS} eager steps; jit_step and staged_step vs "
                         f"eager bit-identical {res['fused_vs_eager'][0]}/{res['staged_vs_eager'][0]} (rel "
                         f"{res['fused_vs_eager'][1]:.2e}/{res['staged_vs_eager'][1]:.2e}, bound {tol}); fused "
                         f"graph step p50 {res['step_p50_ms']:.2f} ms with the index, "
                         f"{res['step_p50_ms_without_index']:.2f} ms without; peak device memory "
                         f"{res['peak_mem_bytes_b1'] / 2**20:.0f} MiB at one stream [{smi}]")
        torch.cuda.reset_peak_memory_stats()
        batched, btimes = stream_batch(pipe.jit_step_batch, pipe, bchunks, stacked, timed=True)
        res.update(peak_mem_bytes_b8=int(torch.cuda.max_memory_allocated()),
                   batch_p50_ms=float(np.median(btimes[1:])))
        if dtype == "float32":  # the batched rule of float32: each stream within 1e-3 of its one-stream steps
            singles = [stream(pipe.jit_step, pipe, [c[k] for c in bchunks], bcontrols[k])[0] for k in range(POOL_B)]
            rels = [check_same(f"retrieval batch stream {k}", batched[k], singles[k], CPU_TOL["emitted"])[1]
                    for k in range(POOL_B)]
            res["batch_rel"] = rels
            held = ("against their one-stream jit_step runs: max|diff| / max|audio| "
                    + ", ".join(f"{r:.2e}" for r in rels) + f" (bound {CPU_TOL['emitted']})")
        else:  # the pool's rule, in the server's dtype: each slot against its row of the batched step
            pooled, _ = pool_run(pipe, wavs, bcontrols, mode="fused")
            slots = same_slots("retrieval pool", pooled, batched)
            res["pool_slots_rel"] = [r for _, r in slots]
            held = ("a StreamPool of 8 slots (fused) against it: max|diff| / max|audio| "
                    + ", ".join(f"{r:.1e}" for _, r in slots) + f" (bound {POOL_SLOT_TOL})")
        log("retrieval", f"{dtype} jit_step_batch of {POOL_B} voices at index rates {RETRIEVAL_RATES}: step p50 "
                         f"{res['batch_p50_ms']:.2f} ms, peak device memory {res['peak_mem_bytes_b8'] / 2**20:.0f} "
                         f"MiB; {held} [{smi}]")
        del pipe, plain
        torch.cuda.empty_cache()

    # 4. the front doors: a server with an .index in ivf mode, the CLI with an .onnx, on a cut of the table
    OUT_DIR.mkdir(exist_ok=True)
    door = table[:RETRIEVAL_DOOR_N]
    dcent, dassign = train_ivf(door, device=dev)
    write_ivf_flat(OUT_DIR / "door.index", door, centroids=dcent, assignments=dassign)
    write_onnx_weights(OUT_DIR / "door.onnx", {"vectors": door})
    host, chunk = "127.0.0.1", cfg.sample_frame_size
    argv = server_argv(host, ["--index", str(OUT_DIR / "door.index"), "--index-mode", "ivf",
                              "--index-rate", str(RETRIEVAL_RATE)])
    with Server(argv) as srv:
        url = f"http://{host}:{srv.bound['health']}/metrics"
        wav = voiced_signal((PITCH_SERVE_CHUNKS + 2) * chunk, cfg.sample_rate, seed=SEED + 61)
        streamed = duplex_session(host, srv.bound["duplex"], wav, PITCH_SERVE_CHUNKS, chunk, cfg.sample_rate)
        metrics = wait_metrics_settled(url)
        if metrics["chunks"] < PITCH_SERVE_CHUNKS or metrics["errors"] != 0:
            raise AssertionError(f"retrieval server: /metrics counts {metrics['chunks']} chunks and "
                                 f"{metrics['errors']} errors")
        out["server"] = {"startup_s": srv.startup_s, "metrics": metrics}
        log("retrieval", f"server --index door.index ({RETRIEVAL_DOOR_N} rows) --index-mode ivf --index-rate "
                         f"{RETRIEVAL_RATE} (bfloat16, staged graphs) listening in {srv.startup_s:.1f} s; duplex: "
                         f"{streamed.size} samples back, all finite; /metrics {metrics}")
    src, dst = OUT_DIR / "retrieval_in.wav", OUT_DIR / "retrieval_out.wav"
    write_wav(src, voiced_signal(5 * chunk, cfg.sample_rate, seed=SEED + 62), cfg.sample_rate)
    t0 = time.perf_counter()
    cli.main([str(src), str(dst), "--index", str(OUT_DIR / "door.onnx"), "--index-rate", str(RETRIEVAL_RATE)])
    converted, sr = read_wav(dst)
    out["cli_s"] = time.perf_counter() - t0
    if sr != cfg.sample_rate or converted.shape != (1, 5 * chunk) or not np.isfinite(converted).all() or \
            float(np.abs(converted).max()) < 1e-3:
        raise AssertionError(f"serve.cli --index door.onnx wrote {converted.shape} at {sr} Hz, or silence")
    log("retrieval", f"cli --index door.onnx --index-rate {RETRIEVAL_RATE} (float32): {converted.shape[1]} samples "
                     f"in {out['cli_s']:.1f} s, max |y| {float(np.abs(converted).max()):.4f}")
    for f in ("door.index", "door.onnx"):
        (OUT_DIR / f).unlink()
    out["phase_s"] = time.perf_counter() - t_phase
    log("retrieval", f"the retrieval phase ran {out['phase_s']:.1f} s")
    return table, queries


# ---------------------------------------------------------------------------
# the bfloat16 stage graphs captured again and again (a fault seen once)
# ---------------------------------------------------------------------------

#: captures of the bfloat16 stage graphs, each forced by loading the weights again, and the chunks each streams
#: (few: with cuDNN's API log on, the eager steps' log runs to hundreds of MiB, and the whole run must stay within
#: 700 s)
STAGE_REPEATS = 4
STAGE_REPEAT_CHUNKS = 8
#: the cuDNN API log's lines kept in the output directory for reading, at most
CUDNN_LOG_SAMPLE = 400


def _leaf_outputs(pipe, state, chunk, controls):
    """Every leaf module's output (its first tensor) in one eager step, by
    module name, on the CPU: which operator's result moves between threads."""
    import torch

    outs, hooks = {}, []
    for net, module in pipe.modules().items():
        for name, m in module.named_modules():
            if not list(m.children()):
                def hook(_m, _inp, out, key=f"{net}.{name}"):
                    t = out[0] if isinstance(out, tuple) else out
                    if isinstance(t, torch.Tensor):
                        outs[key] = t.detach().float().cpu()
                hooks.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad():
            _, emitted = pipe.step(state, chunk, controls)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    outs["emitted"] = emitted.float().cpu()
    return outs


def stage_repeat_child(out_path: str, log_path: str) -> None:
    """The child of :func:`phase_stage_repeat`, with cuDNN's API log on: the
    bfloat16 pipeline at full width with RMVPE, one eager stream of the
    voiced signal, then ``STAGE_REPEATS`` captures of the stage graphs, each
    forced by loading the same weights again, each stream held to the eager
    one; per capture, every leaf module's output of an eager step run on the
    graphs' capture thread against the main thread's, and the cuDNN log's
    engine lines of the capture. Writes a JSON summary to ``out_path``."""
    import collections
    import re

    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.ops import _cuda
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, graphs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    cfg = ChunkConfig.build()
    pipe = RvcPipeline(cfg, compute_dtype=torch.bfloat16)
    pipe.init_params(SEED, std=None)
    cast_params_for_serving(pipe)
    saved = {name: {k: v.clone() for k, v in m.state_dict().items()} for name, m in pipe.modules().items()}
    n = cfg.sample_frame_size
    wav = torch.from_numpy(voiced_signal(STAGE_REPEAT_CHUNKS * n, cfg.sample_rate))
    chunks = [wav[i * n : (i + 1) * n].to(pipe.device) for i in range(STAGE_REPEAT_CHUNKS)]
    controls = StepControls.default()
    # the eager stream, and the state half-way through it: one step's leaf outputs from there, main thread
    state, outs, half = pipe.new_state(), [], STAGE_REPEAT_CHUNKS // 2
    with torch.no_grad():
        for i, c in enumerate(chunks):
            if i == half:
                probe_state = state
            state, out = pipe.step(state, c, controls)
            outs.append(out)
    eager = torch.cat(outs).cpu()
    state, probe = probe_state, chunks[half]
    main_leaves = _leaf_outputs(pipe, state, probe, controls)

    def log_size():
        return pathlib.Path(log_path).stat().st_size if pathlib.Path(log_path).exists() else 0

    marks, runs = [log_size()], []
    for i in range(STAGE_REPEATS):
        for name, m in pipe.modules().items():
            m.load_state_dict(saved[name])  # the same values: the graphs see new weights and capture again
        before = pipe.staged_graphs.captures
        got, _ = stream(pipe.staged_step, pipe, chunks, controls)
        torch.cuda.synchronize()
        marks.append(log_size())
        rel = float((got - eager).abs().max()) / max(float(eager.abs().max()), 1e-12)
        on_thread = graphs._capture_thread().submit(_leaf_outputs, pipe, state, probe, controls).result()
        moved = sorted(k for k, v in on_thread.items() if not torch.equal(v, main_leaves[k]))
        runs.append({"recaptured": pipe.staged_graphs.captures > before, "bit_identical": bool(torch.equal(got, eager)),
                     "rel_max_err": rel, "leaves_moved_on_capture_thread": moved[:20], "leaves": len(on_thread)})
        print(f"[stage_repeat] capture {i + 1}: " + ("bit-identical to eager" if runs[-1]["bit_identical"] else
                                                    f"{rel:.3e} of max|eager|")
              + f"; on the capture thread {len(moved)} of {len(on_thread)} leaf outputs differ from the main thread's",
              flush=True)

    # the cuDNN API log, cut at each capture's end: its engine lines by capture
    engines, sample = [], []
    pattern = re.compile(r"(engine|ENGINE|globalIndex|GLOBAL_INDEX|knob|KNOB)")
    if pathlib.Path(log_path).exists():
        with open(log_path, "rb") as f:
            for i in range(STAGE_REPEATS):
                f.seek(marks[i])
                text = f.read(marks[i + 1] - marks[i]).decode("utf-8", "replace")
                lines = [re.sub(r"\d+:\d+:\d+\.\d+|0x[0-9a-f]+|Time: .*|pid=\d+|tid=\d+", "", ln).strip()
                         for ln in text.splitlines() if pattern.search(ln)]
                engines.append(collections.Counter(lines))
                if i == 0:
                    sample = text.splitlines()[:CUDNN_LOG_SAMPLE]
    # the first capture is the capture thread's first cuDNN work: its segment holds the heuristic
    # queries of every convolution, which the thread's plan cache answers in the later ones
    later = engines[1:]
    summary = {"runs": runs, "log_bytes": marks[-1], "log_marks": marks,
               "engine_lines_per_capture": [sum(c.values()) for c in engines],
               "distinct_engine_lines_per_capture": [len(c) for c in engines],
               "engine_lines_same_after_the_first": all(c == later[0] for c in later[1:]) if later else None,
               "engine_lines_differing_after_the_first": sorted({ln for c in later for ln in c
                                                                 if any(d.get(ln) != c.get(ln) for d in later)})[:40]}
    pathlib.Path(out_path).write_text(json.dumps(summary, indent=1))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "cudnn_log_sample.txt").write_text("\n".join(sample))


def phase_stage_repeat(report):
    """A fault seen once in an earlier run: the bfloat16 stage graphs
    1.279e-2 of max|audio| off the eager step. A child process with cuDNN's
    API log on (``CUDNN_LOGLEVEL_DBG=3``, set before cuDNN loads) captures
    them ``STAGE_REPEATS`` times (:func:`stage_repeat_child`); every capture
    must be within the float32 bound of the emitted audio, as in
    :func:`phase_graphs`, and how many are bit for bit is reported with any
    leaf output that differs on the capture thread and any change in the
    engine lines of cuDNN's log from one capture to the next."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out_path, log_path = pathlib.Path(tmp) / "repeat.json", pathlib.Path(tmp) / "cudnn.log"
        env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3", CUDNN_LOGDEST_DBG=str(log_path))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--stage-repeat-child",
                               str(out_path), str(log_path)], env=env, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            if line.startswith("[stage_repeat]"):
                print(line, flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"stage_repeat: the child exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        summary = json.loads(out_path.read_text())
    summary["phase_s"] = time.perf_counter() - t0
    report["stage_repeat"] = summary
    runs = summary["runs"]
    bit = sum(r["bit_identical"] for r in runs)
    moved = sorted({k for r in runs for k in r["leaves_moved_on_capture_thread"]})
    log("stage_repeat", f"{len(runs)} captures of the bfloat16 stage graphs (each forced by loading the weights "
                        f"again), {STAGE_REPEAT_CHUNKS} chunks each: {bit} bit-identical to the eager stream, max "
                        f"error {max(r['rel_max_err'] for r in runs):.3e} of max|eager| (bound {CPU_TOL['emitted']}); "
                        f"leaf outputs that differ on the capture thread: {moved or 'none'}; cuDNN API log "
                        f"{summary['log_bytes'] / 2**20:.1f} MiB, engine lines per capture "
                        f"{summary['engine_lines_per_capture']} (the first holds the capture thread's heuristic "
                        f"queries), the same in every later capture: {summary['engine_lines_same_after_the_first']} "
                        f"({summary['phase_s']:.1f} s)")
    if summary["engine_lines_same_after_the_first"] is False:
        log("stage_repeat", "cuDNN engine lines that moved between captures: "
                            + "; ".join(summary["engine_lines_differing_after_the_first"]))
    if not all(r["recaptured"] for r in runs):
        raise AssertionError(f"stage_repeat: a weight load did not recapture the stage graphs: {runs}")
    bad = [i for i, r in enumerate(runs) if r["rel_max_err"] > CPU_TOL["emitted"]]
    if bad:
        raise AssertionError(f"stage_repeat: captures {bad} are off the eager stream by more than "
                             f"{CPU_TOL['emitted']}: {[runs[i]['rel_max_err'] for i in bad]}; moved: {moved}")


# ---------------------------------------------------------------------------
# the benchmark entry point
# ---------------------------------------------------------------------------

#: scripts/torch_bench.py's runs in the bench phase, each in a process of its own at PyTorch's TF32
#: defaults: RMVPE, bfloat16, full width; (label, arguments)
BENCH_RUNS = [("b1-fused-profiled", ["--batch", "1", "--mode", "fused", "--profile", str(OUT_DIR / "bench_trace")]),
              ("b1-staged", ["--batch", "1", "--mode", "staged"]),
              ("b8-fused", ["--batch", "8", "--mode", "fused"])]
#: the keys of the bench line's ``extra`` that every run must print, and the numbers among them
BENCH_EXTRA_KEYS = ("p95_ms", "sustained_ms_per_chunk", "rtf", "audio_seconds_per_second", "mfu",
                    "model_gflops_per_chunk", "batch", "mode", "pitch_algorithm", "dtype", "chunk_ms", "backend",
                    "device_name", "power_limit_w", "cudnn_tf32", "matmul_tf32", "stage_device_ms",
                    "stage_device_ms_sum")
BENCH_NUMBERS = ("p95_ms", "sustained_ms_per_chunk", "rtf", "audio_seconds_per_second", "mfu",
                 "model_gflops_per_chunk", "chunk_ms", "power_limit_w", "stage_device_ms_sum")
BENCH_STAGES = ("pre", "features", "mel", "salience", "pitch_post", "synth", "post")
#: a chunk must be converted within its own 300 ms to keep up (PERF.md section 2)
BENCH_LIMIT_MS = 300.0


def run_bench(label, argv):
    """One run of ``scripts/torch_bench.py`` (RMVPE, bfloat16) in a child
    process; its JSON line, checked: every key, finite numbers, the seven
    stages' device times, p50 under the real-time limit."""
    script = pathlib.Path(__file__).resolve().parent / "scripts" / "torch_bench.py"
    proc = subprocess.run([sys.executable, str(script), "--dtype", "bfloat16", "--pitch-algorithm", "rmvpe", *argv],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"bench {label}: exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    extra = line.get("extra", {})
    missing = [k for k in ("metric", "value", "unit", "vs_baseline") if k not in line] + \
        [k for k in BENCH_EXTRA_KEYS if k not in extra]
    if missing or line["metric"] != "chunk_p50_ms" or extra["backend"] != "cuda":
        raise AssertionError(f"bench {label}: keys missing {missing}, or not a card's chunk_p50_ms line: {line}")
    stages = extra["stage_device_ms"]
    numbers = [line["value"], line["vs_baseline"], *(extra[k] for k in BENCH_NUMBERS), *stages.values()]
    if tuple(stages) != BENCH_STAGES or not all(isinstance(v, (int, float)) and np.isfinite(v) for v in numbers):
        raise AssertionError(f"bench {label}: stages {list(stages)} or a number not finite: {line}")
    if line["value"] >= BENCH_LIMIT_MS:
        raise AssertionError(f"bench {label}: p50 {line['value']:.3f} ms, not under {BENCH_LIMIT_MS} ms")
    return line, proc.stderr


def phase_bench(report):
    """``scripts/torch_bench.py`` at full width (RMVPE, bfloat16): one
    stream fused with ``--profile``, whose trace must hold 1 log-mel, 32
    chain and 6 bank kernels a step; one stream staged; 8 streams fused.
    Each line is checked by :func:`run_bench` and logged beside the main
    phase's bfloat16 ``jit_step`` (TF32 off there, and in this process: the
    two are not held to each other)."""
    t_phase = time.perf_counter()
    out = {}
    for label, argv in BENCH_RUNS:
        line, err = run_bench(label, argv)
        prof = line["extra"].get("profile")
        if prof is not None:
            want = {k: v * prof["traced_steps"] for k, v in kernels_per_step().items()}
            counts = prof["kernels_in_trace"]
            if counts != want and all(counts[k] <= v for k, v in want.items()):
                log("bench", f"{label}: the trace shows {counts} hand kernels, fewer than the steps launch ({want}): "
                             "the tracer lost device records; run again")
                line, err = run_bench(label, argv)
                prof = line["extra"]["profile"]
                counts = prof["kernels_in_trace"]
            if counts != want:
                raise AssertionError(f"bench {label}: the trace of {prof['traced_steps']} steps shows {counts} hand "
                                     f"kernel launches, want {want}")
        x = line["extra"]
        out[label] = {"line": line, "stderr": err.splitlines()[-20:]}
        log("bench", f"{label}: p50 {line['value']:.3f} ms, p95 {x['p95_ms']:.3f}, sustained "
                     f"{x['sustained_ms_per_chunk']:.3f} ms a step of {x['batch']} stream(s), "
                     f"{x['audio_seconds_per_second']:.1f} audio-s/s, MFU {x['mfu']:.2%}; stage device ms "
                     + ", ".join(f"{k} {v:.3f}" for k, v in x["stage_device_ms"].items())
                     + f" (sum {x['stage_device_ms_sum']:.3f}); capture {x['capture_s']:.2f} s, peak memory "
                     f"{x['peak_memory_mib']:.1f} MiB; TF32 cuDNN {x['cudnn_tf32']}, matmul {x['matmul_tf32']}"
                     + (f"; device busy {prof['device_busy_ms_per_step']:.3f} ms a step "
                        f"({prof['busy_share']:.1%}), hand kernels {prof['kernels_in_trace']} in "
                        f"{prof['traced_steps']} steps" if prof else ""))
    fused = report.get("main_bf16", {}).get("graphs", {}).get("fused")
    if fused:
        b1 = out["b1-fused-profiled"]["line"]
        log("bench", f"beside the main phase's bfloat16 jit_step in this process (TF32 off): p50 "
                     f"{fused['step_p50_ms']:.3f} ms, device busy {fused['device_busy_ms_per_step']:.3f} ms a step; "
                     f"the bench's (its own process, PyTorch's TF32 defaults, profiled): p50 {b1['value']:.3f} ms, "
                     f"sustained {b1['extra']['sustained_ms_per_chunk']:.3f} ms")
    out["phase_s"] = time.perf_counter() - t_phase
    report["bench"] = out
    log("bench", f"the bench phase ran {out['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# the mesh: streams split along data, ContentVec and the exact table along model
# ---------------------------------------------------------------------------

#: the mesh phase's pool mesh: data rows x model shards, all on the one card
MESH_DATA, MESH_MODEL = 2, 2
#: the dry run's device count (the card named this many times)
MESH_DRYRUN_DEVICES = 8
#: the TP ContentVec's bound against the unsharded network (the JAX mesh tests')
MESH_TP_TOL = 2e-4
#: chunks the distributed workers' parent compares, and each worker's time limit
MESH_DIST_TIMEOUT_S = 300


def trace_pool_ticks(pipe, wavs, controls, want, ticks=5, **pool_kw):
    """A pool of ``len(wavs)`` slots, every slot fed each tick: the hand
    kernels in a trace of ``ticks`` ticks after one untraced, and the
    device's busy ms a tick; traced once more if the tracer lost records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from obs_rvc_tpu_torch.stream import StreamPool

    n = pipe.cfg.sample_frame_size
    pool = StreamPool(pipe, capacity=len(wavs), **pool_kw)
    pool.prepare()
    slots = [pool.attach(c) for c in controls]
    fed = [0]

    def tick():
        i = fed[0] % (wavs.shape[1] // n)
        for k, s in enumerate(slots):
            pool.push_audio(s, wavs[k, i * n : (i + 1) * n])
            pool.pull_audio(s, n)
        fed[0] += 1
        pool.process_pending()

    def trace():
        tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tick()
            mark_trace()
            for _ in range(ticks):
                tick()
            torch.cuda.synchronize()
        events = events_after_mark(prof)
        return kernel_counts(events), device_busy_ms(events) / ticks

    with torch.no_grad():
        counts, busy = trace()
        retraced = counts != want and all(counts[k] <= v for k, v in want.items())
        if retraced:
            counts, busy = trace()
    pool.stop()
    return counts, busy, retraced


def segmented_vs_eager(name, rows, mesh, cfg, chunks, stacked, device):
    """Each row's graphed step (``jit_step_batch``: ``pre``, the features'
    per-device segments, ``after_features``) against the eager row step
    (``step_rows``) from zeroed states over ``chunks`` (cuDNN on its
    deterministic engines, as every pipeline on a card holds it); returns
    ``check_same``'s (bit-identical, relative max error) and the segments a
    row's graph holds."""
    import torch

    from obs_rvc_tpu_torch.parallel import shard_controls, shard_state
    from obs_rvc_tpu_torch.parallel.sharding import gather_rows, step_rows
    from obs_rvc_tpu_torch.stream import StreamState
    from obs_rvc_tpu_torch.stream.graphs import SegmentedFunction

    outs = {}
    for graphed in (False, True):
        states = shard_state(StreamState.init_batch(cfg, len(stacked.sid), device=device), mesh)
        got = []
        with torch.no_grad():
            for c in chunks:
                states, o = step_rows(rows, states, shard_state(c, mesh), shard_controls(stacked, mesh),
                                      graphed=graphed)
                got.append(gather_rows(o, device))
        outs[graphed] = torch.cat(got, dim=1)
    graph = rows[0].batch_graph(len(stacked.sid) // len(rows)).graph
    if not isinstance(graph, SegmentedFunction):
        raise AssertionError(f"{name}: the row's graph is a {type(graph).__name__}, not per-device segments")
    return check_same(name, outs[True], outs[False], CPU_TOL["emitted"]), len(graph.segments)


def cross_card_kernels(cards):
    """The three kernels' wrappers on tensors of the second card while the
    first is current, at the main path's shapes, against their plain
    versions there (the chain and the bank in both dtypes); the first card
    must be current again after each call. Returns each check's max abs error."""
    import torch

    from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram
    from obs_rvc_tpu_torch.ops import resblock, stft_mel, unet_block

    dev = cards[1]
    rng = np.random.default_rng(SEED + 80)
    out = {}
    with torch.cuda.device(cards[0]):
        mel = MelSpectrogram(device=dev)
        x = mel_inputs(10080, "voiced", dev, rng)
        got = stft_mel.log_mel(x, mel.log_mel_basis, mel.window)
        out["log_mel float32"] = check_close(f"log_mel on {dev}", got, stft_mel.log_mel_plain(x, mel.mel_basis,
                                                                                             mel.window), *MEL_BOUND)
        label, B, H, W, cin, C = CHAIN_SHAPES[1]
        x, blocks = chain_inputs(label, B, H, W, cin, C, dev, rng)
        for dt in (torch.float32, torch.bfloat16):
            got = unet_block.conv_block_res_chain(x.to(dt), unet_block.pack_chain(blocks, dt))
            want = unet_block.conv_block_res_chain_plain(x.to(dt), blocks)
            out[f"conv_block_res_chain {str(dt)[6:]}"] = check_close(f"chain {label} on {dev} {dt}", got, want,
                                                                     *CHAIN_BOUNDS[str(dt)[6:]])
        label, B, L, C = BANK_SHAPES[0]
        x, params = bank_inputs(label, B, L, C, dev, rng)
        for dt in (torch.float32, torch.bfloat16):
            got = resblock.resblock_bank(x.to(dt), resblock.pack_bank(params, BANK_KS, BANK_DILS, dt), BANK_KS,
                                         BANK_DILS)
            want = resblock.resblock_bank_plain(x.to(dt), params, BANK_KS, BANK_DILS)
            out[f"resblock_bank {str(dt)[6:]}"] = check_close(f"bank {label} on {dev} {dt}", got, want,
                                                              *BANK_BOUNDS[str(dt)[6:]])
        torch.cuda.synchronize(dev)
        if torch.cuda.current_device() != cards[0].index:
            raise AssertionError(f"a wrapper left {torch.cuda.current_device()} current, not {cards[0]}")
    return out


def trace_copies(pipe, wavs, controls, ticks=5, **pool_kw):
    """A trace of ``ticks`` fused pool ticks: each card's busy ms a tick and
    the ms a tick of peer copies (``Memcpy PtoP``) and of copies within a
    card (``Memcpy DtoD``: the segments' copy-in), as unions of intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from obs_rvc_tpu_torch.stream import StreamPool

    n = pipe.cfg.sample_frame_size
    pool = StreamPool(pipe, capacity=len(wavs), mode="fused", **pool_kw)
    pool.prepare()
    slots = [pool.attach(c) for c in controls]

    def tick(i):
        for k, s in enumerate(slots):
            pool.push_audio(s, wavs[k, i * n : (i + 1) * n])
            pool.pull_audio(s, n)
        pool.process_pending()

    with torch.no_grad():
        tick(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tick(1)
            mark_trace()
            for i in range(ticks):
                tick(2 + i % (wavs.shape[1] // n - 2))
            torch.cuda.synchronize()
    pool.stop()
    events = events_after_mark(prof)
    cards = sorted({e.device_index for e in events})
    return {"busy_ms_per_tick": {str(c): device_busy_ms([e for e in events if e.device_index == c]) / ticks
                                 for c in cards},
            "peer_copy_ms_per_tick": device_busy_ms([e for e in events if "PtoP" in e.name]) / ticks,
            "card_copy_ms_per_tick": device_busy_ms([e for e in events if "DtoD" in e.name]) / ticks,
            "all_busy_ms_per_tick": device_busy_ms(events) / ticks}


def phase_mesh_cards(report, smi, cards, one, wavs, controls, table, queries):
    """The mesh across cards, where two or more are visible: the three
    kernels on the second card; data=1 x model=2 and data=2 x model=2 pools
    of ``POOL_B`` whose rows span cards (the visible ones in turn), fused and
    staged, in both dtypes, against the one-device pool (float32 within 1e-3
    of max|audio|, bfloat16 by :func:`pool_parity`), tick p50/p95 and each
    card's peak memory, a trace of the fused tick (each card's busy ms and
    the peer copies' share); ContentVec split over two cards and the exact
    blend split over two cards, by CUDA events beside the unsharded ones;
    ``serve.server --pool 8 --mesh data=N/2,model=2`` answering a duplex
    session; two processes over NCCL, one card each, against one process."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.device import run_inline
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.parallel import make_mesh
    from obs_rvc_tpu_torch.parallel.sharding import shard_contentvec
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.stream import RvcPipeline
    from obs_rvc_tpu_torch.stream.graphs import GraphedFunction, SegmentedFunction

    out = report["mesh"]["cross_card"] = {"cards": [str(c) for c in cards], "nvidia_smi": smi}
    cfg = ChunkConfig.build()
    n = cfg.sample_frame_size

    # 1. each kernel on the second card while the first is current
    out["kernels_on_second_card"] = cross_card_kernels(cards)
    log("mesh", f"the three kernels on {cards[1]} while {cards[0]} is current, against their plain versions: "
                + ", ".join(f"{k} {v:.2e}" for k, v in out["kernels_on_second_card"].items()))

    # 2. pools whose rows span cards
    shapes = [(1, 2), (2, 2)]
    for dtype in ("float32", "bfloat16"):
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype), device=cards[0])
        pipe.init_params(SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        r = out[dtype] = {}
        for n_data, n_model in shapes:
            devs = [cards[i % len(cards)] for i in range(n_data * n_model)]
            mesh = make_mesh(n_data=n_data, n_model=n_model, devices=devs)
            key = f"data{n_data}_model{n_model}"
            for mode in ("fused", "staged"):
                torch.cuda.synchronize()
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
                got, stats = pool_run(pipe, wavs, controls, starved=POOL_STARVED, mode=mode, mesh=mesh)
                stats["peak_mem_bytes"] = {str(c): int(torch.cuda.max_memory_allocated(c)) for c in cards}
                if dtype == "float32":
                    same = [check_same(f"cross-card {key} float32 {mode} slot {k}", a, one["float32"][k],
                                       CPU_TOL["emitted"]) for k, a in enumerate(got)]
                    stats["vs_one_device"] = same
                    verdict = f"max {max(e for _, e in same):.2e} of max|audio| (bound {CPU_TOL['emitted']})"
                else:
                    par = pool_parity(f"cross-card {key} bfloat16 {mode}", torch.stack(got), one["bfloat16"],
                                      one["float32"])
                    stats["parity"] = par
                    verdict = "off the float32 one-device pool " + ", ".join(f"{e:.4f}" for e in par["rel"])
                if mode == "fused":
                    stats["trace"] = trace_copies(pipe, wavs, controls, mesh=mesh)
                r[f"{key}_{mode}"] = stats
                tr = stats.get("trace")
                log("mesh", f"{dtype} StreamPool({POOL_B}, {mode}) on data={n_data} x model={n_model} over "
                            f"{[str(d) for d in devs]}: tick p50 {stats['tick_p50_ms']:.2f} ms, p95 "
                            f"{stats['tick_p95_ms']:.2f}; capture {stats['capture_s']:.2f} s; peak memory "
                            + ", ".join(f"{c} {b / 2**20:.0f} MiB" for c, b in stats["peak_mem_bytes"].items())
                            + f"; each slot against the one-device pool: {verdict}"
                            + (f"; a trace of 5 ticks: busy ms a tick by card {tr['busy_ms_per_tick']}, peer "
                               f"copies {tr['peer_copy_ms_per_tick']:.3f} ms a tick "
                               f"({tr['peer_copy_ms_per_tick'] / max(tr['all_busy_ms_per_tick'], 1e-9):.1%} of the "
                               f"busy time), copies within a card {tr['card_copy_ms_per_tick']:.3f}" if tr else "")
                            + f" [{smi}]")
        if dtype == "float32":
            # 3. ContentVec alone split over two cards, and on one, beside the unsharded network
            cv = pipe.contentvec
            wav16 = torch.from_numpy(np.random.default_rng(SEED + 70).standard_normal((1, 16000))
                                     .astype(np.float32) * 0.1).to(cards[0])
            ms = {}
            with torch.no_grad():
                want = cv(wav16)
                for label, devs in (("two_cards", cards[:2]), ("one_card", [cards[0]] * 2)):
                    tp = shard_contentvec(cv, devs)
                    check_close(f"ContentVec model=2 over {label}", tp(wav16), want, MESH_TP_TOL, 1e-4)
                    ms[label] = cuda_ms(lambda: tp(wav16))
                ms["unsharded"] = cuda_ms(lambda: cv(wav16))
            out["contentvec_tp_ms"] = ms
            log("mesh", f"ContentVec split at model=2, 1 s of audio, eager, CUDA events: over two cards "
                        f"{ms['two_cards']:.3f} ms, on one card named twice {ms['one_card']:.3f}, unsharded "
                        f"{ms['unsharded']:.3f} [{smi}]")
        del pipe
        torch.cuda.empty_cache()

    # 4. the exact blend split over two cards (as segments) beside the unsharded one (a graph)
    params = RetrievalIndex.make_params(table)
    whole = RetrievalIndex().load(params, cards[0])
    split = RetrievalIndex(mesh=make_mesh(n_data=1, n_model=2, devices=cards[:2])).load(params)
    blend = {}
    for B in (1, POOL_B):
        q = torch.from_numpy(queries[:B]).to(cards[0])
        rate = torch.full((B,), RETRIEVAL_RATE, device=cards[0])
        seg = SegmentedFunction(lambda q, r, run=run_inline: split.blend(q, r, run), (q, rate), device=cards[0],
                                name="split_blend")
        one_graph = GraphedFunction(lambda q, r: whole.blend(q, r), (q, rate), device=cards[0], name="blend")
        err = check_close(f"cross-card blend B={B}", seg(q, rate), one_graph(q, rate), RETRIEVAL_TOL, 0.0)
        blend[B] = {"max_abs_err": err, "ms": cuda_ms(lambda: seg.run(q, rate)),
                    "unsharded_ms": cuda_ms(lambda: one_graph.run(q, rate)), "segments": len(seg.segments)}
    out["split_blend"] = blend
    log("mesh", f"the exact blend over {len(table)} x {RETRIEVAL_C} float32 rows split over {cards[0]} and "
                f"{cards[1]} (segments: each shard's search on its card, the merge on the first) against the "
                "unsharded one (one graph): " + "; ".join(
                    f"B={B} max abs err {b['max_abs_err']:.2e}, {b['ms']:.4f} ms against {b['unsharded_ms']:.4f}"
                    for B, b in blend.items()) + f" (CUDA events around a call, copy-in included) [{smi}]")
    del whole, split, params
    torch.cuda.empty_cache()

    # 5. the server on a pool whose rows span cards
    spec = f"data={len(cards) // 2},model=2"
    host = "127.0.0.1"
    with Server(server_argv(host, ["--pool", str(POOL_B), "--mesh", spec])) as srv:
        url = f"http://{host}:{srv.bound['health']}/metrics"
        wav = voiced_signal((POOL_SERVE_CHUNKS + 2) * n, cfg.sample_rate, seed=SEED + 72)
        streamed = duplex_session(host, srv.bound["duplex"], wav, POOL_SERVE_CHUNKS, n, cfg.sample_rate)
        metrics = wait_metrics_settled(url)
        if metrics["errors"] != 0 or metrics["chunks"] < POOL_SERVE_CHUNKS:
            raise AssertionError(f"cross-card mesh server: /metrics {metrics}")
        out["server"] = {"mesh": spec, "startup_s": srv.startup_s, "metrics": metrics}
    log("mesh", f"server --pool {POOL_B} --mesh {spec} over {len(cards)} cards (bfloat16, staged): a duplex "
                f"session, {streamed.size} samples back; /metrics {metrics}")
    torch.cuda.empty_cache()


def phase_mesh(report, smi, table=None, queries=None):
    """The mesh (``obs_rvc_tpu_torch/parallel/``) at full width with RMVPE,
    TF32 off, every mesh the one card named more than once: a data=2 x
    model=2 StreamPool of ``POOL_B`` against the one-device pool on the same
    chunks (float32 within 1e-3 of max|audio|, bfloat16 by
    :func:`pool_parity`), fused and staged, two slots starved; the eager
    mesh step's wrapper launches a tick (2 x 1/4/2), a trace of 5 pool ticks
    (2 x 1/32/6 hand kernels a tick), tick p50/p95 and peak memory beside
    the one-device pool's; ContentVec split at model=2 against the unsharded
    network; the exact blend over the retrieval phase's table split at
    model=2 against the unsharded blend, both timed; ``dryrun_multichip``
    over the card named 8 times; a server with ``--pool 8 --mesh
    data=1,model=1`` and ``--mesh data=<cards + 1>`` refused; two processes of
    ``tests/torch_distributed_worker.py`` at full width over gloo against one
    process, and NCCL at world size 1."""
    import torch

    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.parallel import make_mesh, shard_controls, shard_params, shard_state
    from obs_rvc_tpu_torch.parallel.dryrun import dryrun_multichip
    from obs_rvc_tpu_torch.parallel.sharding import gather_rows, shard_contentvec, step_rows
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.serve import server
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("mesh: TF32 is on; the float32 comparisons need it off")
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = ChunkConfig.build()
    n = cfg.sample_frame_size
    mesh = make_mesh(n_data=MESH_DATA, n_model=MESH_MODEL, devices=[dev] * (MESH_DATA * MESH_MODEL))
    out = report["mesh"] = {"nvidia_smi": smi, "mesh": mesh.shape, "devices": "cuda:0 named "
                            f"{MESH_DATA * MESH_MODEL} times", "streams": POOL_B, "chunks": POOL_CHUNKS}
    wavs, chunks, controls = pool_streams(cfg, POOL_B, POOL_CHUNKS, dev)
    stacked = StepControls.stack(controls, dev)
    per_tick = {k: MESH_DATA * v for k, v in LAUNCHES_PER_STEP["rmvpe"].items()}
    kernels_want = {k: 5 * MESH_DATA * v for k, v in kernels_per_step("rmvpe", POOL_B // MESH_DATA).items()}

    # 1. pools: one device, then the mesh, in each dtype
    one = {}
    for dtype in ("float32", "bfloat16"):
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype))
        pipe.init_params(SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        r = out[dtype] = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one[dtype], stats = pool_run(pipe, wavs, controls, starved=POOL_STARVED, mode="fused")
        stats["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        r["one_device_fused"] = stats
        # the eager mesh step: each row launches each wrapper as a one-device step does
        rows = shard_params(pipe, mesh)
        states = shard_state(StreamState.init_batch(cfg, POOL_B, device=dev), mesh)
        torch.cuda.synchronize()
        reset_launches()
        with torch.no_grad():
            for c in chunks[:2]:
                states, _ = step_rows(rows, states, shard_state(c, mesh), shard_controls(stacked, mesh))
        launches = read_launches()
        r["eager_launches_per_tick"] = {k: v / 2 for k, v in launches.items()}
        log("mesh", f"{dtype}: the eager step on a data={MESH_DATA} x model={MESH_MODEL} mesh, 2 ticks of "
                    f"{POOL_B} streams: wrapper launches {launches} (want {MESH_DATA} rows x "
                    f"{LAUNCHES_PER_STEP['rmvpe']} a tick)")
        if launches != {k: 2 * v for k, v in per_tick.items()}:
            raise AssertionError(f"mesh {dtype}: launches {launches} over 2 ticks, want {per_tick} a tick")
        (bit, rel), n_segments = segmented_vs_eager(f"mesh {dtype} segmented graphs vs eager rows", rows, mesh, cfg,
                                                    chunks[:3], stacked, dev)
        r["segmented_vs_eager"] = {"bit_identical": bit, "rel_max_err": rel, "segments": n_segments}
        log("mesh", f"{dtype}: each row's jit_step_batch as {n_segments} per-device graph segments against the "
                    f"eager row step, 3 chunks from zeroed states: "
                    + ("bit-identical" if bit else f"within {rel:.2e} of max|audio| (bound {CPU_TOL['emitted']})"))
        if dtype == "bfloat16" and not bit:
            raise AssertionError(f"mesh bfloat16: the segmented graphs are {rel:.2e} off the eager row step, "
                                 "not bit-identical")
        for mode in ("fused", "staged"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got, stats = pool_run(pipe, wavs, controls, starved=POOL_STARVED, mode=mode, mesh=mesh)
            stats["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
            if dtype == "float32":
                same = [check_same(f"mesh float32 {mode} slot {k}", a, one["float32"][k], CPU_TOL["emitted"])
                        for k, a in enumerate(got)]
                stats["vs_one_device"] = same
                verdict = ", ".join("bit-identical" if b else f"{e:.2e}" for b, e in same) + \
                    f" of max|audio| (bound {CPU_TOL['emitted']})"
            else:
                par = pool_parity(f"mesh bfloat16 {mode}", torch.stack(got), one["bfloat16"], one["float32"])
                stats["parity"] = par
                verdict = ("off the float32 one-device pool " + ", ".join(f"{e:.4f}" for e in par["rel"])
                           + " (the bfloat16 one-device pool: " + ", ".join(f"{e:.4f}" for e in par["single_rel"])
                           + "); relative L2 off its own stream " + ", ".join(f"{e:.3f}" for e in par["l2_own"])
                           + ", off the nearest other " + ", ".join(f"{e:.3f}" for e in par["l2_nearest_other"]))
            counts, busy, retraced = trace_pool_ticks(pipe, wavs, controls, kernels_want, mode=mode, mesh=mesh)
            stats.update(kernels_in_trace=counts, device_busy_ms_per_tick=busy, traced_again=retraced)
            r[mode] = stats
            base = r["one_device_fused"]
            log("mesh", f"{dtype} StreamPool({POOL_B}, {mode}) on data={MESH_DATA} x model={MESH_MODEL}, slots "
                        f"{POOL_STARVED} starved for 3 ticks: tick p50 {stats['tick_p50_ms']:.2f} ms, p95 "
                        f"{stats['tick_p95_ms']:.2f} (one device, fused: {base['tick_p50_ms']:.2f} / "
                        f"{base['tick_p95_ms']:.2f}); capture {stats['capture_s']:.2f} s; peak memory "
                        f"{stats['peak_mem_bytes'] / 2**20:.0f} MiB (one device {base['peak_mem_bytes'] / 2**20:.0f}); "
                        f"each slot against the one-device pool: {verdict}; a trace of 5 ticks: hand kernels "
                        f"{counts} (want {kernels_want}), device busy {busy:.2f} ms a tick [{smi}]")
            if counts != kernels_want:
                raise AssertionError(f"mesh {dtype} {mode}: 5 ticks traced {counts} hand kernels, want {kernels_want}")
        if dtype == "float32":
            # 2. ContentVec alone, split at model=2, against the unsharded network
            cv = pipe.contentvec
            tp = shard_contentvec(cv, [dev, dev])
            wav16 = torch.from_numpy(np.random.default_rng(SEED + 70).standard_normal((1, 16000))
                                     .astype(np.float32) * 0.1).to(dev)
            with torch.no_grad():
                want, got = cv(wav16), tp(wav16)
                err = check_close("mesh ContentVec model=2 vs unsharded", got, want, MESH_TP_TOL, 1e-4)
                ms = {"unsharded": cuda_ms(lambda: cv(wav16)), "model2": cuda_ms(lambda: tp(wav16))}
            out["contentvec_tp"] = {"max_abs_err": err, "ms": ms}
            log("mesh", f"ContentVec (768-d, 12 heads, 3072 FFN) split at model=2 against the unsharded network, 1 s "
                        f"of audio: max abs err {err:.3e} (bound {MESH_TP_TOL}); CUDA events {ms['model2']:.3f} ms "
                        f"against {ms['unsharded']:.3f} [{smi}]")
            del tp
        del pipe, rows, states
        torch.cuda.empty_cache()

    # 3. the exact blend over the table split at model=2, against the unsharded blend
    if table is None:
        table = retrieval_table(RETRIEVAL_N, RETRIEVAL_C, SEED + 60)
        queries = retrieval_queries(table, np.random.default_rng(SEED + 61), POOL_B, cfg.return_length)
    params = RetrievalIndex.make_params(table)
    whole = RetrievalIndex().load(params, dev)
    split = RetrievalIndex(mesh=make_mesh(n_data=1, n_model=2, devices=[dev, dev])).load(params)
    blend = {}
    for B in (1, POOL_B):
        q = torch.from_numpy(queries[:B]).to(dev)
        rate = torch.full((B,), RETRIEVAL_RATE, device=dev)
        err = check_close(f"mesh sharded blend B={B}", split.blend(q, rate), whole.blend(q, rate), RETRIEVAL_TOL, 0.0)
        bound, by = blend_bound_ms(B, cfg.return_length, len(table), RETRIEVAL_C, 4, "exact")
        blend[B] = {"max_abs_err": err, "ms": graph_ms(lambda: split.blend(q, rate), calls=3, replays=5),
                    "unsharded_ms": graph_ms(lambda: whole.blend(q, rate), calls=3, replays=5),
                    "bound_ms": bound, "bound_by": by}
    out["sharded_blend"] = blend
    log("mesh", f"the exact blend over {len(table)} x {RETRIEVAL_C} float32 rows split at model=2 against the "
                "unsharded blend: " + "; ".join(f"B={B} max abs err {b['max_abs_err']:.2e} (bound {RETRIEVAL_TOL}), "
                                              f"{b['ms']:.4f} ms against {b['unsharded_ms']:.4f} (bound "
                                              f"{b['bound_ms']:.4f} by {b['bound_by']})" for B, b in blend.items())
                + f" (CUDA events, a graph of its calls) [{smi}]")
    del whole, split, params
    torch.cuda.empty_cache()

    # 4. both mesh shapes of 8 devices at production widths, the card named 8 times
    t0 = time.perf_counter()
    with torch.no_grad():
        dryrun_multichip(MESH_DRYRUN_DEVICES, devices=[dev] * MESH_DRYRUN_DEVICES)
    out["dryrun_s"] = time.perf_counter() - t0
    log("mesh", f"dryrun_multichip({MESH_DRYRUN_DEVICES}) over cuda:0 named {MESH_DRYRUN_DEVICES} times: "
                f"data=4 x model=2 (with a pool tick) and data=2 x model=4 in {out['dryrun_s']:.1f} s")
    torch.cuda.empty_cache()

    # 5. the server on a mesh pool; a mesh the card cannot hold is refused, naming the count
    host = "127.0.0.1"
    with Server(server_argv(host, ["--pool", str(POOL_B), "--mesh", "data=1,model=1"])) as srv:
        url = f"http://{host}:{srv.bound['health']}/metrics"
        wav = voiced_signal((POOL_SERVE_CHUNKS + 2) * n, cfg.sample_rate, seed=SEED + 71)
        streamed = duplex_session(host, srv.bound["duplex"], wav, POOL_SERVE_CHUNKS, n, cfg.sample_rate)
        metrics = wait_metrics_settled(url)
        if metrics["errors"] != 0 or metrics["chunks"] < POOL_SERVE_CHUNKS:
            raise AssertionError(f"mesh server: /metrics {metrics}")
        out["server"] = {"startup_s": srv.startup_s, "metrics": metrics}
    # a spec one row wider than the visible cards: data=2 on one card
    n_cards = torch.cuda.device_count()
    try:
        server.main(["--mesh", f"data={n_cards + 1}", "--port", "0"])
        refused = None
    except SystemExit as e:
        refused = str(e)
    out["server"]["wider_refused"] = refused
    log("mesh", f"server --pool {POOL_B} --mesh data=1,model=1 (bfloat16, staged): a duplex session, "
                f"{streamed.size} samples back; /metrics {metrics}; --mesh data={n_cards + 1} on {n_cards} "
                f"card(s): {refused!r}")
    if not refused or f"need {n_cards + 1} devices, have {n_cards}" not in refused:
        raise AssertionError(f"mesh: --mesh data={n_cards + 1} on {n_cards} card(s) was not refused naming the "
                             f"count: {refused!r}")

    # 6. two processes over gloo on the card at full width, against one process; NCCL at world size 1
    worker = pathlib.Path(__file__).resolve().parent / "tests" / "torch_distributed_worker.py"
    OUT_DIR.mkdir(exist_ok=True)

    def run_workers(nprocs, extra):
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(nprocs), str(port), str(OUT_DIR), *extra],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(nprocs)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=MESH_DIST_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                raise AssertionError(f"mesh: distributed worker {i} of {nprocs} exited {p.returncode}:\n{text[-3000:]}")
        return time.perf_counter() - t0, texts

    dist_s, texts = run_workers(2, ["--device", "cuda:0", "--full-width", "--backend", "gloo"])
    got = torch.from_numpy(np.load(OUT_DIR / "dist_out.npy"))
    sys.path.insert(0, str(worker.parent))
    import torch_distributed_worker as tdw

    pipe = RvcPipeline(cfg, device=dev)
    pipe.init_params(0, std=None)
    B = tdw.LOCAL * 2
    with torch.no_grad():
        _, want = pipe.step(StreamState.init_batch(cfg, B, device=dev), torch.from_numpy(tdw.inputs(cfg, B)).to(dev),
                            StepControls.stack([StepControls.default()] * B, dev), batched=True)
    same = check_same("mesh two processes vs one", got, want.cpu(), CPU_TOL["emitted"])
    nccl_s, nccl = run_workers(1, ["--device", "cuda:0", "--backend", "nccl"])
    for f in ("dist_out.npy", "dist_buf16.npy"):
        (OUT_DIR / f).unlink()
    out["distributed"] = {"two_process_s": dist_s, "bit_identical": same[0], "rel_max_err": same[1],
                          "workers": [t.strip().splitlines()[-1] for t in texts],
                          "nccl": nccl[0].strip().splitlines()[-1], "nccl_s": nccl_s}
    log("mesh", f"two processes (gloo, {tdw.LOCAL} rows each, full width float32 on cuda:0) in {dist_s:.1f} s: "
                f"the gathered {B} streams " + ("bit-identical to" if same[0] else f"within {same[1]:.2e} of")
                + f" one process's batched step; {out['distributed']['nccl']} ({nccl_s:.1f} s)")
    del pipe
    torch.cuda.empty_cache()

    # 7. across cards, where two or more are visible
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    parts = ["three kernels on the second card", "pools of data=1 x model=2 and data=2 x model=2 spanning cards",
             "ContentVec and the exact blend split over two cards", "server --pool 8 --mesh data=N/2,model=2",
             "two processes over NCCL, one card each"]
    if len(cards) >= 2:
        phase_mesh_cards(report, smi, cards, one, wavs, controls, table, queries)
        nccl2_s, nccl2 = run_workers(2, ["--device", "cuda:{rank}", "--full-width", "--backend", "nccl"])
        got2 = torch.from_numpy(np.load(OUT_DIR / "dist_out.npy"))
        for f in ("dist_out.npy", "dist_buf16.npy"):
            (OUT_DIR / f).unlink()
        same2 = check_same("mesh two processes over nccl vs one", got2, want.cpu(), CPU_TOL["emitted"])
        out["cross_card"]["nccl_two_process"] = {"s": nccl2_s, "bit_identical": same2[0], "rel_max_err": same2[1],
                                                 "workers": [t.strip().splitlines()[-1] for t in nccl2]}
        log("mesh", f"two processes over NCCL (cuda:0 and cuda:1, {tdw.LOCAL} rows each, full width float32) in "
                    f"{nccl2_s:.1f} s: the gathered {B} streams "
                    + ("bit-identical to" if same2[0] else f"within {same2[1]:.2e} of") + " one process's batched step")
        ran, not_run = parts, []
    else:
        ran, not_run = [], parts
    out["cards_seen"], out["cross_card_ran"], out["cross_card_not_run"] = len(cards), ran, not_run
    out["cards_line"] = (f"{len(cards)} card(s) visible; cross-card parts run: {'; '.join(ran) or 'none'}; not run"
                         + (f" (one card): {'; '.join(not_run)}" if not_run else ": none"))
    log("mesh", out["cards_line"])
    out["phase_s"] = time.perf_counter() - t_phase
    log("mesh", f"the mesh phase ran {out['phase_s']:.1f} s")


def kernel_line(report):
    """One entry per kernel and dtype on the main path: float32 for all
    three (the float32 main run's launches), bfloat16 for the chain and the
    bank (the bfloat16 run's; the log-mel stays float32 there); the log-mel
    on the FCPE path's Slaney basis (the FCPE float32 run's launches); and
    the three on the pool phase's batched step of ``POOL_B`` streams, in its
    bfloat16 (the pool phase's eager run's launches, times at ``POOL_B``
    streams); and the chain and the bank at each width past the main path's
    (``CHAIN_WIDTH_SHAPES``, ``BANK_WIDTH_SHAPES``) in both dtypes, whose
    launches are the wrapper's calls in the reduced-width run of that dtype
    (the widths phase, whose C=8 levels take the kernels' C=8 instances);
    and the chain at each of the six levels past C=32 (``CHAIN_WIDE_SHAPES``,
    the ring kernels) and its padded widths in both dtypes, and at the
    batched step's 8 and 64 streams in bfloat16, whose launches are the
    wrapper's calls in the ``pallas_unet_max_ch=256`` step of that dtype and
    batch (the switch phase). The log-mel's ``max_abs_err`` is the largest over every shape and
    both bases, the Slaney entry's over its own basis, the batched entries'
    over their batched shapes, a width's over its own shape; the main path's
    entries leave the widths out."""
    srcs = {"log_mel": ("obs_rvc_tpu_torch/csrc/stft_mel.cu", "obs_rvc_tpu/ops/stft_mel.py:70"),
            "conv_block_res_chain": ("obs_rvc_tpu_torch/csrc/unet_block.cu", "obs_rvc_tpu/ops/unet_block.py:155"),
            "resblock_bank": ("obs_rvc_tpu_torch/csrc/resblock.cu", "obs_rvc_tpu/ops/resblock.py:298")}
    main_labels = {s[0] for s in CHAIN_SHAPES + BANK_SHAPES} | {MEL_MAIN}
    batch_labels = {s[0] for s in CHAIN_SHAPES_BATCH + BANK_SHAPES_BATCH} | {MEL_BATCH_MAIN}
    width_labels = {s[0] for s in CHAIN_WIDTH_SHAPES + BANK_WIDTH_SHAPES + CHAIN_WIDE_ALL}

    def batched(label):
        return (label.startswith("batch-") or label.endswith(f"-b{POOL_B}")) and label not in width_labels

    def not_width(label):
        return label not in width_labels

    entries = [(name, name, "float32", "main", main_labels, not_width) for name in srcs] + [
        (name, f"{name} bfloat16", "bfloat16", "main_bf16", main_labels, not_width)
        for name in ("conv_block_res_chain", "resblock_bank")] + [
        ("log_mel", "log_mel fcpe-slaney", "float32", "fcpe", {FCPE_MEL_MAIN},
         lambda label: label.startswith(FCPE_MEL_MAIN)),
        ("log_mel", "log_mel batched", "float32", "pool", batch_labels, batched)] + [
        (name, f"{name} bfloat16 batched", "bfloat16", "pool", batch_labels, batched)
        for name in ("conv_block_res_chain", "resblock_bank")] + [
        # each width past the main path's on its own, its launches the reduced-width run's in that dtype
        (name, f"{name} {label}" + ("" if dtype == "float32" else " bfloat16"), dtype,
         "widths" if dtype == "float32" else "widths_bf16", {label}, lambda parity, label=label: parity == label)
        for name, shapes in (("conv_block_res_chain", CHAIN_WIDTH_SHAPES), ("resblock_bank", BANK_WIDTH_SHAPES))
        for label, *_ in shapes for dtype in ("float32", "bfloat16")] + [
        # the ring kernel's levels and padded widths, their launches the pallas_unet_max_ch=256 step's
        ("conv_block_res_chain", f"conv_block_res_chain {label}" + ("" if dtype == "float32" else " bfloat16"),
         dtype, run, {label}, lambda parity, label=label: parity == label)
        for shapes, dtypes in ((CHAIN_WIDE_SHAPES + CHAIN_WIDE_PAD_SHAPES, ("float32", "bfloat16")),
                               (CHAIN_WIDE_SHAPES_BATCH + CHAIN_WIDE_SHAPES_B64, ("bfloat16",)))
        for label, B, *_ in shapes for dtype in dtypes
        for run in [MAX_CH_RUNS[(dtype, B)]]]
    kernels = []
    for name, entry, dtype, run, labels, parity_label in entries:
        src, replaces = srcs[name]
        row_key = name if dtype == "float32" else f"{name} {dtype}"
        rows = [r for label, r in report["timing"][row_key].items() if label in labels]
        errs = [v for k, v in report["parity"][name].items()
                if parity_label(k.rsplit(" ", 1)[0]) and k.endswith(dtype)]
        kernels.append({
            "name": entry, "route": "cuda", "source": src, "replaces": replaces,
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
    ap.add_argument("--only", default="",
                    help="run only these phases after the build, comma-separated (parity, crepe_conv, widths, "
                         "switch, stage_repeat, mesh, bench, timing), and print no kernel line: for iterating on one "
                         "phase")
    ap.add_argument("--stage-repeat-child", nargs=2, metavar=("OUT", "LOG"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.stage_repeat_child:
        stage_repeat_child(*args.stage_repeat_child)
        return 0

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
    t_start = time.perf_counter()
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

    if args.only:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        phases = {"stage_repeat": lambda: phase_stage_repeat(report), "mesh": lambda: phase_mesh(report, smi),
                  "bench": lambda: phase_bench(report), "parity": lambda: phase_parity(report),
                  "widths": lambda: phase_widths(report), "switch": lambda: phase_switch(report),
                  "crepe_conv": lambda: phase_crepe_conv(report),
                  "timing": lambda: phase_timing(report, trace=args.profile)}
        for name in args.only.split(","):
            phases[name]()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
        if "mesh" in report:
            log("mesh", report["mesh"]["cards_line"])
        log("done", f"chip_smoke --only {args.only} ran {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    clock = [time.perf_counter()]
    spent = report["phase_seconds"] = {}

    def mark(name):
        """The seconds since the last mark, under ``name``: where the run's time goes."""
        clock.append(time.perf_counter())
        spent[name] = clock[-1] - clock[-2]

    phase_parity(report)
    phase_crepe_conv(report)
    mark("parity")
    phase_widths(report)
    mark("widths")
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
    mark("main")
    phase_stage_repeat(report)
    mark("stage_repeat")
    phase_bench(report)
    mark("bench")
    phase_switch(report)
    mark("switch")
    v1 = phase_main(report, "v1", V1_CHUNKS, "bfloat16", version="v1")
    phase_graphs(report, "v1", v1, reload_weights=True)
    del v1
    torch.cuda.empty_cache()
    phase_serve(report, bf16["pipe"])
    mark("v1, serve")
    del f32, bf16
    torch.cuda.empty_cache()
    for algo in ("crepe", "fcpe"):
        pf = phase_main(report, algo, PITCH_CHUNKS, "float32", cpu_chunks=PITCH_CPU_CHUNKS["float32"],
                        breakdown=True, pitch=algo)
        phase_graphs(report, algo, pf)
        del pf["pipe"], pf["state"]
        torch.cuda.empty_cache()
        pb = phase_main(report, f"{algo}_bf16", PITCH_CHUNKS, "bfloat16", cpu_chunks=PITCH_CPU_CHUNKS["bfloat16"],
                        breakdown=True, reference=pf["cpu"], pitch=algo)
        compare_dtypes(report, pf, pb, key=f"{algo}_bf16_vs_f32")
        phase_graphs(report, f"{algo}_bf16", pb)
        del pf, pb
        torch.cuda.empty_cache()
    phase_pitch_serve(report)
    mark("pitch")
    phase_pool(report)
    phase_pool_serve(report)
    mark("pool")
    table, queries = phase_retrieval(report, smi)
    mark("retrieval")
    torch.cuda.empty_cache()
    phase_mesh(report, smi, table, queries)
    mark("mesh")
    del table, queries
    torch.cuda.empty_cache()
    phase_timing(report, trace=args.profile)
    mark("timing")
    for key in ("main", "main_bf16", "v1", "crepe", "crepe_bf16", "fcpe", "fcpe_bf16"):
        m = report[key]
        g = m["graphs"]
        log("timing", f"{key} ({m['version']}, {m['pitch_algorithm']}, {m['dtype']}): step p50 / p95 over {m['chunks'] - 4} steady chunks: "
                      f"eager {m['step_p50_ms']:.2f} / {m['step_p95_ms']:.2f} ms, fused graph "
                      f"{g['fused']['step_p50_ms']:.2f} / {g['fused']['step_p95_ms']:.2f} ms, staged graphs "
                      f"{g['staged']['step_p50_ms']:.2f} / {g['staged']['step_p95_ms']:.2f} ms; real-time factor "
                      f"{m['rtf']:.4f} eager, {m['rtf'] * g['fused']['step_p50_ms'] / m['step_p50_ms']:.4f} fused; peak device memory "
                      f"{m['peak_mem_bytes'] / 2**20:.1f} MiB eager, {g['fused']['peak_mem_bytes'] / 2**20:.1f} fused, "
                      f"{g['staged']['peak_mem_bytes'] / 2**20:.1f} staged")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log("mesh", report["mesh"]["cards_line"])
    log("done", f"chip_smoke ran {time.perf_counter() - t_start:.1f} s; by phase: "
                + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))
    print(json.dumps(kernel_line(report)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
