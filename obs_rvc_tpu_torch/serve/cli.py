"""Offline conversion: WAV in, converted WAV out (counterpart of
``obs_rvc_tpu/serve/cli.py``), through ``RvcPipeline.convert_offline``.
Every setting of the plugin maps to a flag; the flags are the JAX CLI's, so
a command line carries over, plus ``--device``.

    python -m obs_rvc_tpu_torch.serve.cli in.wav out.wav --model model.pth --pitch-shift 12
    python -m obs_rvc_tpu_torch.serve.cli in.wav out.wav --pitch-algorithm fcpe --fcpe fcpe.pt
    python -m obs_rvc_tpu_torch.serve.cli in.wav out.wav --skip-inference --device cpu
    python -m obs_rvc_tpu_torch.serve.cli in.wav out.wav --index voice.index --index-mode ivf --index-rate 0.75

``--index`` (a faiss ``.index``, a ``.npy``/``.npz`` table or an ``.onnx``
container) blends the features with their nearest table rows at
``--index-rate``: exact search over the whole table, or ``--index-mode ivf``
(``--index-probes``, 0 for ``max(64, T)``; ``--index-lcap``, the slab
length). ``--mesh model=N`` converts with ContentVec (and an exact table)
split over N devices (every visible card by default, the CPU named
``parallel.mesh.CPU_MESH_DEVICES`` times with ``--device cpu``); conversion
is one stream, so the mesh's ``data`` axis defaults to 1 and must be 1, as
in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RVC voice conversion on the PyTorch port")
    p.add_argument("input", help="input WAV")
    p.add_argument("output", help="output WAV")
    add_model_flags(p, loudness_default=0.5, dtype_default="float32")
    p.add_argument("--metrics-json", action="store_true", help="print metrics JSON to stderr")
    p.add_argument("--mesh", default="",
                   help="convert with ContentVec split over a device mesh, e.g. 'model=2' (one stream: the "
                        "data axis must be 1; see serve.server --mesh for data parallelism)")
    return p


def add_model_flags(p: argparse.ArgumentParser, loudness_default: float, dtype_default: str) -> None:
    """The model artifacts and the plugin's settings, shared with
    ``serve.server``; the defaults that differ are the JAX entry points':
    ``--loudness-factor`` and ``--dtype`` (float32 for the CLI, bfloat16 for
    the server)."""
    p.add_argument("--model", help="RVC synthesizer .pth (random weights if omitted)")
    p.add_argument("--contentvec", help="ContentVec/HuBERT .pt checkpoint")
    p.add_argument("--rmvpe", help="RMVPE .pt checkpoint")
    p.add_argument("--crepe", help="torchcrepe .pth checkpoint (pitch-algorithm crepe)")
    p.add_argument("--fcpe", help="torchfcpe .pt checkpoint (pitch-algorithm fcpe)")
    p.add_argument("--index", help="retrieval index: faiss .index, .npy/.npz table or .onnx container")
    p.add_argument("--index-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the table's dtype on the device (scores are float32 either way)")
    p.add_argument("--index-mode", default="exact", choices=["exact", "ivf"],
                   help="exact: search the whole table; ivf: probe a union of inverted lists a chunk")
    p.add_argument("--index-probes", type=int, default=0, help="ivf lists probed a chunk (0 = max(64, T))")
    p.add_argument("--index-lcap", type=int, default=64,
                   help="ivf slab length; longer lists are split to fit (0 = the longest list)")
    p.add_argument("--model-version", default="v2", choices=["v1", "v2"])
    p.add_argument("--dest-sample-rate", type=int, default=40000)
    p.add_argument("--pitch-algorithm", default="rmvpe", choices=["rmvpe", "crepe", "fcpe"])
    p.add_argument("--pitch-shift", type=float, default=0.0)
    p.add_argument("--resonance-shift", type=float, default=0.0)
    p.add_argument("--index-rate", type=float, default=0.0)
    p.add_argument("--loudness-factor", type=float, default=loudness_default)
    p.add_argument("--sample-length", type=float, default=0.30)
    p.add_argument("--fade-length", type=float, default=0.07)
    p.add_argument("--extra-inference-time", type=float, default=2.00)
    p.add_argument("--skip-inference", action="store_true")
    p.add_argument("--speaker-id", type=int, default=0)
    p.add_argument("--f0-median-radius", type=int, default=0)
    p.add_argument("--phase-vocoder", action="store_true",
                   help="phase-corrected SOLA crossfade")
    p.add_argument("--dtype", default=dtype_default, choices=["float32", "bfloat16"],
                   help=f"the networks' compute dtype (default {dtype_default})")
    p.add_argument("--no-pallas-resblocks", action="store_true",
                   help="run the U-Net chain and resblock bank levels on the networks' own convolutions "
                        "(cuDNN on a card) instead of the hand kernels, as the JAX flag does")
    p.add_argument("--device", default=None, help="torch device (default: the card)")


def mesh_from_args(args, default_data=None):
    """The ``--mesh`` flag's mesh over the visible devices (the CPU's with
    ``--device cpu``), or None without it; a spec those devices cannot hold
    exits naming their count."""
    if not args.mesh:
        return None
    from obs_rvc_tpu_torch.parallel import parse_mesh_spec
    from obs_rvc_tpu_torch.parallel.mesh import visible_devices

    try:
        return parse_mesh_spec(args.mesh, default_data=default_data, devices=visible_devices(args.device))
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from None


def settings_from_args(args):
    from obs_rvc_tpu_torch.config import PitchAlgorithm, RvcModelVersion, StreamSettings

    return StreamSettings(
        model_path=args.model,
        index_path=args.index,
        model_version=RvcModelVersion.from_str(args.model_version),
        pitch_algorithm=PitchAlgorithm.from_str(args.pitch_algorithm),
        dest_sample_rate=args.dest_sample_rate,
        pitch_shift=int(args.pitch_shift),
        resonance_shift=args.resonance_shift,
        index_rate=args.index_rate,
        rms_mix_rate=args.loudness_factor,
        sample_length=args.sample_length,
        fade_length=args.fade_length,
        extra_inference_time=args.extra_inference_time,
        skip_inference=args.skip_inference,
    )


def pipeline_from_args(args, sample_rate: int):
    """``(pipeline, controls)``: the pipeline at the flags' geometry,
    ``--dtype`` and ``--pitch-algorithm`` with its weights loaded (random from seed 0 where no
    checkpoint is given; none at all for ``--skip-inference``, which runs no
    network) and, in bfloat16, cast for serving as the JAX entry points cast
    them; with ``--index``, its retrieval index loaded."""
    import torch

    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving, load_pipeline_params
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

    settings = settings_from_args(args)
    pipe = RvcPipeline(
        settings.chunk_config(sample_rate),
        settings.model_version,
        keyshift=int(round(args.resonance_shift)),
        f0_median_radius=args.f0_median_radius,
        phase_vocoder=args.phase_vocoder,
        device=args.device,
        compute_dtype=getattr(torch, args.dtype),
        pitch_algorithm=str(settings.pitch_algorithm),
        retrieval_index=RetrievalIndex(mode=args.index_mode, probes=args.index_probes or None,
                                       lcap=args.index_lcap or None) if args.index else None,
        pallas_resblocks=False if args.no_pallas_resblocks else None,
    )
    if not pipe.cfg.skip_inference:
        load_pipeline_params(pipe, contentvec_path=args.contentvec, rmvpe_path=args.rmvpe,
                             crepe_path=args.crepe, fcpe_path=args.fcpe, synthesizer_path=args.model,
                             index_path=args.index, index_dtype=getattr(torch, args.index_dtype))
        if args.dtype == "bfloat16":
            cast_params_for_serving(pipe)
    controls = StepControls.default(pitch_shift=args.pitch_shift, rms_mix_rate=args.loudness_factor,
                                    index_rate=args.index_rate, sid=args.speaker_id)
    return pipe, controls


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # default_data=1: conversion is one stream, so "--mesh model=2" means tensor parallelism alone
    mesh = mesh_from_args(args, default_data=1)
    if mesh is not None and mesh.shape["data"] != 1:
        raise SystemExit("offline conversion is one stream — use data=1 (DP lives in serve.server --pool --mesh)")

    import numpy as np
    import torch

    from obs_rvc_tpu_torch.utils import downmix_to_mono, read_wav, upmix_from_mono, write_wav

    audio, sr = read_wav(args.input)
    channels = audio.shape[0]
    mono = downmix_to_mono(audio)
    pipe, controls = pipeline_from_args(args, sr)
    if mesh is not None:
        from obs_rvc_tpu_torch.parallel import shard_params

        pipe = shard_params(pipe, mesh)[0]

    t0 = time.perf_counter()
    out = pipe.convert_offline(torch.from_numpy(mono), controls).cpu().numpy()
    wall = time.perf_counter() - t0

    write_wav(args.output, upmix_from_mono(np.asarray(out), channels), sr)
    if args.metrics_json:
        audio_s = len(out) / sr
        print(json.dumps({
            "audio_seconds": round(audio_s, 3),
            "wall_seconds": round(wall, 3),
            "rtf": round(wall / max(audio_s, 1e-9), 4),
            "chunks": len(out) // pipe.cfg.sample_frame_size,
            "device": str(pipe.device),
        }), file=sys.stderr)


if __name__ == "__main__":
    main()
