#!/usr/bin/env python3
"""Hold two mesh rows' graphs on one card to the one-device pool, with and
without a cuBLAS workspace of each capture's own.

    python3 scripts/torch_graph_workspace_probe.py [--repeats 4] [--mode staged] [--dtype float32]

PyTorch keys cuBLAS's workspace by handle and stream. Every graph of the
port is captured on one thread (one handle) on a side stream that PyTorch
hands out from a pool of 32, so two graphs captured 32 side streams apart
bake in the same workspace, and race when they replay at once: two mesh rows
on one card do. ``stream/graphs.py`` drops the workspaces around each
capture (``torch._C._cuda_clearCublasWorkspaces``), so a capture allocates
its own from its memory pool. ``--variant kept`` turns that off (the drop a
no-op) to show the race.

Each repeat builds the full-width pipeline from seed 0 (RMVPE, TF32 off),
steps a StreamPool of 8 on a data=2 x model=2 mesh of ``cuda:0`` named four
times (each row's features as per-device graph segments, about 80 graphs a
row), two slots starved, and holds each slot to the one-device fused pool
on the same chunks (``chip_smoke.pool_run``): float32 within 1e-3 of
max|audio|. Prints a line per repeat, the card's name and power limit, and
a JSON line last. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--mode", default="staged", choices=("staged", "fused"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--variant", default="both", choices=("cleared", "kept", "both"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("torch_graph_workspace_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from obs_rvc_tpu_torch.config import ChunkConfig
    from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
    from obs_rvc_tpu_torch.parallel import make_mesh
    from obs_rvc_tpu_torch.stream import RvcPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    cfg = ChunkConfig.build()
    wavs, _, controls = cs.pool_streams(cfg, cs.POOL_B, cs.POOL_CHUNKS, dev)
    mesh = make_mesh(n_data=2, n_model=2, devices=[dev] * 4)
    clear = torch._C._cuda_clearCublasWorkspaces

    def pipeline():
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, args.dtype), device=dev)
        pipe.init_params(cs.SEED, std=None)
        if args.dtype == "bfloat16":
            cast_params_for_serving(pipe)
        return pipe

    one, _ = cs.pool_run(pipeline(), wavs, controls, starved=cs.POOL_STARVED, mode="fused")
    rows = []
    variants = ("cleared", "kept") if args.variant == "both" else (args.variant,)
    for variant in variants:
        torch._C._cuda_clearCublasWorkspaces = clear if variant == "cleared" else (lambda: None)
        try:
            for r in range(args.repeats):
                got, stats = cs.pool_run(pipeline(), wavs, controls, starved=cs.POOL_STARVED, mode=args.mode, mesh=mesh)
                errs = [cs.rel_err(g, w) for g, w in zip(got, one)]
                row = {"variant": variant, "repeat": r, "max_rel_err": max(errs), "rel_err": errs,
                       "within_1e-3": max(errs) <= 1e-3, "tick_p50_ms": stats["tick_p50_ms"]}
                rows.append(row)
                print(f"{variant} repeat {r}: {args.dtype} {args.mode} mesh pool vs one device, max rel err "
                      f"{max(errs):.3e} ({'within' if row['within_1e-3'] else 'OFF'} 1e-3); slots "
                      + ", ".join(f"{e:.1e}" for e in errs) + f"; tick p50 {stats['tick_p50_ms']:.2f} ms [{smi}]",
                      flush=True)
                torch.cuda.empty_cache()
        finally:
            torch._C._cuda_clearCublasWorkspaces = clear
    print(smi)
    print(json.dumps({"mode": args.mode, "dtype": args.dtype, "rows": rows,
                      "off": {v: sum(not r["within_1e-3"] for r in rows if r["variant"] == v) for v in variants}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
