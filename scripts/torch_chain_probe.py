#!/usr/bin/env python3
"""Time the RMVPE U-Net chain kernel (``ops/unet_block.py``) level by level on
the card, beside cuDNN, at 1, 8 and 64 streams.

    python3 scripts/torch_chain_probe.py                       # this checkout's kernel
    python3 scripts/torch_chain_probe.py --root _archive/parent --label parent --levels main
    python3 scripts/torch_chain_probe.py --sweep --batches 1,8,64   # every tile shape at each level
    python3 scripts/torch_chain_probe.py --levels wide --sweep      # the ring kernel's levels and block shapes

For each of the main path's four levels (``chip_smoke.CHAIN_SHAPES``, the
resident kernel) and, with ``--levels wide`` (both by default), the six
levels past C=32 that ``pallas_unet_max_ch`` 64 and above route to the ring
kernel (``chip_smoke.CHAIN_WIDE_SHAPES``) at each batch and dtype: the
kernel against its plain version within
``chip_smoke.CHAIN_BOUNDS``, its device time (CUDA events around replays of
a CUDA graph of its calls, ``utils/benchlib.py:graph_ms``), cuDNN's
(``chip_smoke.chain_library``, autotuned) and the bound
(``chip_smoke.chain_flops_bytes``: 3xTF32's 165 TFLOP/s in float32, bf16's
989 in bfloat16). TF32 is off. ``--root`` imports ``obs_rvc_tpu_torch`` from
another checkout (an earlier version of the kernel, unpacked in a
git-ignored directory), so two versions are timed by one script in one
call, in turns. ``--sweep`` also times the kernel at every tile shape it
takes (``unet_block.TILES`` and more, or the ring kernels' space of
:func:`sweep_ring_tiles`: streams a tile, block shapes, channel groups,
warps along K, ``wgmma`` against ``mma.sync``, K splits; a checkout with
that space). Sweep keys read ``S x th x tw / wm / nw / kw / path /
split_in / split_c``.
Prints a line per level and a JSON line of every row last; ``--out`` writes
the rows to a file too. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def sweep_tiles(unet_block):
    """Every (th, tw, wm) the kernel is built for: tiles of 16 to 256 pixels."""
    out = []
    for th in (1, 2, 4, 8):
        for tw in (16, 32, 64):
            for wm in unet_block.CUDA_WM:
                warps = th * tw // (16 * wm)
                if warps * 16 * wm == th * tw and 1 <= warps <= unet_block.CUDA_MAX_WARPS:
                    out.append((th, tw, wm))
    return out


def sweep_ring_tiles(unet_block, W, H, B, dtype):
    """The ring kernels' tile space at a level: on the one-stream kernel
    (``mma.sync``) one stream's tile of 32 to 256 output pixels (16 pixels
    a row from 128 where the map is 16 wide, 8 below; no taller than the
    map), wm 1 or 2 (1 in float32), nw 1 or 2 groups, kw 1 or 3 warps along
    K; on the batch kernel its one tile of ``RING_BATCH_M`` pixels x
    ``RING_BATCH_NW`` groups (``wgmma`` in bfloat16, ``mma.sync`` in
    float32) as S streams' tiles of th x tw, for every S up to B (one
    stream on ``wgmma`` only) and every th x tw that fits the map, whole
    maps among them where a stream's map has fewer pixels; each with K split
    1, 2 and 4 ways below 64 streams, 1 and 2 at 64. As ``(th, tw, wm, nw,
    kw, streams, wgmma, split_in, split_c)``; the rule's own choices are
    among them."""
    import torch

    bf16 = dtype == torch.bfloat16
    splits = (1, 2, 4) if B < 64 else (1, 2)
    out = []
    for px in (32, 64, 128, 256):
        tw = 16 if px >= 128 and W >= 16 else 8
        if px <= H * W and px // tw <= H:
            for wm in ((1, 2) if bf16 else (1,)):
                for nw in (1, 2):
                    for kw in (1, 3):
                        if px // (16 * wm) * nw * kw <= unet_block.RING_MAX_WARPS:
                            out += [(px // tw, tw, wm, nw, kw, 1, False, sp, sp) for sp in splits]
    m = unet_block.RING_BATCH_M
    for S in (1, 2, 4, 8):
        if S > B or (S == 1 and not bf16):
            continue
        for tw in (8, 16, 32):
            th = m // S // tw
            if th >= 1 and th * tw * S == m and th <= H and tw <= max(W, 8):
                out += [(th, tw, 1, unet_block.RING_BATCH_NW, 1, S, bf16, sp, sp) for sp in splits]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import obs_rvc_tpu_torch from this checkout")
    ap.add_argument("--label", default="this", help="the version's name in the output")
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--levels", default="main,wide", help="main (the resident kernel's four levels), wide "
                                                             "(the ring kernel's six), or both")
    ap.add_argument("--only", default=None, help="only these levels, by label (e.g. enc4,dec0)")
    ap.add_argument("--sweep", action="store_true", help="time every tile shape too")
    ap.add_argument("--no-library", action="store_true", help="skip cuDNN's time")
    ap.add_argument("--deterministic-cudnn", action="store_true",
                    help="hold cuDNN to its deterministic engines, as every pipeline built on a card does "
                         "(device.py:deterministic_cudnn), so chip_smoke.py's timing phase times cuDNN so")
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() if args.root else HERE))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_chain_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import obs_rvc_tpu_torch
    from obs_rvc_tpu_torch.ops import unet_block
    from obs_rvc_tpu_torch.utils.benchlib import BF16_PEAK_FLOPS, TF32X3_PEAK_FLOPS, graph_ms, nvidia_smi_line

    # this checkout's chip_smoke.py (shapes, inputs, bounds, cuDNN's composite), whichever package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.deterministic_cudnn
    smi = nvidia_smi_line()
    pkg = pathlib.Path(obs_rvc_tpu_torch.__file__).parent
    print(f"[chain] {args.label}: obs_rvc_tpu_torch from {pkg}; {smi}; cuDNN deterministic "
          f"{torch.backends.cudnn.deterministic}", flush=True)
    dev = torch.device("cuda")
    dtypes = {"float32": (torch.float32, TF32X3_PEAK_FLOPS, 4), "bfloat16": (torch.bfloat16, BF16_PEAK_FLOPS, 2)}
    tiled = hasattr(unet_block, "chain_tiling")
    rows = []
    levels = {"main": cs.CHAIN_SHAPES, "wide": getattr(cs, "CHAIN_WIDE_SHAPES", [])}
    shapes = [s for name in args.levels.split(",") for s in levels[name]
              if args.only is None or s[0] in args.only.split(",")]
    for B in [int(b) for b in args.batches.split(",")]:
        for label, _, H, W, cin, C in shapes:
            rng = np.random.default_rng(cs.SEED + 2)
            x32, blocks32 = cs.chain_inputs(label, B, H, W, cin, C, dev, rng)
            for dname in args.dtypes.split(","):
                dt, peak, elem = dtypes[dname]
                x = x32.to(dt)
                blocks = [tuple(None if t is None else t.to(dt) for t in b) for b in blocks32]
                packed = unet_block.pack_chain(blocks, dt)
                got = unet_block.conv_block_res_chain(x, packed)
                want = unet_block.conv_block_res_chain_plain(x, blocks)
                torch.cuda.synchronize()
                err = cs.check_close(f"chain {label} B={B} {dname}", got, want, *cs.CHAIN_BOUNDS[dname])
                flops, nbytes = cs.chain_flops_bytes(B, H, W, cin, C, elem, elem)
                bound, by = cs.bound_ms(flops, nbytes, peak)
                ms = graph_ms(lambda: unet_block.conv_block_res_chain(x, packed))
                lib_ms = None
                if not args.no_library:
                    torch.backends.cudnn.benchmark = True
                    lib_ms = graph_ms(cs.chain_library(x, blocks))
                    torch.backends.cudnn.benchmark = False
                ms2 = graph_ms(lambda: unet_block.conv_block_res_chain(x, packed))
                row = {"version": args.label, "level": label, "B": B, "dtype": dname, "ms": min(ms, ms2),
                       "set": next(name for name in levels if any(sh[0] == label for sh in levels[name])),
                       "runs_ms": [ms, ms2], "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                       "max_abs_err": err}
                ring_level = False
                if tiled:
                    tl = unet_block.chain_tiling(B, H, W, cin, C, dt,
                                                 torch.cuda.get_device_properties(0).multi_processor_count)
                    row["tiling"] = tl._asdict()
                    ring_level = row["tiling"].get("ring", False)
                    row["launch"] = unet_block.launch_info(cin, C, dt, tl)
                lib = "" if lib_ms is None else f", cuDNN {lib_ms:.4f} ms ({row['ms'] / lib_ms:.2f}x)"
                tl = row.get("tiling", {})
                print(f"[chain] {args.label} {label} B={B} {dname}: kernel {row['ms']:.4f} ms (runs {ms:.4f}, "
                      f"{ms2:.4f}){lib}, bound {bound:.4f} ms ({by}); max abs err {err:.3e}"
                      + (f"; tile {tl.get('streams', 1)} x {tl['th']}x{tl['tw']} wm {tl['wm']} bn {tl.get('bn')} kw "
                         f"{tl.get('kw')} {'wgmma' if tl.get('wgmma') else 'mma.sync'}, splits {tl.get('splits')}, "
                         f"{tl['tiles']} tiles, {row['launch']}" if tiled else ""), flush=True)
                if args.sweep and tiled and (not ring_level or hasattr(unet_block, "ring_options")):
                    sweep = {}
                    ring = ring_level
                    for tile in (sweep_ring_tiles(unet_block, W, H, B, dt) if ring else sweep_tiles(unet_block)):
                        if ring:  # each split as many ways as the conv's stages (64-byte slabs) allow
                            sl = 64 // x.element_size()
                            tile = (*tile[:7], min(tile[7], packed.cin_kernel // sl), min(tile[8], packed.width // sl))
                        key = ("%dx%dx%d/%d/%d/%d/%s/%d/%d" % (tile[5], *tile[:5], "wg" if tile[6] else "mma", *tile[7:])
                               if ring else "%dx%d/%d" % tile)
                        if key in sweep:
                            continue
                        try:
                            unet_block.chain_tiling(B, H, W, cin, C, dt, tile=tile)
                        except ValueError:
                            continue  # does not fit shared memory
                        got = unet_block.conv_block_res_chain(x, packed, tile=tile)
                        torch.cuda.synchronize()
                        cs.check_close(f"chain {label} B={B} {dname} tile {tile}", got, want,
                                       *cs.CHAIN_BOUNDS[dname])
                        sweep[key] = graph_ms(lambda: unet_block.conv_block_res_chain(x, packed, tile=tile))
                    row["sweep_ms"] = sweep
                    best = sorted(sweep.items(), key=lambda kv: kv[1])[:5]
                    print(f"[sweep] {label} B={B} {dname}: best " + ", ".join(f"{k} {v:.4f}" for k, v in best)
                          + "; all " + " ".join(f"{k}={v:.4f}" for k, v in sweep.items()), flush=True)
                rows.append(row)
    for name in args.levels.split(","):
        for B in sorted({r["B"] for r in rows}):
            for dname in args.dtypes.split(","):
                sel = [r for r in rows if r["B"] == B and r["dtype"] == dname and r["set"] == name]
                lib = sum(r["library_ms"] or 0.0 for r in sel)
                print(f"[chain] {args.label} B={B} {dname}, {len(sel)} {name} levels: kernel "
                      f"{sum(r['ms'] for r in sel):.4f} ms, cuDNN {lib:.4f} ms, bound "
                      f"{sum(r['bound_ms'] for r in sel):.4f} ms", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(json.dumps({"device": smi, "version": args.label, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
