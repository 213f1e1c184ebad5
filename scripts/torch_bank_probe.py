#!/usr/bin/env python3
"""Time the NSF resblock bank kernel (``ops/resblock.py``) level by level on
the card, beside cuDNN, at 1, 8 and 64 streams.

    python3 scripts/torch_bank_probe.py                        # this checkout's kernel
    python3 scripts/torch_bank_probe.py --root _archive/parent --label parent
    python3 scripts/torch_bank_probe.py --sweep --batches 1,8,64   # every tile the kernel takes

For each of the main path's two levels (``chip_smoke.BANK_SHAPES``: C=64 at
L=7000, C=32 at L=14000) and the C=16 level (``BANK_EXTRA_SHAPES``) at each
batch and dtype: the kernel against its plain version within
``chip_smoke.BANK_BOUNDS``, its device time (CUDA events around replays of
a CUDA graph of its calls, ``utils/benchlib.py:graph_ms``), cuDNN's
(``chip_smoke.bank_library``, autotuned) and the bound
(``chip_smoke.bank_flops_bytes``: 3xTF32's 165 TFLOP/s in float32, bf16's
989 in bfloat16). TF32 is off. ``--root`` imports ``obs_rvc_tpu_torch`` from
another checkout (an earlier version of the kernel, unpacked in a
git-ignored directory), so two versions are timed by one script in one
call, in turns. ``--sweep`` also times the kernel at every tile it takes
(``resblock.SWEEP_TILES``; a checkout with ``bank_tiling``) at every ring
depth (``SWEEP_RINGS``), and at the rule's tile the last step split the
other way; ``--trace``
each of a call's launches (``chip_smoke.kernel_trace``). Prints a line
per level and a JSON line of every row last; ``--out`` writes the rows to a
file too. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import obs_rvc_tpu_torch from this checkout")
    ap.add_argument("--label", default="this", help="the version's name in the output")
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--levels", default="ups2,ups3,c16", help="levels of chip_smoke's BANK_SHAPES and BANK_EXTRA_SHAPES")
    ap.add_argument("--sweep", action="store_true", help="time every tile the kernel takes too")
    ap.add_argument("--no-library", action="store_true", help="skip cuDNN's time")
    ap.add_argument("--trace", action="store_true",
                    help="also each launch's device time in a torch.profiler trace of eager calls (every swept tile's too)")
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() if args.root else HERE))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_bank_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import obs_rvc_tpu_torch
    from obs_rvc_tpu_torch.ops import resblock
    from obs_rvc_tpu_torch.utils.benchlib import BF16_PEAK_FLOPS, TF32X3_PEAK_FLOPS, graph_ms, nvidia_smi_line

    # this checkout's chip_smoke.py (shapes, inputs, bounds, cuDNN's composite), whichever package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    pkg = pathlib.Path(obs_rvc_tpu_torch.__file__).parent
    print(f"[bank] {args.label}: obs_rvc_tpu_torch from {pkg}; {smi}", flush=True)
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtypes = {"float32": (torch.float32, TF32X3_PEAK_FLOPS, 4), "bfloat16": (torch.bfloat16, BF16_PEAK_FLOPS, 2)}
    tiled = hasattr(resblock, "bank_tiling")
    ks, dils = cs.BANK_KS, cs.BANK_DILS
    levels = [s for s in cs.BANK_SHAPES + cs.BANK_EXTRA_SHAPES if s[0] in args.levels.split(",")]
    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        for label, _, L, C in levels:
            rng = np.random.default_rng(cs.SEED + 3)
            x32, params32 = cs.bank_inputs(label, B, L, C, dev, rng)
            for dname in args.dtypes.split(","):
                dt, peak, elem = dtypes[dname]
                x, params = x32.to(dt), [tuple(t.to(dt) for t in p) for p in params32]
                packed = resblock.pack_bank(params, ks, dils, dt)
                got = resblock.resblock_bank(x, packed, ks, dils)
                want = resblock.resblock_bank_plain(x, params, ks, dils)
                torch.cuda.synchronize()
                err = cs.check_close(f"bank {label} B={B} {dname}", got, want, *cs.BANK_BOUNDS[dname])
                del got, want
                flops, nbytes = cs.bank_flops_bytes(B, L, C, elem, elem)
                bound, by = cs.bound_ms(flops, nbytes, peak)
                ms = graph_ms(lambda: resblock.resblock_bank(x, packed, ks, dils))
                lib_ms = None
                if not args.no_library:
                    torch.backends.cudnn.benchmark = True
                    lib_ms = graph_ms(cs.bank_library(x, params))
                    torch.backends.cudnn.benchmark = False
                ms2 = graph_ms(lambda: resblock.resblock_bank(x, packed, ks, dils))
                row = {"version": args.label, "level": label, "B": B, "L": L, "C": C, "dtype": dname,
                       "ms": min(ms, ms2), "runs_ms": [ms, ms2], "library_ms": lib_ms, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err, "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12}
                if tiled:
                    tl = resblock.bank_tiling(B, L, C, dt, n_sms, ks, dils)
                    row["tiling"] = tl._asdict()
                    row["launch"] = resblock.launch_info(C, dt, tl, ks, dils)
                # a call's kernels: one a dilation (one a bank and dilation before bank_tiling)
                n_kernels = len(dils) * (1 if tiled else len(ks))

                def trace(tag, fn):
                    us = [d for _, d, _ in cs.kernel_trace(fn, n_kernels)[-1]]
                    print(f"[trace] {args.label} {label} B={B} {dname}{tag}: " + " ".join(f"{d:.1f}" for d in us)
                          + f" us, sum {sum(us):.1f}", flush=True)
                    return us

                if args.trace:
                    row["trace_us"] = trace("", lambda: resblock.resblock_bank(x, packed, ks, dils))
                lib = "" if lib_ms is None else f", cuDNN {lib_ms:.4f} ms ({row['ms'] / lib_ms:.2f}x)"
                print(f"[bank] {args.label} {label} B={B} {dname}: kernel {row['ms']:.4f} ms (runs {ms:.4f}, "
                      f"{ms2:.4f}){lib}, bound {bound:.4f} ms ({by}), {row['tflops']:.1f} TFLOP/s, "
                      f"{bound / row['ms']:.1%} of the bound; max abs err {err:.3e}"
                      + (f"; tiling {row['tiling']}, {row['launch']}" if tiled else ""), flush=True)
                if args.sweep and tiled:
                    ref = resblock.resblock_bank_plain(x, params, ks, dils)
                    sweep = {}
                    # every tile at every ring depth, the last step split as the rule splits it; and at the
                    # rule's tile, the last step split the other way
                    variants = [(*t, r) for t in resblock.SWEEP_TILES for r in resblock.SWEEP_RINGS]
                    variants.append((tl.warps, tl.wm, tl.ring, not tl.split))
                    for tile in variants:
                        try:
                            tile_tl = resblock.bank_tiling(B, L, C, dt, n_sms, ks, dils, tile=tile)
                        except ValueError:
                            continue  # does not fit shared memory
                        got = resblock.resblock_bank(x, packed, ks, dils, tile=tile)
                        torch.cuda.synchronize()
                        cs.check_close(f"bank {label} B={B} {dname} tile {tile}", got, ref, *cs.BANK_BOUNDS[dname])
                        del got
                        tag = "%dw/%d r%d" % tile[:3] + (" split" if tile_tl.split else "")
                        sweep[tag] = graph_ms(lambda: resblock.resblock_bank(x, packed, ks, dils, tile=tile))
                        if args.trace:
                            trace(" " + tag, lambda: resblock.resblock_bank(x, packed, ks, dils, tile=tile))
                    del ref
                    row["sweep_ms"] = sweep
                    best = sorted(sweep.items(), key=lambda kv: kv[1])[:6]
                    print(f"[sweep] {label} B={B} {dname}: best " + ", ".join(f"{k} {v:.4f}" for k, v in best)
                          + "; all " + " ".join(f"{k}={v:.4f}" for k, v in sweep.items()), flush=True)
                rows.append(row)
                del x, params, packed
            del x32, params32
            torch.cuda.empty_cache()
    main_levels = {s[0] for s in cs.BANK_SHAPES}
    for B in sorted({r["B"] for r in rows}):
        for dname in args.dtypes.split(","):
            sel = [r for r in rows if r["B"] == B and r["dtype"] == dname and r["level"] in main_levels]
            if not sel:
                continue
            lib = sum(r["library_ms"] or 0.0 for r in sel)
            print(f"[bank] {args.label} B={B} {dname}, {len(sel)} main levels: kernel "
                  f"{sum(r['ms'] for r in sel):.4f} ms, cuDNN {lib:.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in sel):.4f} ms", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(json.dumps({"device": smi, "version": args.label, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
