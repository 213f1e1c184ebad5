"""One run of one cell: set-up, a closed-loop window, the traced slice, the
comparison, and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: the networks' sizes, the dtype, the
geometry, the controls, the limits of the comparison) and a traffic mix
(``benchmark/traffic/<traffic>.json``: the door, the signal's parameters,
how many chunks are checked and traced). Every metric is a reader
``benchmark/metrics/<name before the first dot>.py`` with ``read(ctx)``;
the harness knows no metric, configuration or mix by name.

The program is driven only through its public entry points: an
``RvcPipeline`` given the benchmark's weights, and a ``StreamSession`` or a
``StreamPool`` fed chunk by chunk, the next as soon as the last is back.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import random
import sys
import time
import types

REPO = pathlib.Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in the process that prints the result
BANNED = ("jax", "jaxlib", "flax", "obs_rvc_tpu")
#: the reading of a comparison whose chunks are not all finite (JSON has no infinity)
NOT_FINITE = 1e30


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 3)."""


def load_spec(root: pathlib.Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str, root: pathlib.Path = REPO) -> types.SimpleNamespace:
    """The cell's entry, its configuration's file and its traffic's file."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return types.SimpleNamespace(cell=cell, conf=conf, cfg=cfg, traffic=traffic)


def metric_names(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a cell reports: ``end_to_end`` ones with ``--trace 0``,
    ``per_layer`` ones with ``--trace 1``; those whose ``workloads`` list the
    cell, or, without that key, that apply to every cell (a per-layer one
    through the end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return [m["name"] for m in e2e]
    moved = {m["name"] for m in e2e}
    return [m["name"] for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, root: pathlib.Path = REPO):
    """The reader module of metric ``name``: ``benchmark/metrics/<name before the first dot>.py`` under ``root``."""
    base = name.split(".")[0]
    path = root / "benchmark" / "metrics" / f"{base}.py"
    if not path.is_file():
        raise RunError(f"metric {name!r} has no reader {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{base}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def sizes(cfg: dict) -> dict:
    """The reference networks' sizes by network name, from a configuration:
    ``contentvec``, the pitch network's (``cfg["pitch"]``), ``synthesizer``."""
    from benchmark.reference.step import network

    out = {}
    for name in ("contentvec", cfg["pitch"], "synthesizer"):
        fields = {k: _tuples(v) for k, v in cfg[name].items() if k not in cfg.get("program_only", [])}
        out[name] = network(name).Size(**fields)
    return out


def geometry(cfg: dict):
    from benchmark.reference.step import Geometry

    return Geometry(**cfg["geometry"])


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class Program:
    """The port at a configuration, with the benchmark's weights, behind the
    traffic's door: ``serve(chunks [S, chunk] numpy)`` → ``[S, chunk]``
    numpy, one chunk of each stream, and the host ms it took."""

    def __init__(self, cfg: dict, traffic: dict, state_dicts: dict, device):
        import torch

        from benchmark.reference.step import network
        from obs_rvc_tpu_torch import models
        from obs_rvc_tpu_torch.config import ChunkConfig
        from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls

        def clock():
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter()

        t0 = clock()
        #: seconds of each part of the program's set-up
        self.timings = {}
        g = cfg["geometry"]
        chunk_cfg = ChunkConfig.build(sample_rate=g["sample_rate"], model_sample_rate=g["model_rate"],
                                      sample_length=g["chunk_s"], fade_length=g["fade_s"],
                                      extra_inference_time=g["context_s"],
                                      feature_dim=cfg["contentvec"]["dim"])
        pitch = cfg["pitch"]
        names = network(pitch).PROGRAM
        kw = {"contentvec_cfg": models.ContentVecConfig(**cfg["contentvec"], tap_layer=cfg["contentvec"]["num_layers"],
                                                        out_dim=cfg["contentvec"]["dim"]),
              "synth_cfg": models.SynthesizerConfig(**{k: _tuples(v) for k, v in cfg["synthesizer"].items()}),
              names["pipeline_kw"]: getattr(models, names["config"])(**cfg[pitch])}
        self.pipe = RvcPipeline(chunk_cfg, device=device, compute_dtype=getattr(torch, cfg["dtype"]),
                                pitch_algorithm=names["pitch_algorithm"], **kw)
        self.timings["construct"] = clock() - t0
        #: the benchmark's state dicts by the program's names of its networks
        by_program = {"contentvec": "contentvec", names["pitch_algorithm"]: pitch, "synthesizer": "synthesizer"}
        for name, module in self.pipe.modules().items():
            module.load_state_dict(state_dicts[by_program[name]], strict=True)
        self.timings["load"] = clock() - t0 - self.timings["construct"]
        c = cfg["controls"]
        controls = StepControls.default(pitch_shift=c["pitch_shift"], rms_mix_rate=c["rms_mix_rate"],
                                        index_rate=c.get("index_rate", 0.0), sid=c.get("sid", 0))
        door = traffic["door"]
        self.kind = door["kind"]
        self.chunk = chunk_cfg.sample_frame_size
        if self.kind == "session":
            from obs_rvc_tpu_torch.stream.scheduler import StreamSession

            self.streams = 1
            self.door = StreamSession(self.pipe, controls, mode=door.get("mode", "staged"),
                                      exec_cache=door.get("exec_cache", False))
        elif self.kind == "pool":
            from obs_rvc_tpu_torch.stream.pool import StreamPool

            self.streams = door["capacity"]
            self.door = StreamPool(self.pipe, capacity=self.streams, batch_min=door.get("batch_min", 1),
                                   default_controls=controls, mode=door.get("mode", "staged"),
                                   exec_cache=door.get("exec_cache", False), io_dtype=door.get("io_dtype", "float32"),
                                   pipelined=door.get("pipelined", False))
            self.slots = [self.door.attach() for _ in range(self.streams)]
        else:
            raise RunError(f"unknown door {self.kind!r}")
        t1 = clock()
        self.door.prepare()
        self.timings["prepare"] = clock() - t1
        #: per pool tick, its phases as the pool timed them
        self.phases = []

    @property
    def errors(self) -> int:
        return self.door.metrics.errors

    def reset(self) -> None:
        """Every stream back to its start: zeroed state, empty rings."""
        if self.kind == "session":
            self.door.clear()
        else:
            for s in self.slots:
                self.door.detach(s)
            self.slots = [self.door.attach() for _ in range(self.streams)]

    def serve(self, chunks):
        """One chunk of every stream in, its converted chunk out: ``(out, ms,
        returned)``, ``returned`` the streams whose whole chunk came back."""
        import numpy as np
        from torch.profiler import record_function

        n = self.chunk
        if self.kind == "session":
            t0 = time.perf_counter()
            with record_function("bm.push"):
                self.door.push_audio(chunks[0])
            with record_function("bm.process_pending"):
                self.door.process_pending(max_chunks=1)
            with record_function("bm.pull"):
                out = self.door.pull_audio(n)
            ms = (time.perf_counter() - t0) * 1e3
            full = out.size == n
            return (out[None] if full else np.zeros((1, n), np.float32)), ms, [full]
        with record_function("bm.push"):
            for s, slot in enumerate(self.slots):
                self.door.push_audio(slot, chunks[s])
        t0 = time.perf_counter()
        with record_function("bm.process_pending"):
            self.door.process_pending()
        with record_function("bm.pull"):
            outs = [self.door.pull_audio(slot, n) for slot in self.slots]
        ms = (time.perf_counter() - t0) * 1e3
        self.phases.append(dict(self.door.last_tick_phases))
        full = [o.size == n for o in outs]
        return np.stack([o if f else np.zeros(n, np.float32) for o, f in zip(outs, full)]), ms, full

    def stage_graphs(self):
        """The stage graphs the window replayed, by stage (staged mode)."""
        return self.pipe.staged_batch_graphs(self.streams).graphs


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(args, t_process: float, device=None, make_program=None, program_hook=None, root: pathlib.Path = REPO,
        max_steps=None, out=sys.stdout, err=sys.stderr) -> int:
    """One run of ``args.workload``. ``device`` None means the card: the run
    refuses to start without as many as the cell asks for. ``make_program``
    ``(cfg, traffic, state_dicts, device)`` puts another program in the
    port's place (the control), ``program_hook`` wraps the built one (the
    tests' planted faults); ``root`` is where ``BENCHMARK.json`` and the
    cells' files are (tests use a copy); ``max_steps`` ends the window early."""
    import numpy as np
    import torch

    from benchmark import judge, weights
    from benchmark.reference import step as refstep
    from benchmark.traffic import generate

    t_imports = time.perf_counter() - t_process
    spec = load_spec(root)
    c = resolve(spec, args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.cell["chips"]:
            raise RunError(f"the cell needs {c.cell['chips']} CUDA card(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        device = torch.device("cuda:0")
    device = torch.device(device)
    on_card = device.type == "cuda"
    geo = geometry(c.cfg)
    net_sizes = sizes(c.cfg)
    rng = random.Random(args.seed)

    door = c.traffic["door"]
    if c.traffic.get("loop", "closed") != "closed":
        raise RunError(f"the harness drives closed loops only, not {c.traffic['loop']!r}")
    n_streams = door.get("capacity", 1)
    t_sig = time.perf_counter()
    signal = generate.voice(c.traffic["signal"], n_streams, geo.sample_rate, geo.chunk, args.seed, device)
    host_signal = signal.cpu().numpy()
    t_sig = time.perf_counter() - t_sig
    per = host_signal.shape[1] // geo.chunk

    def clock():
        if on_card:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = clock()
    sds = weights.make_weights(net_sizes, args.seed, device)
    t_weights = clock() - t0
    prog = (make_program or Program)(c.cfg, c.traffic, sds, device)
    del sds
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if program_hook is not None:
        prog = program_hook(prog)
    t_build = clock() - t0 - t_weights

    def chunks_at(k):
        j = k % per
        return host_signal[:, j * geo.chunk : (j + 1) * geo.chunk]

    for k in range(c.traffic.get("warmup_chunks", 3)):
        prog.serve(chunks_at(k))
    prog.reset()
    prog.phases.clear()
    errors0 = prog.errors
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    # the window: closed loop, the next chunk of every stream as soon as the last is back
    keep = pick_streams(rng, n_streams, c.traffic.get("checked_streams", 1))
    kept = {s: [] for s in keep}
    step_ms, missing, k = [], 0, 0
    t_win = time.perf_counter()
    while time.perf_counter() - t_win < args.seconds and (max_steps is None or k < max_steps):
        o, ms, full = prog.serve(chunks_at(k))
        step_ms.append(ms)
        missing += sum(not f for f in full)
        for s in keep:
            kept[s].append(o[s].copy())
        k += 1
    window_s = time.perf_counter() - t_win
    steps = k
    failed = missing + (prog.errors - errors0)
    window = {"seconds": window_s, "steps": steps, "streams": n_streams, "step_ms": step_ms,
              "chunks": steps * n_streams - missing, "audio_s": (steps * n_streams - missing) * geo.chunk_s,
              "phases": list(prog.phases)}
    print(f"[bm] {args.workload}: set-up {setup_s:.2f} s (imports {t_imports:.2f} s, signal {t_sig:.2f} s, "
          f"weights {t_weights:.2f} s, program {t_build:.2f} s: "
          f"{getattr(prog, 'timings', {})}), window {window_s:.2f} s, step ms p50/p90/p99 "
          f"{'/'.join(f'{_pct(step_ms, q):.3f}' for q in (50, 90, 99))}, "
          f"{steps} steps of {n_streams} stream(s), {failed} failed", file=err)

    trace = stage_ms = None
    if args.trace:
        trace = traced_slice(prog, chunks_at, steps, c.traffic.get("trace_steps", 16), on_card)
        stage_ms = stage_times(prog, on_card)

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    card = _card_line() if on_card else "cpu"
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the comparison, with TF32 off, on fresh weights from the same seed rounded as the program serves them
    t_ref = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sds = weights.make_weights(net_sizes, args.seed, device)
    sds = {name: weights.round_to(sd, getattr(torch, c.cfg["dtype"])) for name, sd in sds.items()}
    controls = refstep.Controls(c.cfg["controls"]["pitch_shift"], c.cfg["controls"]["rms_mix_rate"],
                                c.cfg["controls"].get("sid", 0))
    ref = refstep.build(geo, c.cfg["pitch"], {n: _asdict(s) for n, s in net_sizes.items()}, sds, controls, device)
    del sds
    checked = pick_checked(rng, kept, steps, c.traffic.get("checked", 16))
    finite = all(np.isfinite(e).all() for _, _, e, _ in checked)
    limits = c.cfg.get("limits", {})
    readings = (judge.compare(ref, signal, checked, limits["chunk_limit"], limits["sola_margin"]) if finite
                else {"audio_err": NOT_FINITE, "chunks_off": 1.0})
    ref_s = time.perf_counter() - t_ref
    print(f"[bm] reference: {len(checked)} chunks checked in {ref_s:.2f} s", file=err)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        raise RunError(f"modules the benchmark may not load are loaded: {', '.join(loaded)}")

    checks = {name: {"value": readings[name], "limit": limits.get(name)} for name in judge.COMPARED}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(v["limit"] is not None and v["value"] <= v["limit"] for v in checks.values())

    ctx = types.SimpleNamespace(cell=c.cell, cfg=c.cfg, traffic=c.traffic, setup_s=setup_s, window=window,
                                trace=trace, stage_ms=stage_ms, geometry=geo)
    metrics = {}
    for name in metric_names(spec, args.workload, bool(args.trace)):
        entry = next(m for m in spec["end_to_end"] + spec["per_layer"] if m["name"] == name)
        value = reader(name, root).read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": c.cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": steps * n_streams, "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace["busy_s"], trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["card"] = card
    result["readings"] = {"per_chunk": readings.get("per_chunk"), "reference_s": ref_s, "build_s": t_build}
    result["checks"] = checks
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def _pct(values, q):
    from benchmark.yardstick import percentile

    return percentile(values, q) if values else float("nan")


def _asdict(size) -> dict:
    import dataclasses

    return dataclasses.asdict(size)


def _card_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def pick_streams(rng: random.Random, n_streams: int, n: int) -> list:
    """``n`` streams drawn from the seed, one from each of ``n`` equal blocks
    of the streams (all of them where ``n`` is not less), so that a fault in
    a share of the slots meets the same share of the checked streams."""
    if n >= n_streams:
        return list(range(n_streams))
    edges = [i * n_streams // n for i in range(n + 1)]
    return [rng.randrange(edges[i], edges[i + 1]) for i in range(n)]


def pick_checked(rng: random.Random, kept: dict, steps: int, n: int) -> list:
    """``n`` chunks drawn from the seed among the kept streams' chunks of
    the window, as many from each stream, each stream's last chunk among
    them: ``[(stream, k, emitted_k, emitted_{k-1} or None), ...]``."""
    per = max(1, n // len(kept))
    picks = []
    for s in sorted(kept):
        ks = {steps - 1, *rng.sample(range(steps - 1), min(per - 1, steps - 1))}
        picks += [(s, k) for k in sorted(ks)]
    return [(s, k, kept[s][k], kept[s][k - 1] if k > 0 else None) for s, k in picks]


def traced_slice(prog: Program, chunks_at, start: int, steps: int, on_card: bool) -> dict:
    """A profiler trace of ``steps`` more steps after the window: the device
    operations, the benchmark's own ranges around its calls, the busy
    time, and the breakdown (the device operations that took most time, the
    longest idle gaps named by the range the host was in)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import yardstick

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        prog.serve(chunks_at(start))  # the tracer can miss the first kernels: this step is not counted
        if on_card:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with torch.profiler.record_function("bm.slice"):
            for k in range(steps):
                prog.serve(chunks_at(start + 1 + k))
            if on_card:
                torch.cuda.synchronize()
    events = prof.events()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("bm.")]
    sl = [r for r in ranges if r[0] == "bm.slice"][-1]
    start_us, end_us = sl[1], sl[2]
    # the device side of the benchmark's own ranges (user annotations) is no device work
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("bm.")
              and start_us <= e.time_range.start and e.time_range.end <= end_us]
    spans = [(s, e) for _, s, e in device]
    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    inner = [r for r in ranges if r[0] != "bm.slice" and start_us <= r[1] <= end_us]
    labelled = []
    for gs, ge in yardstick.gaps(spans, start_us, end_us):
        mid = 0.5 * (gs + ge)
        around = [r for r in inner if r[1] <= mid <= r[2]]
        labelled.append([min(around, key=lambda r: r[2] - r[1])[0] if around else "bm.loop", (ge - gs) / 1e6])
    return {"device": device, "start": start_us, "end": end_us, "steps": steps,
            "busy_s": yardstick.busy(spans) / 1e6, "window_s": (end_us - start_us) / 1e6,
            "breakdown": {"device_ops": sorted(([n[:160], s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
                          "idle_gaps": sorted(labelled, key=lambda x: -x[1])[:10]}}


def stage_times(prog: Program, on_card: bool) -> dict:
    """Each stage graph's device ms, replayed alone on the arguments the
    last step left in it: CUDA events around back-to-back replays queued
    behind a spin kernel (a copy of ``utils/benchlib.py:replay_ms``)."""
    if not on_card:
        return None
    import torch

    out = {}
    for name, graph in prog.stage_graphs().items():
        graph.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10**7)
        a.record()
        for _ in range(20):
            graph.replay()
        b.record()
        b.synchronize()
        out[name] = a.elapsed_time(b) / 20
    return out
