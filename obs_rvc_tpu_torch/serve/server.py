"""One process that brings up every serving front door over one pipeline
(counterpart of ``obs_rvc_tpu/serve/server.py``):

- the duplex PCM stream over TCP (``stream_server``), a session per
  connection, or with ``--pool N`` a slot of one batched
  :class:`~obs_rvc_tpu_torch.stream.pool.StreamPool` per connection
- the same protocol over WebSocket (``ws``)
- the plugin's reference RPC protocol over TCP (``rpc``), on an ``RvcEngine``
  that shares the pipeline's networks
- HTTP ``/healthz`` and ``/metrics`` (``health``), one collector for all sessions

::

    python -m obs_rvc_tpu_torch.serve.server --port 7861 --ws-port 7862 \\
        --rpc-port 17895 --health-port 8080 --model model.pth

The flags are the JAX server's, so a command line carries over, plus
``--device`` (default: the card). A port of 0 turns its front door off.
``--dtype`` defaults to ``bfloat16``, as the JAX server's does (the CLI's to
``float32``). Every session and the RPC engine replay CUDA graphs: before
the server listens it captures the launch geometry's graphs for
``--step-mode`` (a graph per stage for ``staged``, the default; one graph of
the whole step for ``fused``) and the RPC engine's. ``--exec-cache`` shares
the fused step's and the engine's graphs by key within the process
(``utils/exec_cache.py``); the kernels' builds persist across processes
under ``obs_rvc_tpu_torch/_build/`` either way. ``--pitch-algorithm crepe``
or ``fcpe`` (with ``--crepe``/``--fcpe`` checkpoints, random weights without)
serves every door with that pitch network.

``--pool N`` batches the duplex and WebSocket connections through one pool
of ``N`` slots (``batch_min`` N/4, the server's controls as each slot's
defaults, ``--step-mode`` as its mode, ``--exec-cache``), whose tick graphs
are captured before any door listens; ``--pool-io-dtype int16`` and
``--pool-pipelined`` (both need ``--step-mode fused``) are its wire width
and its pipelined ticks. ``/metrics`` then counts the pool's chunks and
shows ``pool_ready``, ``pool_active`` and ``pool_capacity``; a connection
past the capacity is closed. The RPC door stays on its own engine.

``--index`` (with ``--index-mode``, ``--index-dtype``, ``--index-probes``,
``--index-lcap``) gives every session, pool slot and the RPC engine the
retrieval blend; ``--index-rate`` is each stream's starting blend, a live
control like the others (the RPC protocol carries none, so its requests
blend at 0, as the JAX engine's do).

``--mesh data=D,model=M`` serves across a grid of devices (every visible
card by default; with ``--device cpu``, the CPU named
``parallel.mesh.CPU_MESH_DEVICES`` times), by the JAX server's rules: the
networks are sharded once, before any front door is built
(``parallel.shard_params``: ContentVec and an exact table split along
``model``), and every session and the RPC engine step the first data row's
pipeline; ``data`` > 1 needs ``--pool``, whose slots split along ``data``,
a row per group. A row of ``model`` > 1 steps through per-device graph
segments (``stream/pipeline.py``), so its shards may sit on different
cards. A spec the devices cannot hold exits naming their count.
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
from typing import Callable, Optional

from obs_rvc_tpu_torch.serve.cli import add_model_flags, mesh_from_args, pipeline_from_args

logger = logging.getLogger(__name__)

#: seconds to wait for every front door to listen
READY_TIMEOUT_S = 60.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RVC streaming server on the PyTorch port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7861, help="duplex TCP port (0 = off)")
    p.add_argument("--ws-port", type=int, default=0, help="WebSocket port (0 = off)")
    p.add_argument("--health-port", type=int, default=0, help="health/metrics HTTP port (0 = off)")
    p.add_argument("--rpc-port", type=int, default=0, help="reference-compatible RPC port (0 = off)")
    p.add_argument("--pool", type=int, default=0,
                   help="batch the duplex and WebSocket connections through a StreamPool of this capacity "
                        "(0 = a session per connection)")
    p.add_argument("--mesh", default="",
                   help="serve across a device mesh, e.g. 'data=4,model=2': with --pool the slots split along "
                        "data and ContentVec (and an exact table) along model; without --pool the mesh must "
                        "be data=1")
    p.add_argument("--device-sample-rate", type=int, default=48000)
    add_model_flags(p, loudness_default=1.0, dtype_default="bfloat16")
    p.add_argument("--step-mode", default="staged", choices=["staged", "fused"],
                   help="staged: a CUDA graph per stage, replayed in turn; fused: one CUDA graph of the whole "
                        "step (both captured in this process before the server listens)")
    p.add_argument("--pool-io-dtype", default="float32", choices=["float32", "int16"],
                   help="the pool's PCM width to and from the card; int16 casts inside the fused graph "
                        "(needs --step-mode fused)")
    p.add_argument("--pool-pipelined", action="store_true",
                   help="deliver a pool tick's output after the next tick's dispatch, overlapping its copy with "
                        "that tick's compute (needs --step-mode fused)")
    p.add_argument("--exec-cache", action="store_true",
                   help="share the fused step's and the RPC engine's captured graphs by key within this process "
                        "(a CUDA graph cannot be saved; the kernels' builds persist under _build/ regardless)")
    p.add_argument("--stage-timing", action="store_true",
                   help="time every chunk's stages into /metrics' stage_p50_ms, not every few chunks': a CUDA "
                        "event at each stage boundary, no synchronize")
    return p


def build_pipeline(args):
    """``(pipeline, controls)`` from parsed flags."""
    return pipeline_from_args(args, args.device_sample_rate)


def main(argv=None, *, ready: Optional[Callable[[dict], None]] = None,
         stop_event: Optional[threading.Event] = None) -> None:
    """Serve until ``stop_event`` is set (forever without one). ``ready``
    receives ``{"duplex"|"ws"|"rpc"|"health": bound port}`` once every
    front door that is on listens."""
    args = build_parser().parse_args(argv)
    mesh = mesh_from_args(args)
    if mesh is not None:
        print(f"serving on mesh {mesh.shape}", file=sys.stderr)
        if not args.pool and mesh.shape["data"] != 1:
            raise SystemExit("--mesh with data>1 needs --pool (per-connection sessions "
                             "are unbatched; only the pool rides the data axis)")

    from obs_rvc_tpu_torch.serve.health import start_health_server
    from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics
    from obs_rvc_tpu_torch.serve.rpc import serve_tcp as rpc_serve_tcp
    from obs_rvc_tpu_torch.serve.stream_server import serve_tcp
    from obs_rvc_tpu_torch.serve.ws import serve_ws_tcp
    from obs_rvc_tpu_torch.stream import StreamPool, StreamSession
    from obs_rvc_tpu_torch.stream.engine import RvcEngine

    pipe, controls = build_pipeline(args)
    stop = stop_event if stop_event is not None else threading.Event()
    door_pipe = pipe
    if mesh is not None:
        from obs_rvc_tpu_torch.parallel import shard_params

        # sharded once, at the top: the sessions and the engine step the first row, and the
        # pool's own shard_params call returns these rows
        door_pipe = shard_params(pipe, mesh)[0]
    pool = None
    if args.pool:
        pool = StreamPool(pipe, capacity=args.pool, batch_min=max(1, args.pool // 4), default_controls=controls,
                          mode=args.step_mode, exec_cache=args.exec_cache, io_dtype=args.pool_io_dtype,
                          pipelined=args.pool_pipelined, mesh=mesh)
        metrics = pool.metrics
    else:
        # one scrape target aggregating every connection's session
        metrics = ChunkMetrics(chunk_seconds=pipe.cfg.latency_seconds)

    def make_session():
        return StreamSession(door_pipe, controls, mode=args.step_mode, stage_timing=args.stage_timing,
                             metrics=metrics, exec_cache=args.exec_cache)

    # the launch geometry's graphs (or the pool's tick), captured before any door listens
    if pool is not None:
        pool.prepare()
        pool.start()
    elif args.port or args.ws_port:
        make_session().prepare()
    engine = None
    if args.rpc_port:
        engine = RvcEngine(door_pipe, exec_cache=args.exec_cache)
        engine.prepare()

    bound: dict[str, int] = {}
    failed: dict[str, BaseException] = {}
    doors = []

    def door(name, serve, *serve_args, **serve_kwargs):
        listening = threading.Event()

        def on_ready(p):
            bound[name] = p
            listening.set()

        def run():
            try:
                serve(*serve_args, ready=on_ready, stop_event=stop, **serve_kwargs)
            except Exception as e:
                if listening.is_set():
                    # a door that fails while serving ends alone, as a door's
                    # thread does in the JAX server; the others go on serving
                    logger.exception("front door %s failed", name)
                    return
                # a door that cannot listen ends the server
                failed[name] = e
                listening.set()
                stop.set()

        doors.append((threading.Thread(target=run, daemon=True, name=f"rvc-{name}"), listening))

    if args.port:
        door("duplex", serve_tcp, make_session, args.host, args.port, pool=pool)
    if args.ws_port:
        door("ws", serve_ws_tcp, make_session, args.host, args.ws_port, pool=pool)
    if args.rpc_port:
        door("rpc", rpc_serve_tcp, engine, args.host, args.rpc_port)
    health = None
    if args.health_port:
        extra = None
        if pool is not None:
            def extra():
                ready_slots, active = pool.ready_slots()
                return {"pool_ready": ready_slots, "pool_active": active, "pool_capacity": pool.capacity}
        health, bound["health"] = start_health_server(metrics, args.host, args.health_port, extra=extra)
        print(f"health/metrics on {args.host}:{bound['health']}", file=sys.stderr)
    try:
        for t, _ in doors:
            t.start()
        for _, listening in doors:
            if not listening.wait(READY_TIMEOUT_S):
                raise RuntimeError(f"a front door did not listen within {READY_TIMEOUT_S} s")
        if failed:
            raise RuntimeError(f"front doors failed to start: {failed}")
        if ready is not None:
            ready(dict(bound))
        for t, _ in doors:
            t.join()
    finally:
        stop.set()
        for t, _ in doors:
            t.join(timeout=5.0)
        if health is not None:
            health.shutdown()
            health.server_close()
        if pool is not None:
            pool.stop()


if __name__ == "__main__":
    main()
