"""One process of the port's multi-process batched step.

Started N times by ``tests/test_torch_port_distributed.py`` (on the CPU, the
passthrough geometry) and by ``chip_smoke.py``'s mesh phase (on a card, full
width, ``--full-width``). Each process brings up ``torch.distributed``
(``parallel.distributed.initialize``), builds the global mesh over every
process's 4 devices (``--device`` named 4 times), checks
``local_stream_slots``, steps the data rows it feeds of one batched step of
``4 * N`` streams, and all-gathers the outputs; rank 0 writes them with the
16 kHz rings to ``<outdir>``. The inputs come from seed 0 in every process,
so the parent can step the same streams in one process and compare.

With one process, ``initialize`` is a no-op; the worker then brings a group
of one up itself over ``--backend`` (``nccl`` on a card) and all-gathers a
tensor once, on the device, to show that the backend runs.

    python tests/torch_distributed_worker.py <rank> <nprocs> <port> <outdir> \\
        [--device cuda:0] [--full-width] [--backend gloo|nccl]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from obs_rvc_tpu_torch.config import ChunkConfig  # noqa: E402
from obs_rvc_tpu_torch.parallel import distributed, shard_controls, shard_params, shard_state  # noqa: E402
from obs_rvc_tpu_torch.parallel.sharding import gather_rows, step_rows  # noqa: E402
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState  # noqa: E402

#: devices each process names
LOCAL = 4


def inputs(cfg, n_streams):
    """The chunks every process (and the parent) steps: seed 0, ``[B, N]``."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n_streams, cfg.sample_frame_size)) * 0.1).astype(np.float32)


def config(full_width: bool) -> ChunkConfig:
    if full_width:
        return ChunkConfig.build()
    return ChunkConfig.build(sample_rate=48000, sample_length=0.10, extra_inference_time=0.50, skip_inference=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--full-width", action="store_true", help="the default geometry and full-width networks")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    # float32 as the parent computes it: no TF32 in the convolutions and products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.nprocs == 1:
        # initialize() is a no-op for one process: a group of one, to run the backend itself
        dist.init_process_group(args.backend, init_method=f"tcp://localhost:{args.port}", world_size=1, rank=0)
        x = torch.arange(4.0, device=args.device)
        out = [torch.empty_like(x)]
        dist.all_gather(out, x)
        assert torch.equal(out[0].cpu(), torch.arange(4.0)), out
        dist.destroy_process_group()
        print(f"worker {args.rank} ok: {args.backend} all_gather at world size 1 on {args.device}", flush=True)
        return

    distributed.initialize(f"localhost:{args.port}", args.nprocs, args.rank, backend=args.backend)
    assert dist.is_initialized() and dist.get_world_size() == args.nprocs
    local = [args.device] * LOCAL
    mesh = distributed.global_mesh(n_model=1, local_devices=local)
    assert mesh.shape == {"data": LOCAL * args.nprocs, "model": 1}, mesh.shape
    assert distributed.local_stream_slots(mesh) == LOCAL
    # with model=2, the first-model-shard convention gives each process half as many rows
    assert distributed.local_stream_slots(distributed.global_mesh(n_model=2, local_devices=local)) == LOCAL // 2

    cfg = config(args.full_width)
    pipe = RvcPipeline(cfg, device=args.device)
    if args.full_width:
        pipe.init_params(0, std=None)
    B = LOCAL * args.nprocs
    dev = torch.device(args.device)
    state = StreamState.init_batch(cfg, B, device=dev)
    chunks = torch.from_numpy(inputs(cfg, B)).to(dev)
    controls = StepControls.stack([StepControls.default()] * B, dev)
    rows = shard_params(pipe, mesh)
    assert sum(r is not None for r in rows) == LOCAL
    with torch.no_grad():
        new, outs = step_rows(rows, shard_state(state, mesh), shard_state(chunks, mesh), shard_controls(controls, mesh))
    mine = [gather_rows(outs), gather_rows([s and s.input_buffer_16k for s in new])]
    full = []
    for t in mine:
        parts = [torch.empty_like(t) for _ in range(args.nprocs)]
        dist.all_gather(parts, t)
        full.append(torch.cat(parts).numpy())
    if args.rank == 0:
        np.save(os.path.join(args.outdir, "dist_out.npy"), full[0])
        np.save(os.path.join(args.outdir, "dist_buf16.npy"), full[1])
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {args.rank} ok: rows {[r for r in range(len(rows)) if rows[r] is not None]}", flush=True)


if __name__ == "__main__":
    main()
