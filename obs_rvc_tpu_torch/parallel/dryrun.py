"""Both mesh shapes at production widths, once each (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``).

For each mesh shape that divides ``n_devices`` (at 8: data=4 x model=2 and
data=2 x model=4), the batched step of one stream a data row runs on the
real sharding rules: ContentVec (768-d, 12 heads, 3072 FFN) split along
``model``, an exact retrieval table of ``n_devices x 64`` rows split by rows
along ``model``, streams along ``data``, the full RMVPE and the 40 kHz
synthesizer on each row's first device. The time geometry is the JAX dry
run's shortened one (0.10 s chunks, 0.50 s of extra context). At model=2 a
fused ``StreamPool`` on the mesh also ticks once with every slot fed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from obs_rvc_tpu_torch.parallel.mesh import make_mesh, visible_devices
from obs_rvc_tpu_torch.parallel.sharding import gather_rows, shard_controls, shard_params, shard_state, step_rows


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Run the mesh shapes of ``n_devices`` devices (``devices``, default
    every visible card; a device may be named more than once). Each check
    that fails raises."""
    devices = list(devices if devices is not None else visible_devices())[:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    for n_model in (2, 4):
        if n_devices % n_model == 0 and n_devices >= 2 * n_model:
            _dryrun_mesh(devices, n_model)
    if n_devices < 4:
        _dryrun_mesh(devices, 2 if n_devices % 2 == 0 else 1)


def _dryrun_mesh(devices: list, n_model: int) -> None:
    from obs_rvc_tpu_torch.config import ChunkConfig, RvcModelVersion
    from obs_rvc_tpu_torch.retrieval import RetrievalIndex
    from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamPool, StreamState

    mesh = make_mesh(n_model=n_model, devices=devices)
    n_data = len(devices) // n_model
    cfg = ChunkConfig.build(sample_rate=48000, model_sample_rate=40000, sample_length=0.10,
                            extra_inference_time=0.50)
    first = torch.device(devices[0])
    pipe = RvcPipeline(cfg, RvcModelVersion.V2, retrieval_index=RetrievalIndex(), device=first)
    pipe.init_params(0)
    table = np.random.default_rng(0).standard_normal((len(devices) * 64, pipe.contentvec_cfg.out_dim))
    pipe.retrieval_index.load(RetrievalIndex.make_params(table.astype(np.float32)), device=first)
    rows = shard_params(pipe, mesh)
    for row, devs in zip(rows, mesh.rows()):
        shards = row.retrieval_index.shards
        if n_model > 1 and (shards is None or len(shards) != n_model
                            or [s.vectors.device for s in shards] != devs):
            raise AssertionError(f"mesh data={n_data} model={n_model}: the table is not split by rows over {devs}")

    B = n_data  # one stream per data row
    state = shard_state(StreamState.init_batch(cfg, B, device=first), mesh)
    chunks = shard_state(torch.zeros(B, cfg.sample_frame_size, device=first), mesh)
    controls = shard_controls(StepControls.stack([StepControls.default()] * B, first), mesh)
    _, outs = step_rows(rows, state, chunks, controls)
    out = gather_rows(outs)
    if out.shape != (B, cfg.sample_frame_size) or not bool(out.isfinite().all()):
        raise AssertionError(f"mesh data={n_data} model={n_model}: output {tuple(out.shape)}, or not finite")
    print(f"dryrun_multichip ok: mesh data={n_data} model={n_model}, B={B}, out={tuple(out.shape)}", flush=True)

    if n_model == 2:
        # the serving surface once: a fused pool on the mesh, every slot fed, one tick
        pool = StreamPool(pipe, capacity=B, mode="fused", mesh=mesh)
        slots = [pool.attach() for _ in range(B)]
        for s in slots:
            pool.push_audio(s, np.zeros(cfg.sample_frame_size, np.float32))
        stepped = pool.process_pending()
        if stepped != B:
            raise AssertionError(f"the pool tick fed {stepped} slots, want {B}")
        for s in slots:
            if pool.pull_audio(s, cfg.sample_frame_size).size != cfg.sample_frame_size:
                raise AssertionError(f"pool slot {s} returned no chunk")
        if len(pool._rows) != n_data:
            raise AssertionError(f"the pool runs {len(pool._rows)} rows, want {n_data}")
        pool.stop()
        print(f"dryrun_multichip pool tick ok: mesh data={n_data} model={n_model}", flush=True)

