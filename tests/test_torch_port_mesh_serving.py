"""The port's serving on a mesh (``StreamPool(mesh=)`` and the stream server
over it) against the one-device pool and the JAX package's mesh pool, on the
CPU: the counterparts of ``tests/test_mesh_serving.py``.

The port's meshes name the CPU eight times (the JAX side runs on the 8
virtual CPU devices of ``tests/conftest.py``). Reduced widths and the JAX
mesh tests' short geometry (0.10 s chunks, 0.5 s of context). Tolerances:
the port's mesh pool against its one-device pool 2e-4 (the JAX mesh tests'
own), against the JAX mesh pool 2e-3 (the step's, ``test_torch_port_batch.py``);
mesh fused against mesh staged 1e-6.
"""

import socket
import threading
import time

import numpy as np
import pytest
import jax
import torch

from obs_rvc_tpu.parallel import make_mesh as j_make_mesh
from obs_rvc_tpu.parallel import parse_mesh_spec as j_parse_mesh_spec
from obs_rvc_tpu.stream import StreamPool as JStreamPool

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.parallel import make_mesh, parse_mesh_spec
from obs_rvc_tpu_torch.parallel.mesh import Mesh
from obs_rvc_tpu_torch.serve.stream_server import StreamClient, _PoolSlotAdapter, serve_connection
from obs_rvc_tpu_torch.stream import RvcPipeline, StreamPool

from test_torch_port_batch import voiced
from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_parallel import mesh_pipes  # noqa: F401 (module fixture)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU8 = ["cpu"] * 8


def small_cfg(**kw):
    return ChunkConfig.build(sample_rate=48000, sample_length=0.10, extra_inference_time=0.50, **kw)


def test_parse_mesh_spec():
    """The JAX grammar and errors, over the CPU named eight times (the JAX
    side's 8 virtual devices): the same shapes."""
    for spec in ("data=4,model=2", "model=2", "data=-1,model=4", "data=2", " data = 8 , "):
        assert parse_mesh_spec(spec, devices=CPU8).shape == dict(j_parse_mesh_spec(spec).shape), spec
    assert parse_mesh_spec("model=2", default_data=1, devices=CPU8).shape == {"data": 1, "model": 2}
    assert parse_mesh_spec("model=2", devices=CPU8).rows()[0] == [torch.device("cpu")] * 2
    for bad in ("rows=2", "data"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad, devices=CPU8)
        with pytest.raises(ValueError):
            j_parse_mesh_spec(bad)
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        parse_mesh_spec("data=8,model=2", devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_model=3, devices=CPU8)


def test_pool_mesh_validation(mesh_pipes):
    pipe = RvcPipeline(small_cfg(skip_inference=True), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        StreamPool(pipe, capacity=3, mesh=make_mesh(n_data=4, n_model=2, devices=CPU8))
    with pytest.raises(ValueError, match="axes"):
        StreamPool(pipe, capacity=4, mesh=Mesh(np.array(["cpu"] * 4), ("rows",)))
    pool = StreamPool(pipe, capacity=8, mesh=make_mesh(n_data=4, n_model=2, devices=CPU8))
    assert [(r.lo, r.hi) for r in pool._rows] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    # a row with more than one model entry is planned as per-device segments on the devices it
    # names (on a card, whether they are distinct cards or one named twice); here the CPU's
    _, _, tpipe = mesh_pipes
    mesh = make_mesh(n_data=1, n_model=2, devices=CPU8)
    pool = StreamPool(tpipe, capacity=2, mesh=mesh, mode="fused")
    row = pool._rows[0]
    assert row.pipeline.segmented and not tpipe.segmented and row.other_streams == []
    s = pool.attach()
    pool.push_audio(s, np.zeros(tpipe.cfg.sample_frame_size, np.float32))
    with torch.no_grad():
        assert pool.process_pending() == 1
    segments = row.fused_step.segments
    layers = tpipe.contentvec_cfg.tap_layer
    want = ["pre", "features/embed"]
    for i in range(layers):
        want += [f"features/layer{i}/attn0", f"features/layer{i}/attn1", f"features/layer{i}/attn_sum",
                 f"features/layer{i}/ffn0", f"features/layer{i}/ffn1", f"features/layer{i}/ffn_sum"]
    want += ["features/head", "after_features"]
    assert list(segments) == want
    shard = row.pipeline.contentvec.encoder.layers[0].self_attn.shards
    assert [segments[f"features/layer0/attn{i}"].device for i in range(2)] == [d for d in mesh.rows()[0]] \
        == [sh.device for sh in shard]


def _drive_pool(pool, wavs, n_chunks, starve=None):
    """Feed per-slot waveforms chunk by chunk through direct ticks, slot
    ``starve[0]`` starved after ``starve[1]`` chunks until tick
    ``starve[2]``; returns per-slot outputs (as the JAX test drives its pools)."""
    chunk = pool.pipeline.cfg.sample_frame_size
    slots = [pool.attach() for _ in wavs]
    fed = [0] * len(wavs)
    ticks = 0
    with torch.no_grad():
        while min(fed) < n_chunks:
            for k, s in enumerate(slots):
                starving = starve is not None and k == starve[0] and fed[k] == starve[1] and ticks < starve[2]
                if not starving and fed[k] < n_chunks:
                    pool.push_audio(s, wavs[k][fed[k] * chunk : (fed[k] + 1) * chunk])
                    fed[k] += 1
            ticks += 1
            pool.process_pending()
    return [pool.pull_audio(s, n_chunks * chunk) for s in slots]


def test_stream_pool_mesh_matches_single_device_and_jax(mesh_pipes):
    """Staged pools of 4: the port's on a 4x2 mesh (a slot a data row,
    ContentVec split in two) against the port's one-device pool and against
    the JAX pool on its 4x2 mesh, across a starved tick; then a slot
    attached mid-run streams as it does on one device."""
    jpipe, params, tpipe = mesh_pipes
    cfg = tpipe.cfg
    chunk, n_chunks = cfg.sample_frame_size, 4
    wavs = [voiced(n_chunks * chunk, cfg.sample_rate, f0, seed=k) for k, f0 in enumerate((170.0, 230.0))]

    one = StreamPool(tpipe, capacity=4)
    ref = _drive_pool(one, wavs, n_chunks, starve=(0, 2, 2))
    mesh = StreamPool(tpipe, capacity=4, mesh=make_mesh(n_data=4, n_model=2, devices=CPU8))
    assert len(mesh._rows) == 4 and all(r.states.input_buffer.shape[0] == 1 for r in mesh._rows)
    got = _drive_pool(mesh, wavs, n_chunks, starve=(0, 2, 2))
    jgot = _drive_pool(JStreamPool(jpipe, params, capacity=4, mesh=j_make_mesh(n_data=4, n_model=2)), wavs,
                       n_chunks, starve=(0, 2, 2))
    for k, (r, g, j) in enumerate(zip(ref, got, jgot)):
        assert r.size == g.size == n_chunks * chunk
        np.testing.assert_allclose(g, r, atol=2e-4, err_msg=f"slot {k}: mesh vs one device")
        np.testing.assert_allclose(g, j, atol=2e-3, err_msg=f"slot {k}: port mesh vs JAX mesh")
    assert max(np.abs(j).max() for j in jgot) > 1e-3

    # attach after traffic: the new slot starts from zeros on its row, the others keep theirs
    late = voiced(2 * chunk, cfg.sample_rate, 200.0, seed=9)
    outs = []
    for pool in (one, mesh):
        s = pool.attach()
        assert s == 2
        with torch.no_grad():
            for i in range(2):
                pool.push_audio(s, late[i * chunk : (i + 1) * chunk])
                pool.process_pending()
        outs.append(pool.pull_audio(s, 2 * chunk))
    assert outs[0].size == 2 * chunk
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-4)


def test_stream_pool_mesh_fused_matches_staged():
    """On a 4x2 mesh, the fused pool (one graph a row a tick, the merge
    inside) gives the staged pool's outputs, across a starved tick, on the
    float32 wire and with pipelined ticks, shared through the exec cache."""
    pipe = RvcPipeline(small_cfg(skip_inference=True), device="cpu")
    chunk, n_chunks = pipe.cfg.sample_frame_size, 3
    rng = np.random.default_rng(11)
    wavs = [(rng.standard_normal(n_chunks * chunk) * 0.1).astype(np.float32) for _ in range(3)]
    mesh = make_mesh(n_data=4, n_model=2, devices=CPU8)
    staged = _drive_pool(StreamPool(pipe, capacity=4, mesh=mesh), wavs, n_chunks, starve=(1, 1, 2))
    fused_pool = StreamPool(pipe, capacity=4, mesh=mesh, mode="fused", exec_cache=True)
    fused = _drive_pool(fused_pool, wavs, n_chunks, starve=(1, 1, 2))
    piped_pool = StreamPool(pipe, capacity=4, mesh=mesh, mode="fused", pipelined=True)
    piped = _drive_pool(piped_pool, wavs, n_chunks, starve=(1, 1, 2))
    piped_pool.flush_pending()
    for k in range(len(wavs)):
        np.testing.assert_allclose(fused[k], staged[k], atol=1e-6)
    for k, s in enumerate(range(len(wavs))):
        delivered = np.concatenate([piped[k], piped_pool.pull_audio(s, n_chunks * chunk)])
        np.testing.assert_allclose(delivered, staged[k], atol=1e-6)
    # a graph per row; with the exec cache, rows of the same devices and weights share one by key
    assert len({id(r.fused_step) for r in piped_pool._rows}) == 4
    assert len({id(r.fused_step) for r in fused_pool._rows}) == 1


def test_stream_server_on_mesh_pool(mesh_pipes):
    """Two clients streamed through the duplex server on a 4x2-mesh pool
    against the same run on the one-device pool (the output is a pure
    function of the input prefix: starved slots freeze)."""
    _, _, tpipe = mesh_pipes
    cfg = tpipe.cfg
    chunk, n_chunks = cfg.sample_frame_size, 4
    t = np.arange(n_chunks * chunk) / cfg.sample_rate
    wavs = [(0.2 * np.sin(2 * np.pi * f * t)).astype(np.float32) for f in (330.0, 550.0)]

    def run(mesh):
        pool = StreamPool(tpipe, capacity=4, mesh=mesh)
        pool.start()
        clients, threads = [], []
        for _ in wavs:
            ssock, csock = socket.socketpair()
            th = threading.Thread(target=serve_connection,
                                  args=(_PoolSlotAdapter(pool, pool.attach()), ssock.makefile("rb"),
                                        ssock.makefile("wb")), daemon=True)
            th.start()
            threads.append(th)
            clients.append(StreamClient(csock.makefile("rb"), csock.makefile("wb")))
        outs = [[] for _ in clients]
        for i in range(0, n_chunks * chunk, chunk):
            for c, client in enumerate(clients):
                outs[c].append(client.send_audio(wavs[c][i : i + chunk]))
            time.sleep(0.002)
        deadline = time.time() + 120
        while min(sum(o.size for o in outs[c]) for c in range(len(clients))) < n_chunks * chunk \
                and time.time() < deadline:
            time.sleep(0.02)
            for c, client in enumerate(clients):
                outs[c].append(client.send_audio(np.zeros(chunk, np.float32)))
        for client in clients:
            client.close()
        for th in threads:
            th.join(timeout=30)
        pool.stop()
        assert pool.metrics.snapshot().errors == 0
        return [np.concatenate(o)[: n_chunks * chunk] for o in outs]

    ref = run(None)
    got = run(make_mesh(n_data=4, n_model=2, devices=CPU8))
    for c in range(len(wavs)):
        assert got[c].size == n_chunks * chunk
        np.testing.assert_allclose(got[c], ref[c], atol=2e-4)
