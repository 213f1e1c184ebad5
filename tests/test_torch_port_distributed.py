"""The port's multi-process batched step (``parallel/distributed.py``) on
the CPU: the counterpart of ``tests/test_distributed_multiprocess.py``.

Two OS processes, each naming the CPU four times, bring up
``torch.distributed`` over gloo on a free localhost port, build the global
8-row mesh, step the rows they feed (``tests/torch_distributed_worker.py``)
and all-gather the outputs; they are held against the JAX single-process
``vmap`` step on the same seed's chunks at 1e-5, as the JAX test holds its
two processes. No network beyond localhost, a 120 s limit per process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.stream.pipeline import RvcPipeline as JPipeline
from obs_rvc_tpu.stream.pipeline import StepControls as JControls
from obs_rvc_tpu.stream.state import StreamState as JState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(outdir, nprocs=2, extra=(), timeout=120):
    """The worker ``nprocs`` times on one free port; returns their outputs, each asserted to exit 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), str(nprocs), str(port), str(outdir), *extra],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(nprocs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    return outs


def test_two_process_distributed_step(tmp_path):
    outs = run_workers(tmp_path)
    assert "rows [0, 1, 2, 3]" in outs[0] and "rows [4, 5, 6, 7]" in outs[1]
    got = np.load(tmp_path / "dist_out.npy")
    got_buf16 = np.load(tmp_path / "dist_buf16.npy")

    cfg = JChunkConfig.build(sample_rate=48000, sample_length=0.10, extra_inference_time=0.50, skip_inference=True)
    pipe = JPipeline(cfg)
    B = 8
    chunks = (np.random.default_rng(0).standard_normal((B, cfg.sample_frame_size)) * 0.1).astype(np.float32)
    state = JState.init_batch(cfg, B)
    controls = jax.tree.map(lambda *xs: jnp.stack(xs), *[JControls.default() for _ in range(B)])
    step = jax.jit(jax.vmap(pipe.step, in_axes=(None, 0, 0, 0)))
    want_state, want = step({}, state, jnp.asarray(chunks), controls)

    assert got.shape == (B, cfg.sample_frame_size)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_buf16, np.asarray(want_state.input_buffer_16k), atol=1e-5)


def test_one_process_group_runs_its_backend(tmp_path):
    """``initialize`` is a no-op for one process; the worker's group of one
    over gloo all-gathers on the CPU (over nccl, on a card, in ``chip_smoke.py``)."""
    from obs_rvc_tpu_torch.parallel import distributed

    distributed.initialize(num_processes=1)
    import torch.distributed as dist

    assert not dist.is_initialized()
    out = run_workers(tmp_path, nprocs=1, extra=["--backend", "gloo"])
    assert "gloo all_gather at world size 1 on cpu" in out[0]
