"""The PyTorch port's eager step on one CUDA card: p50/p95 over 20 steady
chunks of 24, float32 and bfloat16, at full width on random weights from
seed 0 (as ``chip_smoke.py``'s main phase streams them).

    python3 scripts/torch_eager_ab.py .     # from a checkout's root

To compare two commits on one card, unpack the other into a directory and
run the script from each root in turns (A, B, B, A): the host's noise in
the eager step is wide, so only turns within one machine compare.
"""
import sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving
from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

_cuda.build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cfg = ChunkConfig.build()
wav = torch.from_numpy(cs.voiced_signal(24 * cfg.sample_frame_size, cfg.sample_rate))
chunks = [wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size].cuda() for i in range(24)]
for dtype in (torch.float32, torch.bfloat16):
    pipe = RvcPipeline(cfg, compute_dtype=dtype)
    pipe.init_params(0, std=None)
    if dtype == torch.bfloat16:
        cast_params_for_serving(pipe)
    state, times = pipe.new_state(), []
    controls = StepControls.default()
    with torch.no_grad():
        for c in chunks:
            t0 = time.perf_counter()
            state, out = pipe.step(state, c, controls)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    steady = np.asarray(times[4:])
    print(f"{sys.argv[1]} {dtype}: eager step p50 {np.percentile(steady, 50):.2f} ms, p95 {np.percentile(steady, 95):.2f} ms", flush=True)
    del pipe
    torch.cuda.empty_cache()
