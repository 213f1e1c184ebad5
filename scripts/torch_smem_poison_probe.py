"""Whether the port's hand kernels read shared memory they never wrote: a
kernel that fills every SM's shared memory with NaN runs on the stream just
before each C call of the chain, bank and log-mel kernels, and the voiced
stream of ``chip_smoke.py`` (24 chunks) through the eager step at full width
is held bit for bit, piece by piece, against the same stream without it.
A kernel that reads a shared-memory word it did not write first reads what
the last kernel on that SM left there, so its output moves (or turns NaN).
On a card, in float32 (cuDNN held to its deterministic algorithms) and
bfloat16.

    PYTHONPATH=. python3 scripts/torch_smem_poison_probe.py

Writes ``chiprun_out/smem_poison.json``.
"""
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from obs_rvc_tpu_torch.config import ChunkConfig  # noqa: E402
from obs_rvc_tpu_torch.models.checkpoints import cast_params_for_serving  # noqa: E402
from obs_rvc_tpu_torch.ops import _cuda  # noqa: E402
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls  # noqa: E402
from torch_engine_choice_probe import first_difference  # noqa: E402
from torch_poison_probe import recorded_stream  # noqa: E402

POISON_SRC = r"""
#include <cuda_runtime.h>
__global__ void fill_smem(unsigned int word, int words) {
  extern __shared__ unsigned int s[];
  volatile unsigned int* v = s;
  for (int i = threadIdx.x; i < words; i += blockDim.x) v[i] = word;
}
extern "C" int poison_smem(int blocks, void* stream) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaError_t e = cudaFuncSetAttribute(fill_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  fill_smem<<<blocks, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(0x7fc07fc0u, bytes / 4);
  return (int)cudaGetLastError();
}
"""


def build_poison() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "libsmem_poison.so"
    src = _cuda.BUILD_DIR / "smem_poison.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(POISON_SRC)
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.poison_smem.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.poison_smem.restype = ctypes.c_int
    return lib


def main() -> int:
    _cuda.build()
    poison = build_poison()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    real_function = _cuda.function
    state = {"on": False, "calls": 0}

    def poisoned_function(name, symbol, argtypes):
        fn = real_function(name, symbol, argtypes)
        if "launch_info" in symbol:
            return fn

        def call(*args):
            if state["on"]:
                _cuda.check(poison.poison_smem(4 * n_sms, args[-1]), "poison_smem")
                state["calls"] += 1
            return fn(*args)

        return call

    _cuda.function = poisoned_function
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    cfg = ChunkConfig.build()
    wav = torch.from_numpy(cs.voiced_signal(cs.N_CHUNKS * cfg.sample_frame_size, cfg.sample_rate))
    chunks = [wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size].cuda() for i in range(cs.N_CHUNKS)]
    controls = StepControls.default()
    report = {"device": smi}
    for dtype in ("float32", "bfloat16"):
        pipe = RvcPipeline(cfg, compute_dtype=getattr(torch, dtype))
        pipe.init_params(cs.SEED, std=None)
        if dtype == "bfloat16":
            cast_params_for_serving(pipe)
        clean = recorded_stream(pipe, chunks, controls, None)
        per_step = len(clean) // len(chunks)
        for on in (False, True):
            state["on"], state["calls"] = on, 0
            got = recorded_stream(pipe, chunks, controls, None)
            state["on"] = False
            d = first_difference(clean, got, per_step)
            finite = all(bool(torch.isfinite(t.float()).all()) for _, ts in got for t in ts)
            report[f"{dtype} poisoned={on}"] = {"first_difference": d, "all_finite": finite, "poisons": state["calls"]}
            print(f"{dtype}, shared memory poisoned before each hand-kernel call: {on} ({state['calls']} poisons): "
                  f"first piece that differs from the clean stream: {d}; all finite: {finite}", flush=True)
        del pipe, clean
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "smem_poison.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
