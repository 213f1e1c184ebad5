"""Host-side helpers (counterpart of ``obs_rvc_tpu.utils``)."""

from obs_rvc_tpu_torch.utils.audio import downmix_to_mono, read_wav, upmix_from_mono, write_wav
from obs_rvc_tpu_torch.utils.flops import (
    chunk_gflops,
    contentvec_gflops,
    crepe_gflops,
    fcpe_gflops,
    pipeline_gflops_per_chunk,
    rmvpe_gflops,
    synth_gflops,
)

__all__ = ["chunk_gflops", "contentvec_gflops", "crepe_gflops", "downmix_to_mono", "fcpe_gflops",
           "pipeline_gflops_per_chunk", "read_wav", "rmvpe_gflops", "synth_gflops", "upmix_from_mono", "write_wav"]
