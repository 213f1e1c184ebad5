"""obs_rvc_tpu_torch — the streaming voice-conversion step in PyTorch and CUDA.

A port of ``obs_rvc_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, held
against that package module by module:

- ``config``  chunk geometry (the same frame-size algebra)
- ``dsp``     resampling, log-mel, f0 decode, envelope mixing, SOLA
- ``models``  ContentVec, RMVPE and the RVC synthesizer, with ``weights``
              to load parameters in the JAX package's layout
- ``ops``     hand-written CUDA kernels (``csrc/``) for the RMVPE U-Net
              chain and the NSF resblock bank, each beside its plain version
- ``stream``  the per-chunk step and offline conversion

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from obs_rvc_tpu_torch.config import ChunkConfig, RvcModelVersion

__all__ = ["ChunkConfig", "RvcModelVersion"]
