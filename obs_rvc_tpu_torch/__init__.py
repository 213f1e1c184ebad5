"""obs_rvc_tpu_torch — the streaming voice-conversion step in PyTorch and CUDA.

A port of ``obs_rvc_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, held
against that package module by module:

- ``config``  chunk geometry (the same frame-size algebra) and the plugin's settings
- ``dsp``     resampling, log-mel, f0 decode, envelope mixing, SOLA
- ``models``  ContentVec, RMVPE and the RVC synthesizer, with ``weights``
              to load parameters in the JAX package's layout and
              ``checkpoints`` to load upstream ``.pth``/``.pt`` files
- ``ops``     hand-written CUDA kernels (``csrc/``) for the log-mel
              frontend, the RMVPE U-Net chain and the NSF resblock bank,
              each beside its plain version
- ``stream``  the per-chunk step and offline conversion, the host-side
              session with its ring buffers, and the RPC engine
- ``serve``   the front doors: reference RPC, duplex stream, WebSocket,
              health/metrics, the server that runs them, the offline CLI
- ``parallel`` the ``('data', 'model')`` device mesh: streams split along
              data, ContentVec and the exact retrieval table along model,
              ``torch.distributed`` across processes
- ``utils``   WAV I/O and channel mixing

Entry points run on the card unless the caller passes ``device="cpu"``
(``--device cpu`` on a command line).
"""

from obs_rvc_tpu_torch.config import ChunkConfig, PitchAlgorithm, RvcModelVersion, StreamSettings

__version__ = "0.1.0"

__all__ = ["ChunkConfig", "PitchAlgorithm", "RvcModelVersion", "StreamSettings", "__version__"]
