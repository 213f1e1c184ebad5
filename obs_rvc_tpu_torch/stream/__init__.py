"""The streaming step and what serves it (counterpart of ``obs_rvc_tpu.stream``):
the pipeline and its state, the host-side session with its ring buffers, the
batched pool of many streams, and the engine behind the reference RPC
protocol."""

from obs_rvc_tpu_torch.stream.engine import EngineError, RvcEngine
from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls, slide_pitch_cache
from obs_rvc_tpu_torch.stream.pool import PoolFullError, StreamPool
from obs_rvc_tpu_torch.stream.scheduler import StreamSession
from obs_rvc_tpu_torch.stream.state import StreamState

__all__ = ["EngineError", "PoolFullError", "RvcEngine", "RvcPipeline", "StepControls", "StreamPool",
           "StreamSession", "StreamState", "slide_pitch_cache"]
