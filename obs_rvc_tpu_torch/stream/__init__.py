"""The streaming step (counterpart of ``obs_rvc_tpu.stream``)."""

from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls, slide_pitch_cache
from obs_rvc_tpu_torch.stream.state import StreamState

__all__ = ["RvcPipeline", "StepControls", "StreamState", "slide_pitch_cache"]
