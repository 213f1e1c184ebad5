"""The three networks of the streaming step in PyTorch (counterpart of
``obs_rvc_tpu.models``): ContentVec features, RMVPE pitch salience and the
RVC synthesizer, with :mod:`weights` to carry parameters across."""

from obs_rvc_tpu_torch.models.contentvec import ContentVec, ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPE, RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import Synthesizer, SynthesizerConfig

__all__ = [
    "ContentVec",
    "ContentVecConfig",
    "RMVPE",
    "RMVPEConfig",
    "Synthesizer",
    "SynthesizerConfig",
]
