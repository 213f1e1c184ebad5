"""The networks of the streaming step in PyTorch (counterpart of
``obs_rvc_tpu.models``): ContentVec features, the pitch salience of RMVPE,
CREPE or FCPE, and the RVC synthesizer, with :mod:`weights` to carry
parameters across."""

from obs_rvc_tpu_torch.models.contentvec import ContentVec, ContentVecConfig
from obs_rvc_tpu_torch.models.crepe import Crepe, CrepeConfig, extract_crepe_frames
from obs_rvc_tpu_torch.models.fcpe import Fcpe, FcpeConfig, decode_f0_fcpe, fcpe_cent_table
from obs_rvc_tpu_torch.models.rmvpe import RMVPE, RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import Synthesizer, SynthesizerConfig

__all__ = [
    "ContentVec",
    "ContentVecConfig",
    "Crepe",
    "CrepeConfig",
    "Fcpe",
    "FcpeConfig",
    "RMVPE",
    "RMVPEConfig",
    "Synthesizer",
    "SynthesizerConfig",
    "decode_f0_fcpe",
    "extract_crepe_frames",
    "fcpe_cent_table",
]
