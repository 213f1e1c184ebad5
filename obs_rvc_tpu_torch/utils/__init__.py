"""Host-side helpers (counterpart of ``obs_rvc_tpu.utils``)."""

from obs_rvc_tpu_torch.utils.audio import downmix_to_mono, read_wav, upmix_from_mono, write_wav

__all__ = ["downmix_to_mono", "read_wav", "upmix_from_mono", "write_wav"]
