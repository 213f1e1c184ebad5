"""DSP stages of the streaming step in PyTorch (counterpart of ``obs_rvc_tpu.dsp``)."""

from obs_rvc_tpu_torch.dsp.envelope import envelope_mixing, linear_interpolate_align_corners, rms_envelope
from obs_rvc_tpu_torch.dsp.f0 import apply_pitch_shift, decode_f0, get_f0_post, median_filter_f0
from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram, mel_filterbank
from obs_rvc_tpu_torch.dsp.resample import resample_poly
from obs_rvc_tpu_torch.dsp.sola import phase_vocoder_blend, sola_crossfade, sola_offset
from obs_rvc_tpu_torch.dsp.stft import stft_magnitude
from obs_rvc_tpu_torch.dsp.window import fade_windows, hann_window_periodic

__all__ = [
    "apply_pitch_shift",
    "decode_f0",
    "envelope_mixing",
    "fade_windows",
    "get_f0_post",
    "hann_window_periodic",
    "linear_interpolate_align_corners",
    "median_filter_f0",
    "MelSpectrogram",
    "mel_filterbank",
    "phase_vocoder_blend",
    "resample_poly",
    "rms_envelope",
    "sola_crossfade",
    "sola_offset",
    "stft_magnitude",
]
