"""DSP stages of the streaming step in PyTorch (counterpart of ``obs_rvc_tpu.dsp``)."""

from obs_rvc_tpu_torch.dsp.envelope import envelope_mixing, linear_interpolate_align_corners, rms_envelope
from obs_rvc_tpu_torch.dsp.f0 import (
    CENTS_MAPPING,
    apply_pitch_shift,
    decode_f0,
    get_f0_post,
    median_filter_f0,
    to_local_average_cents,
)
from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram, mel_filterbank
from obs_rvc_tpu_torch.dsp.resample import PolyphaseResampler, resample_poly, resample_poly_dilated
from obs_rvc_tpu_torch.dsp.sola import phase_vocoder_blend, sola_crossfade, sola_offset
from obs_rvc_tpu_torch.dsp.stft import dft_matrices, frame_signal, stft_magnitude
from obs_rvc_tpu_torch.dsp.window import fade_windows, hann_window, hann_window_periodic, pad_constant, pad_reflect

__all__ = [
    "apply_pitch_shift",
    "CENTS_MAPPING",
    "decode_f0",
    "dft_matrices",
    "envelope_mixing",
    "fade_windows",
    "frame_signal",
    "get_f0_post",
    "hann_window",
    "hann_window_periodic",
    "linear_interpolate_align_corners",
    "median_filter_f0",
    "MelSpectrogram",
    "mel_filterbank",
    "pad_constant",
    "pad_reflect",
    "phase_vocoder_blend",
    "PolyphaseResampler",
    "resample_poly",
    "resample_poly_dilated",
    "rms_envelope",
    "sola_crossfade",
    "sola_offset",
    "stft_magnitude",
    "to_local_average_cents",
]
