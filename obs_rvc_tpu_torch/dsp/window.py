"""Window functions and 1-D padding (counterpart of ``obs_rvc_tpu/dsp/window.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window_periodic(window_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, ``0.5*(1-cos(2*pi*i/n))``."""
    i = np.arange(window_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / float(window_length)))
    return torch.tensor(w, dtype=torch.float32, device=device)


def fade_windows(sola_buffer_frame_size: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Equal-power crossfade windows: ``fade_in = sin(linspace(0,1)*pi/2)**2``,
    ``fade_out = 1 - fade_in``."""
    x = np.linspace(0.0, 1.0, sola_buffer_frame_size, dtype=np.float64)
    fade_in = np.sin(x * 0.5 * np.pi) ** 2
    fade_out = 1.0 - fade_in
    return (
        torch.tensor(fade_in, dtype=torch.float32, device=device),
        torch.tensor(fade_out, dtype=torch.float32, device=device),
    )


def pad_reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad both ends of a 1-D signal without repeating the edge sample."""
    return F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
