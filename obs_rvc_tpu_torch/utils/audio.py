"""Host-side audio I/O and channel mixing (counterpart of
``obs_rvc_tpu/utils/audio.py``).

Channel mixing as the plugin does it (average N channels → mono; copy mono →
all channels). WAV I/O on the standard library's ``wave``: PCM16/24/32 and
float32 in, PCM16 out.
"""

from __future__ import annotations

import pathlib
import wave

import numpy as np


def downmix_to_mono(audio: np.ndarray) -> np.ndarray:
    """``[channels, n]`` (or ``[n]``) float audio → mono average."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        return audio.astype(np.float32)
    return audio.mean(axis=0).astype(np.float32)


def upmix_from_mono(mono: np.ndarray, channels: int) -> np.ndarray:
    """mono ``[n]`` → ``[channels, n]`` by copying."""
    return np.broadcast_to(np.asarray(mono, np.float32), (channels, mono.shape[-1])).copy()


def read_wav(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 ``[channels, n]`` in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # Heuristically detect IEEE float (wave module reports only width)
        ints = np.frombuffer(raw, dtype="<i4")
        floats = np.frombuffer(raw, dtype="<f4")
        if np.isfinite(floats).all() and np.abs(floats).max(initial=0.0) <= 16.0:
            data = floats.astype(np.float32)
        else:
            data = ints.astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")

    return data.reshape(-1, ch).T, sr


def write_wav(path: str | pathlib.Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float audio (``[n]`` or ``[channels, n]``) as PCM16 WAV."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(audio.T, -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
