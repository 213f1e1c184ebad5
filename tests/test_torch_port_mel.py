"""The fused log-mel frontend: ``ops/stft_mel.py:log_mel_plain`` against the
JAX package's Pallas kernel ``log_mel_pallas`` in interpret mode (as the JAX
package's own tests run it on the CPU), the route through
``MelSpectrogram`` at keyshift 0, and the wrapper's dispatch rules.

Bounds: atol 2e-4 / rtol 1e-4 against the Pallas kernel, the JAX package's
own bound for it against ``MelSpectrogram`` (the DFT's float32 sums in
another order; the log turns their relative error into an absolute one);
silence exactly ``ln(1e-5)`` to 1e-5. The CUDA kernel itself is held
against the plain version in ``test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from obs_rvc_tpu.ops import log_mel_pallas

from obs_rvc_tpu_torch.dsp.mel import MelSpectrogram
from obs_rvc_tpu_torch.dsp.stft import stft_magnitude
from obs_rvc_tpu_torch.ops import stft_mel
from obs_rvc_tpu_torch.stream import StreamState
from obs_rvc_tpu_torch.config import ChunkConfig

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

#: the frontend's constants on the CPU, as the step passes them
MEL = MelSpectrogram(device="cpu")


def log_mel(x):
    return stft_mel.log_mel(x, MEL.mel_basis, MEL.window)


def _voiced_16k(n, seed=0):
    t = np.arange(n) / 16000
    f = 180.0 * 2 ** (0.5 * np.sin(2 * np.pi * 5.0 * t) / 12)
    phase = 2 * np.pi * np.cumsum(f) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("L,kind", [
    (10080, "normal"),   # the main path's window: T = 64
    (9920, "voiced"),    # T = 63, not a multiple of 8
    (48000, "voiced"),   # T = 301: crosses the Pallas kernel's 256-frame tiling
])
def test_log_mel_plain_matches_pallas(L, kind):
    rng = np.random.default_rng(L)
    x = rng.standard_normal(L).astype(np.float32) if kind == "normal" else _voiced_16k(L)
    want = np.asarray(log_mel_pallas(jnp.asarray(x), interpret=True))
    got = log_mel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (128, 1 + L // 160)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_log_mel_plain_silence():
    got = log_mel(torch.zeros(10080 - 160)).numpy()
    assert got.shape == (128, 63)
    np.testing.assert_allclose(got, np.log(1e-5), atol=1e-5)


def test_log_mel_plain_reflects_short_signals_like_numpy():
    """A signal shorter than the 512-sample pad reflects again, as
    ``jnp.pad(mode="reflect")`` does (the kernel's framing does the same)."""
    x = np.linspace(-1.0, 1.0, 100, dtype=np.float32)
    want = np.asarray(log_mel_pallas(jnp.asarray(x), interpret=True))
    got = log_mel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (128, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    idx = stft_mel.reflect_indices(5, 8, 3, 2).numpy()
    padded = np.pad(np.arange(5), 4, mode="reflect")
    np.testing.assert_array_equal(idx, np.stack([padded[0:8], padded[3:11]]))
    assert stft_mel.reflect_indices(1, 4, 1, 2).tolist() == [[0] * 4] * 2


def test_mel_spectrogram_keyshift0_is_unchanged_by_the_route():
    """At keyshift 0 ``MelSpectrogram`` now goes through ``log_mel``; on the
    CPU that is the same arithmetic as before, bit for bit."""
    mel = MelSpectrogram(device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(10080).astype(np.float32) * 0.3)
    mag = stft_magnitude(x, 1024, 160, mel.window).T
    before = torch.log(torch.clamp((mag @ mel.mel_basis.T).T, min=1e-5))
    torch.testing.assert_close(mel(x), before, rtol=0, atol=0)


def test_log_mel_wrapper_takes_the_plain_version_only_on_the_cpu():
    x = torch.from_numpy(_voiced_16k(10080))
    before = stft_mel.LAUNCHES
    out = log_mel(x)
    assert stft_mel.LAUNCHES == before  # the plain version is no launch
    win, basis = MEL.window, MEL.mel_basis
    torch.testing.assert_close(out, stft_mel.log_mel_plain(x, basis, win), rtol=0, atol=0)
    with pytest.raises(ValueError, match="device"):
        stft_mel.log_mel(torch.empty(10080, device="meta"), mel_basis=basis.to("meta"),
                         window=win.to("meta"))


def test_log_mel_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks a CUDA launch runs first, exercised without a card."""
    win, basis = MEL.window, MEL.mel_basis
    with pytest.raises(ValueError, match="contiguous"):
        stft_mel._log_mel_cuda(torch.zeros(20160)[::2], basis, win, 160, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mel._log_mel_cuda(torch.zeros(2, 2, 10080), basis, win, 160, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mel._log_mel_cuda(torch.zeros(10080, 2).T, basis, win, 160, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        stft_mel._log_mel_cuda(torch.zeros(10080, dtype=torch.float64), basis, win, 160, 1e-5)
    with pytest.raises(NotImplementedError, match="1024"):
        stft_mel._log_mel_cuda(torch.zeros(10080), basis[:, :257], torch.ones(512), 160, 1e-5)
    with pytest.raises(ValueError, match="mel_basis"):
        stft_mel._log_mel_cuda(torch.zeros(10080), basis[:, :500], win, 160, 1e-5)
    with pytest.raises(ValueError, match="empty"):
        stft_mel._log_mel_cuda(torch.zeros(0), basis, win, 160, 1e-5)


def test_mel_and_state_put_their_tensors_on_the_card_unless_told_otherwise():
    cfg = ChunkConfig.build()
    if torch.cuda.is_available():
        assert MelSpectrogram().device.type == "cuda"
        assert StreamState.init(cfg).cache_pitchf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MelSpectrogram()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamState.init(cfg)
    assert MelSpectrogram(device="cpu").mel_basis.device.type == "cpu"
    assert StreamState.init(cfg, device="cpu").input_buffer.device.type == "cpu"
