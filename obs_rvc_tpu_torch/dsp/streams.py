"""The stream axis the DSP functions share: leading axes are streams, the
counterpart of what ``jax.vmap`` gives the JAX functions."""

from __future__ import annotations

import torch


def per_stream(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 0-d control, or one per stream ``[B]``, shaped to broadcast over
    ``like`` (``[B, ...]``) stream by stream."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))
