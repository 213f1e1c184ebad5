"""Shared layers of the port's networks (counterpart of ``obs_rvc_tpu/models/layers.py``).

The JAX package needs wrappers to reproduce PyTorch's transposed-convolution
and weight layouts; here those are PyTorch's own modules, so what remains
is the leaky-ReLU slope, the channel-first LayerNorm of VITS, and two norms
that keep flax's rule for a compute dtype where PyTorch's would not.

A network computes in the dtype of its weights (``RvcPipeline`` builds it in
its ``compute_dtype``). Flax's norms with ``dtype`` set compute their
statistics and the affine map in float32 and cast the result to ``dtype``
(``flax/linen/normalization.py``: ``_compute_stats`` promotes the input to
float32, ``_normalize`` casts at the end). PyTorch's LayerNorm and BatchNorm
kernels do the same with a bfloat16 input and bfloat16 parameters (float32
accumulation, one rounding at the output; held on the CPU by
``tests/test_torch_port_bf16.py`` and on the card by
``tests/test_torch_port_cuda.py``), so the port's networks use them as they
are. PyTorch's GroupNorm does on the CPU, but not on the card (a third of
its bf16 outputs off by up to 22 bf16 steps on an H100): :class:`GroupNorm`
computes in float32 itself. A BatchNorm in inference mode has no statistics
to compute: flax normalises with the stored running values (rounded to
bfloat16 by ``cast_params_for_serving``) in the promoted type of input and
values, float32 for RMVPE's first norm, which takes the float32 mel; so
does :class:`BatchNorm2d`. CREPE's BatchNorms take inputs in their own
dtype, so they are ``nn.BatchNorm1d`` (eps 1e-3); FCPE's last-axis
LayerNorms are ``nn.LayerNorm`` and its GroupNorm is :class:`GroupNorm`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

#: HiFiGAN's leaky-ReLU slope.
LRELU_SLOPE = 0.1


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computed in float32 and rounded once to the
    parameters' dtype, on every device."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(self.weight.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` in inference mode that also takes an input of
    another dtype than its parameters: it then normalises in float32 over
    the stored values and returns the parameters' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.batch_norm(x.float(), self.running_mean.float(), self.running_var.float(), self.weight.float(),
                            self.bias.float(), False, 0.0, self.eps).to(self.weight.dtype)


class VitsLayerNorm(nn.Module):
    """VITS ``modules.LayerNorm``: normalises the channel axis of ``[B, C, T]``,
    parameters ``gamma``/``beta``, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, -1)
        x = F.layer_norm(x, (self.channels,), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)
