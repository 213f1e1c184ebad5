"""Hand-written CUDA kernels for the step's hot ops, each beside its plain
PyTorch version (counterpart of ``obs_rvc_tpu.ops``).

- :mod:`stft_mel` — the RMVPE log-mel frontend, framing to log
  (``csrc/stft_mel.cu``), at keyshift 0.
- :mod:`unet_block` — one RMVPE U-Net level's ConvBlockRes chain
  (``csrc/unet_block.cu``), for every level ``pallas_unet_max_ch`` routes
  (C up to 256, Cin up to 512).
- :mod:`resblock` — one NSF upsample level's resblock bank
  (``csrc/resblock.cu``), for the 16<=C<=64 levels.
- :mod:`crepe_conv` — CREPE's conv1 and conv2 blocks (conv, ReLU,
  BatchNorm, pool) in bfloat16 (``csrc/crepe_conv.cu``), a kernel of the
  port's own: the JAX package leaves CREPE to XLA.

A wrapper runs the plain version on a CPU tensor and the kernel on a CUDA
tensor; its module's ``LAUNCHES`` counts the calls that launched the kernel.
:func:`conv_rounded` is a convolution rounded as the Pallas kernels (and
flax's ``Conv``) round it in bfloat16.
"""

from obs_rvc_tpu_torch.ops._mma import conv_rounded
from obs_rvc_tpu_torch.ops.resblock import resblock_bank, resblock_bank_plain
from obs_rvc_tpu_torch.ops.stft_mel import log_mel, log_mel_plain
from obs_rvc_tpu_torch.ops.unet_block import conv_block_res_chain, conv_block_res_chain_plain, fold_bn

__all__ = [
    "conv_block_res_chain",
    "conv_block_res_chain_plain",
    "conv_rounded",
    "fold_bn",
    "log_mel",
    "log_mel_plain",
    "resblock_bank",
    "resblock_bank_plain",
]
