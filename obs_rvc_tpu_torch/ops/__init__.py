"""Hand-written CUDA kernels for the step's hot ops, each beside its plain
PyTorch version (counterpart of ``obs_rvc_tpu.ops``).

- :mod:`unet_block` — one RMVPE U-Net level's ConvBlockRes chain
  (``csrc/unet_block.cu``), for the C<=32 levels.
- :mod:`resblock` — one NSF upsample level's resblock bank
  (``csrc/resblock.cu``), for the 16<=C<=64 levels.

A wrapper runs the plain version on a CPU tensor and the kernel on a CUDA
tensor; its module's ``LAUNCHES`` counts the calls that launched the kernel.
"""

from obs_rvc_tpu_torch.ops.resblock import resblock_bank, resblock_bank_plain
from obs_rvc_tpu_torch.ops.unet_block import conv_block_res_chain, conv_block_res_chain_plain, fold_bn

__all__ = [
    "conv_block_res_chain",
    "conv_block_res_chain_plain",
    "fold_bn",
    "resblock_bank",
    "resblock_bank_plain",
]
