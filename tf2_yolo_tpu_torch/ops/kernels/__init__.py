"""Python wrappers of the CUDA kernels in ``csrc/``, each with its plain
PyTorch version and a launch counter (``<wrapper>.launches``;
``fused_gemm.bwd_launches`` for its backward, which counts one per input
operand: that input's dx kernel and its dW kernel;
``fused_conv3x3.bwd_launches`` one per backward call), and beside it a
count of the launches (calls) on the tensor cores (``tc_launches``,
``fused_conv3x3.tc_bwd_launches``). The fused GEMM's wrapper
shares its module's name, so it is imported from the module:
``from .fused_gemm import fused_gemm``."""

from .conv_bn import conv_bn_stats, conv_bn_stats_plain
from .nms import (nms_keep, nms_keep_plain, soft_nms_keep,
                  soft_nms_keep_plain)

__all__ = ["conv_bn_stats", "conv_bn_stats_plain", "nms_keep",
           "nms_keep_plain", "soft_nms_keep", "soft_nms_keep_plain"]
