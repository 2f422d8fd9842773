"""Python wrappers of the CUDA kernels in ``csrc/``, each with its plain
PyTorch version and a launch counter (``<wrapper>.launches``;
``fused_gemm.bwd_launches`` for its backward, which counts one per input
operand: that input's dx kernel and its dW kernel). The fused GEMM's wrapper
shares its module's name, so it is imported from the module:
``from .fused_gemm import fused_gemm``."""

from .conv_bn import conv_bn_stats, conv_bn_stats_plain
from .nms import nms_keep, nms_keep_plain

__all__ = ["conv_bn_stats", "conv_bn_stats_plain", "nms_keep",
           "nms_keep_plain"]
