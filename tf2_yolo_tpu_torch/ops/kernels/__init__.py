"""Python wrappers of the CUDA kernels in ``csrc/``, each with its plain
PyTorch version and a launch counter (``<wrapper>.launches``)."""

from .conv_bn import conv_bn_stats, conv_bn_stats_plain
from .nms import nms_keep, nms_keep_plain

__all__ = ["conv_bn_stats", "conv_bn_stats_plain", "nms_keep",
           "nms_keep_plain"]
