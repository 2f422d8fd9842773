"""Compute ops of the port: geometry, losses, metrics, decode, NMS and the
evaluation matching; the CUDA kernels' wrappers are in ``ops.kernels``."""

from .evalmatch import match_counts, match_pred_arrays

__all__ = ["match_counts", "match_pred_arrays"]
