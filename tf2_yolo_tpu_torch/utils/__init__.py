"""Host-side utilities: decode/NMS parity paths, kmeans, measurement."""

from .kmeans import euclidean_dist, iou, iou_dist, kmeans, kmeans_torch
from .measurement import PR_func, PRfunc, create_score_mat
from .tools import (array_to_json, array_to_xml, cal_iou, decode,
                    down2xlabel, get_class_weight, nms, read_img, soft_nms,
                    vis_img)

__all__ = [
    "read_img", "down2xlabel", "decode", "nms", "soft_nms", "cal_iou",
    "get_class_weight", "vis_img", "array_to_json", "array_to_xml",
    "kmeans", "kmeans_torch", "iou", "iou_dist", "euclidean_dist",
    "create_score_mat", "PRfunc", "PR_func",
]
