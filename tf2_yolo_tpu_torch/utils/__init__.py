"""Host-side utilities: decode/NMS parity paths and kmeans."""

from .kmeans import euclidean_dist, iou, iou_dist, kmeans, kmeans_torch
from .tools import (array_to_json, array_to_xml, cal_iou, decode,
                    down2xlabel, get_class_weight, nms, read_img, soft_nms,
                    vis_img)

__all__ = [
    "read_img", "down2xlabel", "decode", "nms", "soft_nms", "cal_iou",
    "get_class_weight", "vis_img", "array_to_json", "array_to_xml",
    "kmeans", "kmeans_torch", "iou", "iou_dist", "euclidean_dist",
]
