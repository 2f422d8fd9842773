"""Host data pipeline: parsers, dataset sequence, augmentation, feed."""

from . import augment
from .dataset import YoloDataSequence, encode_to_grid
from .parsers import parse_labelimg, parse_labelme
from .pipeline import prefetch_to_device, threaded_prefetch

__all__ = ["parse_labelimg", "parse_labelme", "YoloDataSequence",
           "encode_to_grid", "augment",
           "prefetch_to_device", "threaded_prefetch"]
