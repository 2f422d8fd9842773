from .detectors import YoloV1, YoloV2, YoloV3, YoloV4
from .layers import use_plain_route

__all__ = ["YoloV1", "YoloV2", "YoloV3", "YoloV4", "use_plain_route"]
