from .detectors import YoloV4
from .layers import use_plain_route

__all__ = ["YoloV4", "use_plain_route"]
