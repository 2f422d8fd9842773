from .backbones import Classifier
from .classifiers import csp_darknet53, darknet, darknet19, darknet53
from .detectors import YoloV1, YoloV2, YoloV3, YoloV4
from .layers import use_plain_route
from .mobilenet import MobileNetV2
from .resnet import ResNet

__all__ = ["YoloV1", "YoloV2", "YoloV3", "YoloV4", "ResNet", "MobileNetV2",
           "Classifier", "darknet", "darknet19", "darknet53",
           "csp_darknet53", "use_plain_route"]
