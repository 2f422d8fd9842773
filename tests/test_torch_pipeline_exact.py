"""``split_detector`` of YOLOv1, v2 (DarkNet-19), v3 (Darknet-53) and
YOLOv4 with a ResNet-50 body: in both BatchNorm modes the pipelined eval
forward, the frozen-statistics gradients, the train-mode step and its
running statistics equal the port's single-program model bit for bit on
the CPU. (The JAX package's eval forward of these cuts:
tests/test_torch_pipeline_families.py.)
"""

import pytest

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.test_torch_pipeline_families import (  # noqa: F401
    fast_init, test_split_detector_equals_the_whole_model as _check)


@pytest.mark.parametrize("name", ["v1", "v2", "v3", "v4_resnet50"])
def test_split_detector_equals_the_whole_model(name):
    _check(name)
