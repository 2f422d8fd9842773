"""The reference-weight converter of the port against the JAX package's
on the keras-applications backbones, on the CPU: YOLOv4 with ResNet-50,
YOLOv3 with a ResNet-50 (through the backbone factory) and YOLOv2 with
MobileNetV2, through ``tests/helpers_convert.py``'s checks.
"""

import pytest
import torch

from tests import helpers_convert as hc
from tests import helpers_families as fam
from tests.helpers_convert import remove_files_after_test  # noqa: F401
from tests.helpers_torch import release_memory_after_module  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["v4_resnet50", "v3_callable",
                                  "v2_mobilenet"])
def test_family_round_trip(name, tmp_path):
    hc.check_family(fam.built(name), tmp_path)
