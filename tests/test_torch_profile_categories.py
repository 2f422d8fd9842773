"""The profile tool's kernel categories (``tools/train_profile.py``) name
every hand-written CUDA kernel of the port: none of the ``__global__``
functions in ``tf2_yolo_tpu_torch/csrc/*.cu`` falls into the catch-all
"elementwise", and each lands where its source file says."""

import glob
import os
import re

import pytest

from tf2_yolo_tpu_torch.tools.train_profile import CATEGORIES, category

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tf2_yolo_tpu_torch", "csrc")
# __global__ void [__launch_bounds__(... (nested) ...)] name(
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)"
    r"\s*)?(\w+)\s*\(")


def _kernels():
    out = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            for name in _GLOBAL.findall(f.read()):
                out[name] = os.path.basename(path)
    return out


# the category each source's kernels belong to (conv_bn.cu: the forward)
_BY_SOURCE = {"conv_bn.cu": {"conv forward"},
              "conv_int8.cu": {"int8 conv"},
              "nms.cu": {"nms"},
              "fused_gemm.cu": {"fused gemm forward", "fused gemm backward"},
              "fused_conv3x3.cu": {"fused conv3x3 forward",
                                   "fused conv3x3 backward"}}


def test_every_source_has_kernels():
    found = set(_kernels().values())
    assert found == set(_BY_SOURCE), found
    # the kernels the profile once missed
    assert {"soft_walk_kernel", "quantize_int8_kernel",
            "quantize_im2col_kernel", "conv_int8_wgmma_kernel",
            "conv_int8_kernel"} <= set(_kernels())


@pytest.mark.parametrize("name,source", sorted(_kernels().items()))
def test_kernel_has_its_category(name, source):
    # profiler names carry the signature and, for templates, the
    # arguments: "void conv_int8_wgmma_kernel<128, 4>(Params)"
    for shown in (name, f"void {name}<128, 4>(Params const*)"):
        assert category(shown) in _BY_SOURCE[source], (name, category(shown))
        assert category(shown) != "elementwise"


def test_no_stale_names():
    """Every name a category lists is a kernel in the sources, a library
    kernel's fragment, or the optimizer's."""
    kernels = set(_kernels())
    ours = [k for _, keys in CATEGORIES for k in keys if k.endswith("_kernel")]
    assert set(ours) <= kernels, set(ours) - kernels
