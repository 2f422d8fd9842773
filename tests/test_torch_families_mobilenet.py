"""The port's YOLOv2 with MobileNetV2 and YOLOv3 with a backbone factory (a
ResNet-50 v1 built by a callable; 64^2)
against the JAX package's, in f32 on the CPU: the networks (leaves, the
tree's convs, eval heads), one training step (loss, running statistics,
every gradient) and the serving program, held by the checks of
``tests/helpers_families.py`` and their bounds."""

import pytest
import torch

from tests import helpers_families as fam
from tests.helpers_torch import release_memory_after_module  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["v2_mobilenet", "v3_callable"])
def family(request):
    yield fam.built(request.param)
    fam.built.cache_clear()


def test_leaves_and_structure_match_jax(family):
    fam.check_leaves_and_structure(family)


def test_eval_heads_match_jax(family):
    fam.check_eval_heads(family)


def test_train_step_matches_jax(family):
    fam.check_train_step(family)


def test_serving_kept_rows_match_jax(family):
    fam.check_serving_kept_rows(family)
