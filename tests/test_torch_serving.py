"""The port's YOLOv4 serving slice against the JAX package's, end to end.

Full YOLOv4 (it has no width knob) at 96x96, batch 2, 3 classes, in
f32 on the CPU. The weights are one JAX ``init`` (``PRNGKey(0)``),
bridged to the port. The v4 init's RandomNormal(0, 0.02) with
init-time BN statistics shrinks activations to ~1e-13 at the heads, so
the BN running statistics are first set to the batch statistics of each
conv's output on the test batch (one forward of the port, layer by
layer, as a trained network's BN would hold them); that tree then goes
to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from tf2_yolo_tpu.export import make_serving_fn as jax_make_serving_fn
from tf2_yolo_tpu.models import YoloV4 as JaxYoloV4
from tf2_yolo_tpu_torch.bridge import from_flax, to_flax
from tf2_yolo_tpu_torch.export import make_serving_fn
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.layers import Conv, ConvBN

torch.set_num_threads(1)

CLASSES = 3
ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)
# The middle of the widest gap (1.77e-3) between the joint confidences
# of the 2 x 1701 lattice points that leaves 20..100 valid boxes per
# image (34 and 25). No joint confidence lies within THRESHOLD_GAP of it
# and the port's differ from JAX's by less (measured 5.2e-4), both
# asserted below, so both sides decide the same valid set.
THRESHOLD = 0.35669
THRESHOLD_GAP = 8e-4


def _calibrate_bn(model, x):
    """Set every BN's mean/var to its conv output's batch statistics."""
    def hook(bn, out):
        y = out[0].float()
        bn.mean.copy_(y.mean(dim=(0, 1, 2)))
        bn.var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.conv.register_forward_hook(
        lambda conv, inputs, out, bn=m.bn: hook(bn, out))
        for m in model.modules() if isinstance(m, ConvBN) and m.bn is not None]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()


def _is_head_conv(mdl, _method):
    return (isinstance(mdl, jnn.Conv) and mdl.name == "conv"
            and mdl.path[0].startswith("head"))


@pytest.fixture(scope="module")
def slice_pair():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 96, 96, 3).astype(np.float32)
    jmodel = JaxYoloV4(anchors=ANCHORS, class_num=CLASSES)
    init = jax.tree_util.tree_map(
        np.asarray,
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
    model = YoloV4(ANCHORS, CLASSES).eval()
    model.load_state_dict(from_flax(init), strict=True)
    _calibrate_bn(model, torch.from_numpy(x))
    variables = to_flax(model.state_dict())

    outs, inter = jmodel.apply(variables, jnp.asarray(x), train=False,
                               capture_intermediates=_is_head_conv)
    jax_logits = [np.asarray(inter["intermediates"][f"head{i}"]["conv"]
                             ["__call__"][0]) for i in (1, 2, 3)]

    logits = {}
    handles = [getattr(model, f"head{i}").conv.register_forward_hook(
        lambda m, inp, out, i=i: logits.__setitem__(i, out[0].numpy()))
        for i in (1, 2, 3)]
    with torch.no_grad():
        port_outs = [o.numpy() for o in model(torch.from_numpy(x))]
    for h in handles:
        h.remove()
    return dict(x=x, init=init, model=model, jmodel=jmodel,
                variables=variables,
                jax_outs=[np.asarray(o) for o in outs],
                jax_logits=jax_logits, port_outs=port_outs,
                port_logits=[logits[i] for i in (1, 2, 3)])


def test_network_structure(slice_pair):
    model = slice_pair["model"]
    convbn = [m for m in model.modules() if isinstance(m, ConvBN)]
    assert len(convbn) == 107
    assert sum(m.act == "mish" for m in convbn) == 72
    assert sum(m.act == "leaky" for m in convbn) == 35
    assert sum(m.conv.stride == 2 for m in convbn) == 7
    assert sum(isinstance(m, Conv) for m in model.modules()) == 110


def test_bridge_round_trip(slice_pair):
    init = {k: slice_pair["init"][k] for k in ("params", "batch_stats")}
    back = to_flax(from_flax(init))
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(init), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_head_logits_match_jax(slice_pair):
    # The raw 1x1 head convs before exp/sigmoid, so that a neck error
    # cannot hide in their amplification. The 107-layer random network
    # amplifies f32 rounding about 1e4-fold: the port against itself with
    # 1 vs 8 CPU threads (another conv summation order) differs by 7.6e-4
    # at the head outputs. Measured port-vs-JAX max |diff| 4.8e-3 on
    # logits up to 1.57; bound 4x that.
    for i, (got, want) in enumerate(zip(slice_pair["port_logits"],
                                        slice_pair["jax_logits"])):
        size = 96 // (32 >> i)
        assert got.shape == want.shape == (2, size, size, 24)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2,
                                   err_msg=f"head{i + 1} logits")


def test_head_outputs_match_jax(slice_pair):
    # coarse -> fine; same noise floor as the logits, compressed by the
    # sigmoids: measured max |diff| 1.25e-3 on outputs up to 1.29; bound
    # 4x that
    for i, (got, want) in enumerate(zip(slice_pair["port_outs"],
                                        slice_pair["jax_outs"])):
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3,
                                   err_msg=f"head{i + 1}")


def _kept(rows, keep):
    kept = np.asarray(rows)[np.asarray(keep)]
    return kept[np.lexsort(kept.T[::-1])]


def _joint(outs):
    return np.concatenate([
        (o.reshape(2, -1, 5 + CLASSES)[..., 4:5]
         * o.reshape(2, -1, 5 + CLASSES)[..., 5:]).reshape(2, -1)
        for o in outs], axis=1)


def test_serving_kept_rows_match_jax(slice_pair):
    joint = _joint(slice_pair["jax_outs"])
    assert np.abs(joint - THRESHOLD).min() > THRESHOLD_GAP
    assert np.abs(_joint(slice_pair["port_outs"]) - joint).max() \
        < THRESHOLD_GAP

    x = slice_pair["x"]
    jrows, jkeep = jax_make_serving_fn(
        slice_pair["jmodel"], slice_pair["variables"], CLASSES, 4,
        threshold=THRESHOLD)(jnp.asarray(x))
    rows, keep = make_serving_fn(slice_pair["model"], CLASSES, 4,
                                 threshold=THRESHOLD)(torch.from_numpy(x))
    assert rows.shape == (2, 128, 7) and keep.shape == (2, 128)
    assert keep.dtype == torch.bool
    want = _kept(jrows, jkeep)
    got = _kept(rows.numpy(), keep.numpy())
    n_valid = int((joint >= THRESHOLD).sum())
    assert 0 < len(want) < n_valid
    assert got.shape == want.shape
    # the kept boxes' fields carry the head-output difference (bound
    # above); class ids are exact
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
