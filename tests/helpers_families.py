"""The YOLOv1.5, v2, v3 and v4 networks of the port against the JAX
package's, shared by ``tests/test_torch_families.py`` (v3, full and
tiny), ``tests/test_torch_families_v12.py`` (v1, v2 darknet and UNet)
and ``tests/test_torch_families_backbones*.py`` (the ResNet, MobileNetV2
and factory backbones): the networks, their test batches, and one check
per property.

Ten networks at small size, batch 2, 3 classes: YOLOv4 (CSPDarknet-53)
at 64^2, YOLOv1 at 128^2, YOLOv2
with DarkNet-19 and with the UNet at 64^2, YOLOv3 with Darknet-53 and
tiny at 96^2; YOLOv4 with ResNet-50 at 128^2, YOLOv3 with ResNet-50 v2
and with a backbone factory (a ResNet-50), YOLOv2 with MobileNetV2, at
64^2; in f32 on the CPU. The weights are one jitted JAX ``init``
(``PRNGKey(0)``), bridged to the port. HE_NORMAL kernels with BN at its
init statistics let the activations grow layer by layer, so each BN's
running statistics are first set to the batch statistics of what it
normalises on the test batch (one port forward, as a trained network's
BN holds them, ``tests/test_torch_serving.py``'s recipe); that tree goes
to both sides.

Bounds: whole networks at 4 times the port's own floor (its outputs on
the test batch moved by one f32 ulp); whole-model gradients by the probe
rule of ``tests/test_torch_train.py`` (the same step on x + 1e-6 beside
it); kept serving rows at the head outputs' bound.
"""


import functools
import re

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu import models as jmodels
from tf2_yolo_tpu.models import resnet as jresnet
from tf2_yolo_tpu.export import make_serving_fn as jax_make_serving_fn
from tests.helpers_torch import flat, numpy_tree, rel_l2
from tf2_yolo_tpu.ops import losses as jlosses
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.export import make_serving_fn
from tf2_yolo_tpu_torch.models import ResNet, YoloV1, YoloV2, YoloV3, YoloV4
from tf2_yolo_tpu_torch.models.layers import (BNState, Conv, ConvActBN,
                                              ConvBN)
from tf2_yolo_tpu_torch.ops import losses

CLASSES = 3
EPS_PROBE = 1e-6
# an activation input nearer its kink than this may fall on either side
# of it in the two packages (their forwards differ by f32 rounding,
# grown through the network: head outputs 1e-5 to 1e-4 relative)
NEAR_KINK = 1e-4
KINK_BOUND = 0.05
ANCHORS9 = np.stack([np.linspace(0.05, 0.75, 9),
                     np.linspace(0.07, 0.65, 9)], axis=1).tolist()
ANCHORS6 = ANCHORS9[3:]
ANCHORS5 = ANCHORS9[4:]
FAMILY_ANCHORS = {"v1": None, "v2_darknet": ANCHORS5, "v2_unet": ANCHORS5,
                  "v3_full": ANCHORS9, "v3_tiny": ANCHORS6,
                  "v4_resnet50": ANCHORS9, "v3_resnet50v2": ANCHORS9,
                  "v3_callable": ANCHORS9, "v2_mobilenet": ANCHORS5}
# ResNet-50 v1 or v2: the stem, 16 blocks of 3 convs, 4 projections
RESNET50_CONVS = 1 + 16 * 3 + 4
# MobileNetV2's dense convs: the stem, 16 expansions, 17 projections and
# the head (its 17 depthwise convs are not Conv modules)
MOBILENET_CONVS = 1 + 16 + 17 + 1

# name: (version, size, JAX module, port module, the convs of the tree:
# ConvBN + ConvActBN + head convs)
FAMILIES = {
    "v4": (4, 64, lambda: jmodels.YoloV4(anchors=ANCHORS9,
                                         class_num=CLASSES),
           lambda: YoloV4(ANCHORS9, CLASSES, device="cpu"), 107 + 3),
    "v1": (1, 128, lambda: jmodels.YoloV1(bbox_num=2, class_num=CLASSES),
           lambda: YoloV1(2, CLASSES, device="cpu"), 23 + 1),
    "v2_darknet": (2, 64, lambda: jmodels.YoloV2(
        anchors=ANCHORS5, class_num=CLASSES, backbone="darknet"),
        lambda: YoloV2(ANCHORS5, CLASSES, "darknet", device="cpu"),
        22 + 1),
    "v2_unet": (2, 64, lambda: jmodels.YoloV2(
        anchors=ANCHORS5, class_num=CLASSES, backbone="unet"),
        lambda: YoloV2(ANCHORS5, CLASSES, "unet", device="cpu"), 16 + 1),
    "v3_full": (3, 96, lambda: jmodels.YoloV3(
        anchors=ANCHORS9, class_num=CLASSES),
        lambda: YoloV3(ANCHORS9, CLASSES, device="cpu"), 72 + 3),
    "v3_tiny": (3, 96, lambda: jmodels.YoloV3(
        anchors=ANCHORS6, class_num=CLASSES, backbone="tiny_darknet"),
        lambda: YoloV3(ANCHORS6, CLASSES, "tiny_darknet", device="cpu"),
        11 + 2),
    # the v4 neck's 35 ConvBNs, the v3 FPN's 20
    "v4_resnet50": (4, 128, lambda: jmodels.YoloV4(
        anchors=ANCHORS9, class_num=CLASSES, backbone="resnet50"),
        lambda: YoloV4(ANCHORS9, CLASSES, device="cpu",
                       backbone="resnet50"), RESNET50_CONVS + 35 + 3),
    "v3_resnet50v2": (3, 64, lambda: jmodels.YoloV3(
        anchors=ANCHORS9, class_num=CLASSES, backbone="resnet50v2"),
        lambda: YoloV3(ANCHORS9, CLASSES, "resnet50v2", device="cpu"),
        RESNET50_CONVS + 20 + 3),
    "v3_callable": (3, 64, lambda: jmodels.YoloV3(
        anchors=ANCHORS9, class_num=CLASSES,
        backbone=lambda **kw: jresnet.ResNet(depth=50, **kw)),
        lambda: YoloV3(ANCHORS9, CLASSES,
                       lambda **kw: ResNet(depth=50, **kw), device="cpu"),
        RESNET50_CONVS + 20 + 3),
    "v2_mobilenet": (2, 64, lambda: jmodels.YoloV2(
        anchors=ANCHORS5, class_num=CLASSES, backbone="mobilenet"),
        lambda: YoloV2(ANCHORS5, CLASSES, "mobilenet", device="cpu"),
        MOBILENET_CONVS + 1),
}

# eval heads: the largest difference relative to the largest output. The
# YOLOv4 neck and the ResNet-50 v1 body amplify rounding more than the
# others (keras BN eps 1.001e-5 lets a channel of small variance gain up
# to 316x; the v4 neck ~1e4-fold as tests/test_torch_serving.py found):
# measured against JAX / the port's own floor, v4 ResNet-50 at 128^2
# 3.7e-3 / 5.5e-3, 6.0e-3 / 4.2e-3, 2.0e-3 / 2.3e-3 with outputs up to
# 0.77-1.37 (4.9e-3 relative at most), v3 with the ResNet-50 factory at
# 64^2 3.4e-3 / 7.2e-3 of 0.93 (3.7e-3 relative), 2.1e-2 / 2.1e-2 of
# 4.2, 2.7e-2 / 3.1e-2 of 17.1: bound 2e-2, 4x the largest; YOLOv4
# (CSPDarknet-53) at 64^2 1.2e-2 / 1.4e-2 of 0.82, 4.5e-3 / 6.0e-3 of
# 0.90, 2.0e-3 / 2.4e-3 of 1.18 (1.5e-2 relative at most): bound 6e-2
EVAL_REL = {"v4_resnet50": 2e-2, "v3_callable": 2e-2, "v4": 6e-2}


def as_list(outs):
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def _calibrate_bn(model, x):
    """Set each BN's running mean/var to the batch statistics of what it
    normalises (its input: a ConvBN's conv output, a ConvActBN's
    activated conv output, a keras backbone BN's input)."""
    def hook(bn, args):
        y = args[0].float()
        bn.mean.copy_(y.mean(dim=(0, 1, 2)))
        bn.var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BNState)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in handles:
            h.remove()


def labels_for(rng, version, grids, batch=2):
    """One label tensor per level (coarse first): 3 boxes an image and
    level, in cells of the JAX facade's grid layout (5 + C channels)."""
    ys = []
    for g in grids:
        y = np.zeros((batch, g, g, 5 + CLASSES), np.float32)
        for b in range(batch):
            for _ in range(3):
                gy, gx = rng.randint(0, g, 2)
                y[b, gy, gx, :5] = [*rng.rand(2), *(0.1 + 0.4 * rng.rand(2)),
                                    1.0]
                y[b, gy, gx, 5 + rng.randint(CLASSES)] = 1.0
        ys.append(y)
    return ys


def loss_pair(version, grids, anchors, **kw):
    """The JAX and the port's loss of each level, coarse first."""
    fns = []
    for pkg in (jlosses, losses):
        if version == 1:
            fns.append([pkg.wrap_yolo_loss_v1((grids[0],) * 2, 2, CLASSES,
                                              **kw)])
        elif version == 2:
            fns.append([pkg.wrap_yolo_loss_v2((grids[0],) * 2, 5, CLASSES,
                                              anchors, **kw)])
        else:
            per = len(anchors) // len(grids)
            wrap = pkg.wrap_yolo_loss_v4 if version == 4 \
                else pkg.wrap_yolo_loss_v3
            fns.append([wrap(
                (g,) * 2, per, CLASSES, anchors[i * per:(i + 1) * per],
                **kw) for i, g in enumerate(grids)])
    return fns


def _threshold(joint, lo=6, hi=40):
    """The middle of the widest gap between sorted joint confidences
    that leaves lo..hi valid lattice points in the batch, and the gap's
    half width."""
    vals = np.sort(joint.ravel())[::-1]
    best = max(range(lo, hi), key=lambda i: vals[i - 1] - vals[i])
    return float((vals[best - 1] + vals[best]) / 2), \
        float((vals[best - 1] - vals[best]) / 2)


@functools.lru_cache(maxsize=None)
def built(name):
    version, size, jfactory, tfactory, convs = FAMILIES[name]
    rng = np.random.RandomState(sum(map(ord, name)))   # the test batch
    x = rng.rand(2, size, size, 3).astype(np.float32)
    jm = jfactory()
    init = numpy_tree(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    model = tfactory()
    model.load_state_dict(bridge.from_flax(init), strict=True)
    _calibrate_bn(model, torch.from_numpy(x))
    variables = bridge.to_flax(model.state_dict())
    jouts = as_list(jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        outs = [o.numpy() for o in as_list(model.eval()(
            torch.from_numpy(x)))]
        # the port's floor: its outputs on the test batch moved up by one
        # f32 ulp, a rounding-sized change grown as the network grows its
        # rounding (1 vs 8 CPU threads does not change the UNet's
        # summation). Measured, port against JAX / this floor: v1
        # 6.0e-5 / 5.8e-5, v2 darknet 7.8e-4 / 8.0e-4, UNet 1.1e-2 /
        # 1.2e-2 (outputs up to 115: exp of the raw wh), v3 levels 7.4e-5
        # / 9.4e-5, 4.1e-4 / 5.0e-4, 1.1e-3 / 6.2e-4, tiny 2.7e-5 /
        # 9.8e-5, 2.7e-4 / 2.8e-4
        probe = as_list(model(torch.from_numpy(
            np.nextafter(x, np.float32(2)))))
    floors = [float(np.abs(p.numpy() - o).max())
              for p, o in zip(probe, outs)]
    return dict(name=name, version=version, size=size, x=x, jm=jm,
                init=init, model=model, variables=variables, convs=convs,
                jouts=[np.asarray(o) for o in jouts], outs=outs,
                floors=floors)


def _train_grads(f, x, ys, tfns):
    """The port's train-mode loss, parameter gradients and updated
    running statistics on a fresh model of the calibrated weights, and
    for each ConvBN / ConvActBN (by qualified name, in the order they
    ran) the least distance of its activation's input from the kink at
    0 (leaky, relu); for a keras backbone's block (the module holding
    BNs called on their own) the least distance of its BN outputs from
    relu's and relu6's kinks at 0 and 6."""
    model = FAMILIES[f["name"]][3]()
    model.load_state_dict(bridge.from_flax(f["variables"]), strict=True)
    kinks = {}

    def leaky_in(name, module, out):
        # leaky(z) = z for z >= 0, 0.1 z below: |z| from the output
        o = out.detach()
        kinks[name] = float(torch.where(o >= 0, o, -10 * o).min())

    def relu_in(name, out):
        kinks[name] = float(out[0].detach().abs().min())

    def bn_out(name, out):
        o = out.detach()
        near = float(torch.minimum(o.abs(), (o - 6).abs()).min())
        kinks[name] = min(kinks.get(name, near), near)

    handles = []
    paired = {n for n, m in model.named_modules()
              if isinstance(m, (ConvBN, ConvActBN))}
    for name, m in model.named_modules():
        if isinstance(m, ConvBN) and m.act == "leaky":
            handles.append(m.register_forward_hook(
                lambda mod, i, out, name=name: leaky_in(name, mod, out)))
        elif isinstance(m, ConvActBN):
            handles.append(m.conv.register_forward_hook(
                lambda mod, i, out, name=name: relu_in(name, out)))
        elif isinstance(m, BNState) and \
                name.rpartition(".")[0] not in paired:
            handles.append(m.register_forward_hook(
                lambda mod, i, out, name=name.rpartition(".")[0]:
                bn_out(name, out)))
    outs = as_list(model.train()(torch.from_numpy(x)))
    for h in handles:
        h.remove()
    loss = sum(fn(torch.from_numpy(y), o) for fn, y, o in
               zip(tfns, ys, outs))
    loss.backward()
    return loss.item(), bridge.flax_leaves(model, grad=True), \
        {k: v.numpy() for k, v in bridge.flax_leaves(model).items()
         if k.startswith("batch_stats/")}, kinks, \
        [o.detach().numpy() for o in outs]



def _joint(out, version):
    n = out.shape[0]
    if version == 1:
        conf = out[..., :10].reshape(*out.shape[:3], 2, 5)[..., 4:5]
        return (conf * out[..., None, 10:]).reshape(n, -1)
    o = out.reshape(n, -1, 5 + CLASSES)
    return (o[..., 4:5] * o[..., 5:]).reshape(n, -1)


def _kept(rows, keep):
    kept = np.asarray(rows)[np.asarray(keep)]
    return kept[np.lexsort(kept.T[::-1])]



def _bias_before_bn(path, leaves):
    """Whether ``path`` is the bias of a conv that a BN follows: a ConvBN
    with BN (in a ConvActBN the activation sits between them), or a
    keras block's ``convN`` / ``X_conv`` beside its ``bnN`` / ``X_bn``."""
    m = re.fullmatch(r"(.*)/(conv|conv\d+|\w+_conv)/bias", path)
    if m is None or "ConvActBN" in path:
        return False
    bn = re.sub(r"conv(\d*)$", r"bn\1", m.group(2))
    return f"{m.group(1)}/{bn}/scale" in leaves




# ---- checks
def check_leaves_and_structure(f):
    """Names and shapes of every leaf equal to the JAX init's, the
    bridge round trip, and the convs of the tree."""
    want = {**flat(f["init"]["params"], "params/"),
            **flat(f["init"].get("batch_stats", {}), "batch_stats/")}
    got = bridge.flax_leaves(f["model"])
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
    # the bridge round trip
    back = bridge.from_flax(bridge.to_flax(f["model"].state_dict()))
    for k, v in f["model"].state_dict().items():
        assert torch.equal(back[k], v), k
    # every conv of the tree, counted from the tree (chip_smoke.py holds
    # the kernel launches of a request to this)
    assert sum(isinstance(m, Conv) for m in f["model"].modules()) \
        == f["convs"]


def check_eval_heads(f):
    """Eval head outputs against JAX's, level by level, within 4 times
    the port's own floor (see ``_built``)."""
    assert len(f["outs"]) == len(f["jouts"]) == len(f["floors"])
    for i, (got, want, floor) in enumerate(zip(f["outs"], f["jouts"],
                                               f["floors"])):
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err <= 4 * floor + 1e-6, (f["name"], i, err, floor)
        assert err <= EVAL_REL.get(f["name"], 1e-3) * np.abs(want).max(), \
            (f["name"], i, err)


# The keras-backbone families: their train-mode forward is chaotic (BN
# eps 1.001e-5 in the ResNets; batch statistics of 8 values a channel at
# 2^2 in the last stages at 64^2), so the loss is held through the head
# outputs, which move with the input continuously, where a rounding-sized
# change may move a box across the ignore threshold and the loss by a
# step (measured, v2 MobileNetV2: outputs 3.8e-4 from JAX's, 2.6e-4 on
# the JAX probe, and the loss 8.6e-5 relative from JAX's, 3.9e-6 on the
# probe).
TRAIN_PROBED = {"v4_resnet50", "v3_resnet50v2", "v3_callable",
                "v2_mobilenet"}


def _check_train_forward_probed(f, outs, jouts, pouts, loss, jfns, ys,
                                stats, want_stats, probe_stats):
    """The train-mode forward of a TRAIN_PROBED family: each level's head
    outputs and each updated running statistic within 8 times the JAX
    probe's distance (the same step on x + 1e-6) from JAX's, or within
    1e-5 of the scale; the port's loss equal to the JAX loss of the
    port's own outputs (1e-6 relative)."""
    for i, (o, j, p) in enumerate(zip(outs, jouts, pouts)):
        j, p = np.asarray(j), np.asarray(p)
        err, noise = np.abs(o - j).max(), np.abs(p - j).max()
        assert err <= max(8 * noise, 1e-5 * np.abs(j).max()), \
            (f["name"], i, err, noise)
    jl = sum(float(fn(jnp.asarray(y), jnp.asarray(o)))
             for fn, y, o in zip(jfns, ys, outs))
    np.testing.assert_allclose(loss, jl, rtol=1e-6)
    for k, v in want_stats.items():
        v = np.asarray(v)
        err = np.abs(stats[k] - v).max()
        noise = np.abs(np.asarray(probe_stats[k]) - v).max()
        assert err <= max(8 * noise, 1e-5 * np.abs(v).max()), \
            (f["name"], k, err, noise)


def check_train_step(f):
    """One train-mode forward, the loss list and the backward: the loss
    and the updated running statistics against JAX's, and every
    parameter gradient within a multiple of the probe's distance."""
    name = f["name"]
    x, variables, jm = f["x"], f["variables"], f["jm"]
    grids = [o.shape[1] for o in f["jouts"]]
    ys = labels_for(np.random.RandomState(5), f["version"], grids)
    jfns, tfns = loss_pair(f["version"], grids, FAMILY_ANCHORS[name])

    def jloss(params, xx):
        outs, new = jm.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             xx, train=True, mutable=["batch_stats"])
        return sum(fn(jnp.asarray(y), o) for fn, y, o in
                   zip(jfns, ys, as_list(outs))), (new, as_list(outs))

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (want_loss, (new, jouts)), want = jgrad(variables["params"],
                                            jnp.asarray(x))
    (_, (new_p, pouts)), probe = jgrad(variables["params"],
                                       jnp.asarray(x + EPS_PROBE))
    want, probe = flat(want, "params/"), flat(probe, "params/")
    want_stats = flat(new["batch_stats"], "batch_stats/")
    probe_stats = flat(new_p["batch_stats"], "batch_stats/")

    loss, got, stats, kinks, outs = _train_grads(f, x, ys, tfns)
    # The modules that ran up to the last one whose activation input lies
    # within rounding (NEAR_KINK) of its kink. There the two sides' f32
    # forwards, which differ by rounding, may put that input on either
    # side, and leaky's slope is 1 or 0.1 (relu's 1 or 0): the gradient
    # of that channel, and of every layer before it, takes the other
    # one-sided derivative, which no probe of the input reproduces
    # (measured: YOLOv3 tiny's ConvBN_6, |z| = 3.2e-6 in channel 932: the
    # channel's BN-bias gradient 0.0150 against 0.1168, its leaf 1.3e-2
    # relative, the layers before it 5e-3 to 1.2e-2, every other leaf
    # within its probe). Those leaves are held to KINK_BOUND, which a
    # wrong backward (0.5 or more, as tests/test_torch_train.py measured)
    # exceeds; the rest to the probe rule.
    order = list(kinks)
    near = [i for i, n in enumerate(order) if kinks[n] < NEAR_KINK]
    upstream = set(order[:near[-1] + 1]) if near else set()
    assert stats.keys() == want_stats.keys()
    if name in TRAIN_PROBED:
        _check_train_forward_probed(f, outs, jouts, pouts, loss, jfns, ys,
                                    stats, want_stats, probe_stats)
    else:
        # a loss of a few hundred terms over a net of 13 to 75 convs:
        # measured 1.1e-7 .. 2.2e-6 relative
        np.testing.assert_allclose(loss, float(want_loss), rtol=2e-5)
        for k, v in want_stats.items():
            # 0.99 running + 0.01 batch: the batch statistics' rounding
            np.testing.assert_allclose(stats[k], v, rtol=1e-5,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        g = got[path].numpy()
        if _bias_before_bn(path, want):
            # a conv bias that a train-mode BN follows: its exact gradient
            # is 0 (the batch mean takes it out) and both sides hold
            # rounding noise, small beside the conv kernel's gradient
            scale = np.linalg.norm(want[path[:-len("bias")] + "kernel"])
            assert max(np.linalg.norm(g), np.linalg.norm(leaf)) \
                <= 1e-5 * scale, (name, path)
            continue
        err = rel_l2(g, leaf)
        noise = rel_l2(probe[path], leaf)
        if ".".join(path.split("/")[1:-2]) in upstream or (
                name in TRAIN_PROBED and path.endswith("/anchors")):
            # the v4 anchors' six numbers take their gradient from the
            # loss alone, in which a box that crosses the ignore threshold
            # moves them by a step (measured, v4 ResNet-50: head3 3.1e-3
            # from JAX's, 2.1e-4 on the probe)
            assert err <= max(8 * noise, KINK_BOUND), (name, path, err)
            continue
        # as tests/test_torch_train.py: a wrong term or a missing factor
        # in a backward moves every leaf upstream of it by 0.5 or more
        assert err <= max(8 * noise, 1e-4), (name, path, err, noise)
        assert err <= 0.2, (name, path, err)


def check_serving_kept_rows(f):
    """``make_serving_fn(version)``: decode (the v1 layout for v1) and
    greedy NMS, the kept rows against the JAX serving function's: the
    same boxes and classes, the fields within the head outputs' bound."""
    version, x = f["version"], f["x"]
    joint = np.concatenate(
        [_joint(o, version) for o in f["jouts"]], axis=1)
    port_joint = np.concatenate(
        [_joint(o, version) for o in f["outs"]], axis=1)
    threshold, gap = _threshold(joint)
    # both sides decide the same valid set
    assert np.abs(port_joint - joint).max() < gap
    serve = jax.jit(jax_make_serving_fn(f["jm"], f["variables"], CLASSES,
                                        version, threshold=threshold,
                                        max_boxes=64))
    jrows, jkeep = (np.asarray(a) for a in serve(jnp.asarray(x)))
    rows, keep = make_serving_fn(f["model"], CLASSES, version,
                                 threshold=threshold, max_boxes=64)(
        torch.from_numpy(x))
    want, got = _kept(jrows, jkeep), _kept(rows.numpy(), keep.numpy())
    assert 0 < len(want) and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * max(f["floors"]) + 1e-6)
