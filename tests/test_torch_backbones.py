"""The ResNet-50/101/152 (v1 and v2) and MobileNetV2 backbones of the
port against the JAX package's, in f32 on the CPU, and the BN fold of
their trees.

- ResNet-50 v1 and v2 and MobileNetV2 at 64^2, batch 2, weights from one
  JAX ``init`` through the bridge: eval-mode taps (the ResNets at their
  init BN statistics, 1e-5 of the largest output: measured 7e-7;
  MobileNetV2, whose init statistics drive its output to 1e-11, with
  each BN set to the batch statistics of its input, within 4 times the
  port's own floor, its output moved by one f32 ulp of the input:
  measured 0.77 of it); train-mode taps and the updated running
  statistics within 8 times the JAX probe's distance (the same forward
  on x + 1e-6; measured 1.7, 2.9 and 4.8 of it), or 1e-5 of the scale;
- ResNet-101 and 152, v1 and v2: every leaf's name and shape against
  ``jax.eval_shape`` of the JAX init (nothing compiled);
- the traps: v2's stem output, not activated, pooled with a zero pad
  (the keras pool) and not -inf (the port's SAME ``max_pool``), on an
  input whose stem output is negative everywhere;
- ``fold_batch_norm`` on the ResNet v1, v2 and MobileNetV2 trees (and
  one nesting them), each BN folded with its module's eps, equal leaf
  by leaf to the JAX fold, whose rule gives 1.001e-5 in the ResNet
  scopes and 1e-3 elsewhere (MobileNetV2's ``stem_bn`` too); the folded
  ResNet's eval taps equal to the unfolded ones; Darknet-53, whose body
  has ``stage{i}_block{j}`` children (the JAX rule's ResNet mark) and
  BNs of eps 1e-3, keeps 1e-3.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from tests import helpers_families as fam
from tests.helpers_torch import flat, numpy_tree
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu.export import fold_batch_norm as jax_fold
from tf2_yolo_tpu.models import mobilenet as jmobilenet
from tf2_yolo_tpu.models import resnet as jresnet
from tf2_yolo_tpu_torch import bridge, export
from tf2_yolo_tpu_torch.models import MobileNetV2, ResNet
from tf2_yolo_tpu_torch.models.backbones import Darknet53
from tf2_yolo_tpu_torch.models.layers import max_pool

torch.set_num_threads(1)

SIZE = 64
EPS_PROBE = 1e-6
NETS = {
    "resnet50": (lambda: jresnet.ResNet(50, False),
                 lambda: ResNet(50, False, device="cpu")),
    "resnet50v2": (lambda: jresnet.ResNet(50, True),
                   lambda: ResNet(50, True, device="cpu")),
    "mobilenet": (jmobilenet.MobileNetV2,
                  lambda: MobileNetV2(device="cpu")),
}


def _shapes(tree, prefix):
    """``{prefix + flax path: shape}`` of a ``jax.eval_shape`` tree."""
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _taps(out):
    return [np.asarray(o.detach() if hasattr(o, "detach") else o)
            for o in (out if isinstance(out, tuple) else (out,))]


@functools.lru_cache(maxsize=None)
def _built(name):
    jfactory, tfactory = NETS[name]
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    jm = jfactory()
    init = numpy_tree(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    model = tfactory()
    model.load_state_dict(bridge.from_flax(init), strict=True)
    if name == "mobilenet":
        fam._calibrate_bn(model, torch.from_numpy(x))
    return dict(x=x, jm=jm, model=model,
                variables=bridge.to_flax(model.state_dict()))


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    yield request.param, _built(request.param)
    if request.param == list(NETS)[-1]:
        _built.cache_clear()


def test_leaves_match_jax(net):
    name, b = net
    want = {**flat(b["variables"]["params"], "params/"),
            **flat(b["variables"]["batch_stats"], "batch_stats/")}
    got = bridge.flax_leaves(b["model"])
    jm = NETS[name][0]()
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    shapes = {**_shapes(shapes["params"], "params/"),
              **_shapes(shapes["batch_stats"], "batch_stats/")}
    assert got.keys() == want.keys() == shapes.keys()
    for k, v in shapes.items():
        assert tuple(got[k].shape) == v == want[k].shape, k


def test_eval_taps_match_jax(net):
    name, b = net
    x = b["x"]
    want = _taps(jax.jit(functools.partial(b["jm"].apply, train=False))(
        b["variables"], jnp.asarray(x)))
    model = b["model"].eval()
    with torch.no_grad():
        got = _taps(model(torch.from_numpy(x)))
        probe = _taps(model(torch.from_numpy(np.nextafter(
            x, np.float32(2)))))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w, p in zip(got, want, probe):
        err = np.abs(g - w).max()
        if name == "mobilenet":
            assert err <= 4 * np.abs(p - g).max() + 1e-6, (name, err)
        else:
            assert err <= 1e-5 * np.abs(w).max(), (name, err)


def test_train_taps_and_running_statistics_match_jax(net):
    name, b = net
    x, v = b["x"], b["variables"]
    apply = jax.jit(functools.partial(b["jm"].apply, train=True,
                                      mutable=["batch_stats"]))
    want, new = apply(v, jnp.asarray(x))
    probe, new_p = apply(v, jnp.asarray(x + EPS_PROBE))
    model = NETS[name][1]()
    model.load_state_dict(bridge.from_flax(v), strict=True)
    got = _taps(model.train()(torch.from_numpy(x)))
    for g, w, p in zip(got, _taps(want), _taps(probe)):
        err, noise = np.abs(g - w).max(), np.abs(p - w).max()
        assert err <= max(8 * noise, 1e-5 * np.abs(w).max()), (name, err)
    stats = {k: t.numpy() for k, t in bridge.flax_leaves(model).items()
             if k.startswith("batch_stats/")}
    want_s = flat(new["batch_stats"], "batch_stats/")
    probe_s = flat(new_p["batch_stats"], "batch_stats/")
    assert stats.keys() == want_s.keys()
    for k, w in want_s.items():
        w = np.asarray(w)
        err = np.abs(stats[k] - w).max()
        noise = np.abs(np.asarray(probe_s[k]) - w).max()
        assert err <= max(8 * noise, 1e-5 * np.abs(w).max()), (k, err)


@pytest.mark.parametrize("depth", [101, 152])
@pytest.mark.parametrize("preact", [False, True], ids=["v1", "v2"])
def test_deep_resnet_leaves_match_jax(depth, preact):
    shapes = jax.eval_shape(
        functools.partial(jresnet.ResNet(depth, preact).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    want = {**_shapes(shapes["params"], "params/"),
            **_shapes(shapes["batch_stats"], "batch_stats/")}
    got = bridge.flax_leaves(ResNet(depth, preact, device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v, k


def test_v2_stem_pools_with_zero_pad():
    """The trap of resnet.py:152-153: v2's stem has no BN and no ReLU, so
    with a negative stem kernel on a positive image its output is
    negative everywhere; the keras pool's zero pad then gives 0 on the
    border, a -inf (SAME) pad the negative values. The whole v2 network
    on those weights against JAX."""
    b = _built("resnet50v2")
    v = bridge.to_flax(b["model"].state_dict())
    v["params"]["stem_conv"]["kernel"] = -np.abs(
        v["params"]["stem_conv"]["kernel"])
    model = ResNet(50, True, device="cpu").eval()
    model.load_state_dict(bridge.from_flax(v), strict=True)
    x = torch.from_numpy(b["x"])
    with torch.no_grad():
        stem = model.stem_conv(x)[0]
        pooled = model.stem(x)
    assert (stem < 0).all()
    # the keras pool (zero pad) against the -inf pad of a SAME max pool
    jpool = jnn.max_pool(jnp.pad(jnp.asarray(stem.numpy()),
                                 ((0, 0), (1, 1), (1, 1), (0, 0))),
                         (3, 3), (2, 2), "VALID")
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(jpool))
    assert (pooled[:, 0] == 0).all() and (pooled[:, :, 0] == 0).all()
    assert (max_pool(stem, 3, 2, "SAME")[:, 0] < 0).all()
    want = _taps(jax.jit(functools.partial(b["jm"].apply, train=False))(
        v, jnp.asarray(b["x"])))
    with torch.no_grad():
        got = _taps(model(x))
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def _random_stats(model, seed):
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for k in sd:
        if k.endswith((".mean", ".var", ".scale")) or (
                k.endswith(".bias") and k[:-len("bias")] + "mean" in sd):
            shape = sd[k].shape
            val = {"mean": rng.randn(*shape) * 0.2,
                   "var": 0.5 + rng.rand(*shape),
                   "scale": 0.5 + rng.rand(*shape),
                   "bias": rng.randn(*shape) * 0.1}[k.rsplit(".", 1)[1]]
            sd[k] = torch.from_numpy(val.astype(np.float32))
    model.load_state_dict(sd)
    return model


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("nest", [False, True], ids=["bare", "nested"])
def test_fold_batch_norm_matches_jax(nest):
    models = {n: _random_stats(NETS[n][1](), i)
              for i, n in enumerate(NETS)}
    if nest:
        sd = {f"{n}.{k}": t for n, m in models.items()
              for k, t in m.state_dict().items()}
        eps = {f"{n}.{k}": e for n, m in models.items()
               for k, e in export.bn_eps(m).items()}
    else:
        sd = dict(models["resnet50v2"].state_dict())
        eps = export.bn_eps(models["resnet50v2"])
    want = dict(_leaves(numpy_tree(jax_fold(bridge.to_flax(sd)))))
    got = dict(_leaves(bridge.to_flax(export.fold_batch_norm(sd, eps))))
    assert got.keys() == want.keys()
    # JAX divides by sqrt(var + eps), the port multiplies by rsqrt; at
    # eps 1.001e-5 they differ by an ulp, and bias - mean * s by up to 2
    # ulps of the leaf's largest value (measured): bound 4 ulps of it
    ulp = np.finfo(np.float32).eps
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2 * ulp,
                                   atol=4 * ulp * np.abs(want[k]).max(),
                                   err_msg=k)
    eps = {k: np.float32(1) - got[k] for k in got if k.endswith("/var")}
    resnet = [k for k in eps if "resnet" in k or not nest]
    assert resnet and all(np.allclose(eps[k], 1.001e-5, rtol=1e-2)
                          for k in resnet)
    if nest:
        mobile = [k for k in eps if k.startswith("batch_stats/mobilenet")]
        assert "batch_stats/mobilenet/stem_bn/var" in mobile
        assert all(np.allclose(eps[k], 1e-3, rtol=1e-3) for k in mobile)


def test_folded_resnet_matches_unfolded():
    model = _random_stats(ResNet(50, False, device="cpu"), 7).eval()
    folded = export.folded_copy(model)
    x = torch.from_numpy(_built("resnet50")["x"])
    with torch.no_grad():
        for a, b in zip(model(x), folded(x)):
            assert (a - b).abs().max() <= 1e-5 * a.abs().max()
    # ResNet v2's pre_bn and post_bn have no conv: affine only
    v2 = _random_stats(ResNet(50, True, device="cpu"), 8)
    sd = export.fold_batch_norm(v2.state_dict(), export.bn_eps(v2))
    assert not torch.all(sd["post_bn.scale"] == 1)
    assert torch.all(sd["stage1_block1.bn1.scale"] == 1)


def test_darknet53_keeps_its_eps():
    # the JAX rule would fold these with the ResNet eps; folded_copy takes
    # each BN's own
    sd = export.folded_copy(_random_stats(Darknet53(device="cpu"), 9)
                            ).state_dict()
    var = [v for k, v in sd.items() if k.endswith(".var")]
    assert len(var) == 52
    assert all(torch.all(v == torch.tensor(1 - 1e-3)) for v in var)
