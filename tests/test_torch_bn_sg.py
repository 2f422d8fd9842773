"""The frozen-statistics BatchNorm backward of the port against the JAX
package's (``set_bn_stats_stop_gradient`` / ``bn_stats_sg_ctx``,
``ConvBN._bn_sg_active``, ``_sg_batch_norm``), and
``Model.compile(bn_stats_sg_scope=...)``.

The port sets it per model (``models.layers.set_bn_stats_sg``, a
ConvBN's ``bn_sg``) where the JAX package reads a global at trace time.
Which ConvBNs a scope freezes is read from the JAX package by tracing a
train-mode YOLOv4 forward abstractly (``jax.eval_shape``, no compile)
with an interceptor that records each ConvBN's ``_bn_sg_active()``.
"""

import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.models import YoloV4 as JaxYoloV4
from tf2_yolo_tpu.models import layers as jlayers
from tests.helpers_torch import flat, numpy_tree, rel_l2
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch import engine
from tf2_yolo_tpu_torch.bridge import flax_leaves, from_flax
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.heads import AnchorHead
from tf2_yolo_tpu_torch.models.layers import ConvBN, set_bn_stats_sg
from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v4

torch.set_num_threads(1)

ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)
# (name, Ci, Co, kernel, stride, act) of the stack
STACK = [("a", 8, 16, 3, 1, "mish"), ("b", 16, 24, 1, 1, "leaky"),
         ("c", 24, 16, 3, 2, "mish")]


class _JStack(fnn.Module):
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train=True):
        for name, _, co, k, s, act in STACK:
            x = jlayers.ConvBN(co, k, s, act=act, fused=False,
                               bn_stats_sg=True, dtype=self.dtype,
                               name=name)(x, train)
        return x


class _TStack(torch.nn.Module):
    def __init__(self, dtype):
        super().__init__()
        for name, ci, co, k, s, act in STACK:
            self.add_module(name, ConvBN(ci, co, k, s, act=act, dtype=dtype,
                                         device="cpu"))

    def forward(self, x):
        for name, *_ in STACK:
            x = getattr(self, name)(x)
        return x


def _stack_case(jdtype, tdtype):
    rng = np.random.RandomState(0)
    # small multiples of 1/8: the first conv is exact in bf16 on both
    # sides
    x = rng.randint(-1, 2, size=(2, 8, 8, 8)).astype(np.float32)
    jm = _JStack(dtype=jdtype)
    v = numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    for name, _, co, *_ in STACK:
        v["params"][name]["bn"]["scale"] = (1 + 0.2 * rng.randn(co)).astype(
            np.float32)
        v["params"][name]["bn"]["bias"] = (0.1 * rng.randn(co)).astype(
            np.float32)
    r = rng.randn(2, 4, 4, 16).astype(np.float32)

    def loss(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * r), (out, upd)

    (_, (jout, jupd)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm = set_bn_stats_sg(_TStack(tdtype), True).train()
    tm.load_state_dict(from_flax(v), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    (out.float() * torch.from_numpy(r)).sum().backward()
    return dict(jout=np.asarray(jout, np.float32), out=out.detach().float()
                .numpy(), jstats=flat(numpy_tree(jupd["batch_stats"]),
                                      "batch_stats/"),
                jgrads={**flat(numpy_tree(jgp), "params/"),
                        "x": np.asarray(jgx)},
                model=tm, xgrad=xt.grad.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_sg_stack_matches_jax(dtype):
    """A stack of three ConvBNs in train mode with the statistics frozen:
    forward, running statistics, and the gradients of every parameter
    and of the input, against the JAX package's ``_sg_batch_norm``."""
    c = _stack_case(getattr(jnp, dtype), getattr(torch, dtype))
    tm = c["model"]
    assert all(getattr(tm, name).bn_sg for name, *_ in STACK)
    # measured forward max |d|: 6.5e-7 of max |out| 2.9 in f32; in bf16
    # 1 ulp (0.0156 at |out| 2.9: mish from two libraries, then the next
    # layer's statistics). Bounds 2e-6 and 2^-6 (about 3 ulps) of max
    # |out|. Running statistics: measured 1.2e-7 and 1.4e-5; bounds 1e-6
    # and 1e-4.
    scale = np.abs(c["jout"]).max()
    atol = (2e-6 if dtype == "float32" else 2 ** -6) * scale
    np.testing.assert_allclose(c["out"], c["jout"], rtol=0, atol=atol)
    stats = flax_leaves(tm)
    for k, want in c["jstats"].items():
        np.testing.assert_allclose(stats[k].detach().numpy(), want,
                                   rtol=0, atol=1e-6 if dtype == "float32"
                                   else 1e-4)
    grads = {k: g.numpy() for k, g in flax_leaves(tm, grad=True).items()}
    grads["x"] = c["xgrad"]
    assert grads.keys() == c["jgrads"].keys()
    # measured relative L2 at most 4.7e-7 (f32) and 1.7e-2 (bf16: the
    # backward convs round to bf16 in other places); bounds 1e-5 and 5e-2
    bound = 1e-5 if dtype == "float32" else 5e-2
    for k, want in c["jgrads"].items():
        assert rel_l2(grads[k], want) <= bound, (k, rel_l2(grads[k], want))


def test_bn_sg_changes_only_the_backward():
    """f32: the frozen route's forward equals the exact route's bit for
    bit, and its gradients differ (the dropped statistics term)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 8, 8, 8).astype(np.float32))
    r = torch.from_numpy(rng.randn(2, 4, 4, 16).astype(np.float32))
    runs = []
    for on in (False, True):
        torch.manual_seed(0)
        m = set_bn_stats_sg(_TStack(torch.float32), on).train()
        out = m(x)
        (out * r).sum().backward()
        runs.append((out.detach(), {k: p.grad.clone() for k, p in
                                    m.named_parameters()},
                     {k: b.clone() for k, b in m.named_buffers()}))
    (out0, g0, s0), (out1, g1, s1) = runs
    assert torch.equal(out0, out1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(not torch.equal(g0[k], g1[k])
               for k in g0 if k.endswith("conv.kernel"))


class _Named(torch.nn.Module):
    """ConvBNs named so that a scope must match whole components."""

    def __init__(self):
        super().__init__()
        self.backbone = ConvBN(3, 8, 3, 2, device="cpu")
        self.backbone_neck = ConvBN(8, 8, 1, device="cpu")
        self.neck = torch.nn.Module()
        self.neck.backbone = ConvBN(8, 8, 1, device="cpu")
        self.head = AnchorHead(8, ANCHORS[:3], 2, device="cpu")

    def forward(self, x):
        return self.head(self.neck.backbone(self.backbone_neck(
            self.backbone(x))))


def _frozen(model):
    return {n for n, m in model.named_modules()
            if isinstance(m, ConvBN) and m.bn_sg}


def test_scope_matches_whole_components():
    m = _Named()
    assert _frozen(set_bn_stats_sg(m, True, "backbone")) \
        == {"backbone", "neck.backbone"}
    assert _frozen(set_bn_stats_sg(m, True, ("neck", "x"))) \
        == {"neck.backbone"}
    assert _frozen(set_bn_stats_sg(m, True)) \
        == {"backbone", "backbone_neck", "neck.backbone"}
    assert _frozen(set_bn_stats_sg(m, False, "backbone")) == set()


def _compiled(scope):
    m = engine.Model(_Named(), (32, 32, 3), device="cpu")
    m.compile("sgd", loss=wrap_yolo_loss_v4((16, 16), 3, 2, ANCHORS[:3]),
              bn_stats_sg_scope=scope)
    return m


def test_compile_bn_sg_scope():
    """As the JAX engine: falsy values are off, True / a name / names
    are taken, anything else raises ValueError naming the argument; each
    compile sets it anew on its own model only."""
    for off in (None, False, "", (), []):
        assert _frozen(_compiled(off).module) == set()
    m = _compiled("backbone")
    assert _frozen(m.module) == {"backbone", "neck.backbone"}
    assert _frozen(_compiled(True).module) \
        == {"backbone", "backbone_neck", "neck.backbone"}
    assert _frozen(_compiled(["neck"]).module) == {"neck.backbone"}
    m.compile("sgd", loss=wrap_yolo_loss_v4((16, 16), 3, 2, ANCHORS[:3]))
    assert _frozen(m.module) == set()
    for bad in (5, 1.5, ["backbone", 3], object()):
        with pytest.raises(ValueError, match="bn_stats_sg_scope"):
            _compiled(bad)


@functools.cache
def _jax_frozen(scope, packed=0):
    """Paths of the JAX ConvBNs whose ``_bn_sg_active()`` is true in a
    train-mode YOLOv4 forward under ``bn_stats_sg_ctx(True, scope)``
    (traced, not compiled)."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, jlayers.ConvBN) and context.method_name \
                == "__call__":
            seen["/".join(mod.path)] = mod._bn_sg_active()
        return next_fun(*args, **kwargs)

    model = JaxYoloV4(anchors=ANCHORS, class_num=3)
    x = jax.ShapeDtypeStruct((4, 32, 32, 3), jnp.float32)
    variables = jax.eval_shape(
        lambda xx: model.init(jax.random.PRNGKey(0), xx, train=False), x)
    jlayers.set_packed_early(bool(packed), p3=packed == 3)
    try:
        with jlayers.bn_stats_sg_ctx(True, scope), \
                fnn.intercept_methods(record):
            jax.eval_shape(lambda v, xx: model.apply(
                v, xx, train=True, mutable=["batch_stats"]), variables, x)
    finally:
        jlayers.set_packed_early(False)
    return {k.replace("/", ".") for k, on in seen.items() if on}


@pytest.mark.parametrize("packed", [0, 1, 3])
def test_frozen_convbns_match_jax(packed):
    """``scope="backbone"`` freezes the ConvBNs that the JAX package
    freezes: the whole backbone on the plain route (72), the stem and
    stages 1-2 at ``packed=True`` (17; the packed stages 3-5 keep exact
    BN, as the JAX package's packed regions do) and none at
    ``packed=3``, whose backbone is all packed regions. A ConvBN counts
    as frozen on the port when its forward runs in train mode with
    ``bn_sg`` set (the packed regions read its parameters without
    calling it)."""
    want = _jax_frozen("backbone", packed)
    model = YoloV4(ANCHORS, 3, device="cpu", packed=packed)
    set_bn_stats_sg(model, True, "backbone").train()
    ran = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: ran.add(name) if mod.bn_sg else None)
        for name, m in model.named_modules() if isinstance(m, ConvBN)]
    with torch.no_grad():
        model(torch.rand(4, 32, 32, 3))
    for h in hooks:
        h.remove()
    assert ran == want
    assert len(want) == {0: 72, 1: 17, 3: 0}[packed]


def test_backbone_step_touches_the_backbone():
    """One f32 step of a small ``YoloV4(packed=False)`` with
    ``scope="backbone"`` against the exact one from the same weights:
    the loss and every neck and head gradient equal bit for bit (the
    forward is the same arithmetic in f32), the conv kernel of every
    frozen ConvBN (the JAX package's set, above) takes another
    gradient."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
    r = [torch.from_numpy(rng.randn(2, s, s, 24).astype(np.float32))
         for s in (1, 2, 4)]
    runs = []
    for scope in (None, "backbone"):
        # the same seeded weights; one model alive at a time
        m = YoloV4(ANCHORS, 3, generator=torch.Generator().manual_seed(0),
                   device="cpu")
        set_bn_stats_sg(m, scope is not None, scope).train()
        loss = sum((o * ri).sum() for o, ri in zip(m(x), r))
        loss.backward()
        runs.append((loss.item(), {k: p.grad for k, p in
                                   m.named_parameters()}))
        del m, loss
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    frozen = _jax_frozen("backbone")
    for k in g0:
        if not k.startswith("backbone."):
            assert torch.equal(g0[k], g1[k]), k
        elif k.endswith(".conv.kernel") and k[:-len(".conv.kernel")] \
                in frozen:
            assert not torch.equal(g0[k], g1[k]), k
