"""Worker process of the port's multi-process tests
(tests/test_torch_multiprocess.py, test_torch_parallel.py,
test_torch_tensor_parallel.py, test_torch_pipeline.py).

One process of a run of the PyTorch port on the CPU: gloo, a FileStore
rendezvous, this process's share of the rows. It imports torch, numpy and
the port only, never JAX: the parent test holds what the workers write
against the JAX package on the concatenated data.

    python _torch_multiprocess_worker.py <mode> <pid> <nprocs> <store> <dir>

``mode`` "stacks": a two-ConvBN stack, a packed=1 CSP stage and a v2 UNet
ConvActBN, one data-parallel train step each (SGD at learning rate 0, so the parameters stay
put), with the differentiable reduce of the BatchNorm sums and again with
an in-place one; ``<dir>/stacks.pt`` holds the weights and data, the
result goes to ``<dir>/stacks_<pid>.pt``.

``mode`` "fit": YOLOv2 at 64^2 on 16 images, as tests/test_multihost.py's
worker: evaluate and predict on the initial weights, fit 2 epochs with a
checkpoint after each (the variables after its first step kept apart),
and a fit resumed from the epoch-1 checkpoint to 2 epochs; ``<dir>/v2.pt`` holds the initial weights, the result goes to
``<dir>/fit_<pid>.json``.

``mode`` "tp" (4 processes): tests/test_sharding.py's TinyDetector on a
``(data 2, model 2)`` grid (``Model.compile(n_model=2,
tp_min_channels=16)``): fit 2 epochs of one step with a checkpoint after
each (the first step's collectives and gathered variables kept apart), a
restore of the last checkpoint into an unsliced model, a sliced model
resumed from the first, and the same fit at ``n_model=1``; then one step
of each of YOLOv4 with ResNet-50, YOLOv2 with MobileNetV2 and with the
UNet, and a classifier (a Dense on a ResNet v2 block: a lone BatchNorm
and convs without one), sliced and unsliced (``tp_families``);
``<dir>/tp.pt`` holds
the weights and data, the result goes to ``<dir>/tp_<pid>.pt``.

``mode`` "space" (4 processes): spatial partitioning. tests/test_sharding.py's
TinyDetector step (SGD 1e-2) on a ``(data 1, space 4)`` grid, whose
pooled level splits 1 + 1 + 0 + 0, and on a ``(2, 2)`` grid, with its
collectives; then, on the ``(2, 2)`` grid, each family model of
``<dir>/space.pt`` (f32, batch 2, rows that split unevenly): its eval
forward and its input's gradient, and one train step (SGD at learning
rate 0) of a linear loss whose running statistics and gradients (those of
the big leaves ``sampled``) it keeps; ``<dir>/space.pt``
holds the weights and data, the result goes to ``<dir>/space_<pid>.pt``.

``mode`` "pipe" (4 processes): tests/test_pipeline.py's two stages on the
stage meshes {0, 1} and {2, 3} (``PipelineExecutor(meshes=)``): the
forward, ``value_and_grad``, three SGD steps, the train-mode BatchNorm
step, ``merged_variables``; ``<dir>/pipe.pt`` holds the weights and
data, the result goes to ``<dir>/pipe_<pid>.pt``.
"""

import gc
import hashlib
import json
import os
import shutil
import sys
import zlib

import numpy as np
import torch


def fixture_data():
    """tests/test_multihost.py's data (same seed)."""
    rng = np.random.RandomState(0)
    n, size, classes = 16, 64, 2
    anchors = np.stack([np.linspace(0.1, 0.6, 5),
                        np.linspace(0.15, 0.55, 5)], axis=1)
    x = rng.rand(n, size, size, 3).astype(np.float32)
    g = size // 32
    y = np.zeros((n, g, g, 5 + classes), np.float32)
    for b in range(n):
        gy, gx = rng.randint(0, g, 2)
        y[b, gy, gx, :5] = [*rng.rand(2), 0.3, 0.4, 1.0]
        y[b, gy, gx, 5 + rng.randint(classes)] = 1.0
    return x, y, anchors, g, classes


class Stack(torch.nn.Module):
    """Two ConvBNs: 3x3 stride 1 mish, 3x3 stride 2 leaky."""

    def __init__(self, ci=8, co=16):
        super().__init__()
        from tf2_yolo_tpu_torch.models.layers import ConvBN
        self.a = ConvBN(ci, co, 3, 1, act="mish", device="cpu")
        self.b = ConvBN(co, co, 3, 2, act="leaky", device="cpu")

    def forward(self, x):
        self.last = self.b(self.a(x))
        return self.last


class PackedStage(torch.nn.Module):
    """A CSPStage through the fused-GEMM route of ``packed=1``, on an
    activated input."""

    def __init__(self, ci=16, co=32, blocks=2):
        super().__init__()
        from tf2_yolo_tpu_torch.models.backbones import CSPStage
        self.stage = CSPStage(ci, co, blocks, device="cpu")

    def forward(self, x):
        from tf2_yolo_tpu_torch.models import packed_region as region
        y2, aff, (b, h, w) = region.packed_stage(self.stage, x)
        self.last = region.rows_to(
            region.activate(y2, aff, "mish", torch.float32), b, h, w)
        return self.last


class UNetBlock(torch.nn.Module):
    """The v2 UNet's ConvActBN: its statistics come from a reduction of
    the activated tensor, not from the conv kernel's sums."""

    def __init__(self, ci=8, co=16):
        super().__init__()
        from tf2_yolo_tpu_torch.models.layers import ConvActBN
        self.block = ConvActBN(ci, co, 3, act="relu", device="cpu")

    def forward(self, x):
        self.last = self.block(x)
        return self.last


TINY_ANCHORS = np.array([[0.2, 0.2], [0.4, 0.3]], np.float32)


class TinyDetector(torch.nn.Module):
    """tests/test_sharding.py's TinyDetector under flax's names: two
    ConvBNs (16 and 32 channels, 3x3 stride 2, leaky), an 8x8 average
    pool and a softmax anchor head of 2 anchors and 2 classes."""

    def __init__(self):
        super().__init__()
        from tf2_yolo_tpu_torch.models.heads import AnchorHead
        from tf2_yolo_tpu_torch.models.layers import (AvgPool, ConvBN,
                                                      he_normal_)
        self.ConvBN_0 = ConvBN(3, 16, 3, 2, act="leaky", device="cpu")
        self.ConvBN_1 = ConvBN(16, 32, 3, 2, act="leaky", device="cpu")
        self.pool = AvgPool(8)
        self.AnchorHead_0 = AnchorHead(32, TINY_ANCHORS, 2,
                                       prob_act="softmax",
                                       anchors_as_params=False,
                                       init=he_normal_, device="cpu")

    def forward(self, x):
        return self.AnchorHead_0(self.pool(self.ConvBN_1(self.ConvBN_0(x))))


@torch.no_grad()
def _clipped_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
    return t.normal_(mean, std, generator=generator).clamp_(a, b)


def family_model(name, bn_stats=None):
    """A family network of the "space" and "tp" modes, f32 on the CPU,
    by ``name``: ``v4`` (``packed=False``), ``v4_resnet50``,
    ``v3_resnet50v2``, ``v2_darknet``, ``v2_mobilenet``, ``v2_unet``,
    ``v1``; 3 classes.
    Its weights come from a seed (the same in every process), the
    truncated normals drawn as normals clamped to the same interval
    (``trunc_normal_`` takes seconds for the 10^7-element kernels);
    ``bn_stats`` (a part of a ``state_dict``) is loaded over them."""
    from tf2_yolo_tpu_torch.models import YoloV1, YoloV2, YoloV3, YoloV4
    anchors = np.stack([np.linspace(0.1, 0.8, 9),
                        np.linspace(0.1, 0.7, 9)], axis=1)
    gen = torch.Generator().manual_seed(0)
    kw = dict(device="cpu", generator=gen)
    trunc, torch.nn.init.trunc_normal_ = (torch.nn.init.trunc_normal_,
                                          _clipped_normal_)
    try:
        if name.startswith("v4"):
            model = YoloV4(anchors, 3, backbone=name[3:] or "csp_darknet",
                           **kw)
        elif name.startswith("v3"):
            model = YoloV3(anchors, 3, backbone=name[3:], **kw)
        elif name.startswith("v2"):
            model = YoloV2(anchors[:5], 3, backbone=name[3:], **kw)
        else:
            model = YoloV1(2, 3, **kw)
    finally:
        torch.nn.init.trunc_normal_ = trunc
    if bn_stats is not None:
        model.load_state_dict(bn_stats, strict=False)
    return model


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


SAMPLE = 4096


def sampled(leaves):
    """``{name: tensor}`` with each leaf of more than 16 SAMPLE elements
    cut to SAMPLE of them, drawn by a generator seeded from its name
    (the same elements wherever it is called): the big models'
    gradients compared without moving them whole between processes."""
    out = {}
    for k, t in leaves.items():
        t = t.detach()
        if t.numel() > 16 * SAMPLE:
            gen = torch.Generator().manual_seed(zlib.crc32(k.encode()))
            t = t.flatten()[torch.randint(t.numel(), (SAMPLE,),
                                          generator=gen)]
        out[k] = t.clone()
    return out


def linear_loss(ct, out):
    """A loss linear in the outputs (the "stacks" mode's): its gradient
    does not depend on the outputs' rounding."""
    return (out * ct).sum() / out.shape[0]


class Stage(torch.nn.Module):
    """tests/test_pipeline.py's stages: flax ``nn.Conv(co, (3, 3),
    stride)`` (SAME, biased) and, with ``bn``,
    ``nn.BatchNorm(momentum=0.9)`` (eps 1e-5); then relu (stage 0) or the
    spatial mean (stage 1), under flax's auto names."""

    def __init__(self, ci, co, stride, bn, last):
        super().__init__()
        from tf2_yolo_tpu_torch.models.layers import BNState, Conv
        self.Conv_0 = Conv(ci, co, 3, stride, use_bias=True, device="cpu",
                           padding="same")
        if bn:
            self.BatchNorm_0 = BNState(co, "cpu", eps=1e-5, momentum=0.9)
        self.bn, self.last = bn, last

    def forward(self, x):
        y = self.Conv_0(x)[0]
        if self.bn:
            y = self.BatchNorm_0(y)
        return y.mean(dim=(1, 2)) if self.last else torch.relu(y)


def stage_fn(train):
    """A stage callable of ``PipelineExecutor`` in eval or train mode."""
    def fn(module, a):
        module.train(train)
        return module(a)
    return fn


def inplace_all_reduce(t, group):
    """The wrong reduce: the sum in the forward, but invisible to
    autograd, whose backward then passes the local cotangent only."""
    import torch.distributed as dist
    out = t.clone()
    dist.all_reduce(out.data, group=group)
    return out


def run_stacks(pid, io_dir):
    from tf2_yolo_tpu_torch import bridge
    from tf2_yolo_tpu_torch.models import layers
    from tf2_yolo_tpu_torch.parallel import (make_optimizer,
                                             make_train_step,
                                             process_batch_slice)
    from tf2_yolo_tpu_torch.parallel.multihost import default_group
    from tf2_yolo_tpu_torch.parallel.train import TrainState

    data = torch.load(os.path.join(io_dir, "stacks.pt"), weights_only=True)
    result = {"mesh": run_mesh(data)}
    step = make_train_step(
        [lambda ct, out: (out * ct).sum() / out.shape[0]],
        group=default_group())
    differentiable = layers._all_reduce
    for name, cls in (("convbn", Stack), ("csp", PackedStage),
                      ("convactbn", UNetBlock)):
        x, ct = data[f"{name}_x"], data[f"{name}_ct"]
        sl = process_batch_slice(x.shape[0])
        for reduce in ("differentiable", "inplace"):
            layers._all_reduce = (differentiable if reduce == "differentiable"
                                  else inplace_all_reduce)
            model = cls()
            model.load_state_dict(data[f"{name}_weights"])
            layers.set_bn_group(model, default_group())
            batch = {}
            for mod_name, m in model.named_modules():
                if isinstance(m, layers.BNState):
                    def capture(mean, var, _n=mod_name, _f=m.update_running):
                        batch[_n] = (mean.detach().clone(),
                                     var.detach().clone())
                        _f(mean, var)
                    m.update_running = capture
            state = TrainState(model, make_optimizer("sgd", 0.0)(model))
            _, logs = step(state, x[sl], (ct[sl],))
            result[f"{name}/{reduce}"] = dict(
                out=model.last.detach(), batch=batch,
                loss=logs["loss"].detach(),
                leaves={k: v.detach().clone()
                        for k, v in bridge.flax_leaves(model).items()},
                grads={k: v.detach().clone() for k, v in
                       bridge.flax_leaves(model, grad=True).items()})
    layers._all_reduce = differentiable
    torch.save(result, os.path.join(io_dir, f"stacks_{pid}.pt"))


def run_mesh(data):
    """``make_mesh(n_model=2)`` of the two processes, and one ConvBN
    sliced over it: its place, its groups, and its gathered output and
    gradients beside the whole layer's, on the stacks' first input."""
    from tf2_yolo_tpu_torch.models.layers import ConvBN, set_tensor_parallel
    from tf2_yolo_tpu_torch.parallel import (make_mesh,
                                             tensor_parallel_shardings)
    from tf2_yolo_tpu_torch.parallel.collectives import recording
    mesh = make_mesh(n_model=2)
    out = dict(shape=mesh.shape, ranks=mesh.ranks,
               data_index=mesh.data_index, model_index=mesh.model_index,
               data_ranks=mesh.data_ranks,
               no_data_group=mesh.data_group is None,
               same=make_mesh(n_model=2) is mesh,
               model_group_size=torch.distributed.get_world_size(
                   mesh.model_group))
    x = data["convbn_x"].clone().requires_grad_()
    layers = []
    for sliced in (False, True):
        torch.manual_seed(0)
        layer = ConvBN(8, 16, 3, 1, act="mish", device="cpu").eval()
        if sliced:
            plan = tensor_parallel_shardings(layer, mesh, min_channels=16)
            set_tensor_parallel(layer, mesh, plan)
        with recording() as records:
            y = layer(x)
            (gx,) = torch.autograd.grad((y * y).sum(), x)
        layers.append(dict(y=y.detach(), gx=gx,
                           kernel=tuple(layer.conv.kernel.shape),
                           records=[(r.kind, r.dim, r.numel)
                                    for r in records]))
    out["whole"], out["sliced"] = layers
    return out


def peak_rss():
    """This process's peak resident bytes since it started its program
    (VmHWM; ``ru_maxrss`` would also count the parent's memory at the
    fork that started this process)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmHWM in /proc/self/status")


def digest(module):
    """abs_sum and sum over the state_dict in f64, and a hash of every
    leaf's bytes (bit-for-bit comparison across processes and runs)."""
    sd = module.state_dict()
    return dict(
        abs_sum=float(sum(v.double().abs().sum() for v in sd.values())),
        sum=float(sum(v.double().sum() for v in sd.values())),
        hashes={k: hashlib.sha1(v.detach().cpu().numpy().tobytes())
                .hexdigest() for k, v in sd.items()},
        buffers={k: hashlib.sha1(v.cpu().numpy().tobytes()).hexdigest()
                 for k, v in module.named_buffers()})


def run_fit(pid, io_dir):
    from tf2_yolo_tpu_torch.engine import Model
    from tf2_yolo_tpu_torch.models import YoloV2
    from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v2
    from tf2_yolo_tpu_torch.parallel import process_batch_slice
    from tf2_yolo_tpu_torch.parallel.multihost import barrier

    x, y, anchors, g, classes = fixture_data()
    sl = process_batch_slice(x.shape[0])
    xs, ys = x[sl], y[sl]
    module = YoloV2(anchors, classes, device="cpu")

    def fresh():
        """A new Model on the initial weights (the module is reused:
        everything a step changes is in its state_dict, which is
        loaded anew, and compile makes a new optimizer)."""
        module.zero_grad(set_to_none=True)
        gc.collect()
        m = Model(module, (64, 64, 3), device="cpu")
        m.set_variables(torch.load(os.path.join(io_dir, "v2.pt"),
                                   weights_only=True))
        m.compile("adam", learning_rate=1e-3,
                  loss=wrap_yolo_loss_v2((g, g), 5, classes, anchors))
        return m

    model = fresh()
    out = dict(pid=pid, rss=[("fresh", peak_rss() / 2 ** 30)])
    out["eval0"] = model.evaluate(xs, ys, batch_size=4, verbose=0)["loss"]
    pred = model.predict(xs[:4], batch_size=4)
    out["pred_abs_sum"] = float(np.abs(np.float64(pred)).sum())

    class FirstStep:
        """The loss and the variables after the first step (one global
        batch of 8: this process's first 4 rows)."""

        def on_train_batch_end(self, batch, logs, m):
            if "step1" not in out:
                out["step1_loss"] = float(logs["loss"])
                out["step1"] = digest(m.module)

    # 2 epochs with a checkpoint after each (process 0 writes)
    ck = os.path.join(io_dir, "ckpt")
    out["loss"] = model.fit(xs, ys, epochs=2, batch_size=4, shuffle=False,
                            verbose=0, callbacks=[FirstStep()],
                            checkpoint_dir=ck, checkpoint_every=1)["loss"]
    out["digest"] = digest(model.module)
    out["rss"].append(("fit", peak_rss() / 2 ** 30))

    # a fresh model resumed from the epoch-1 checkpoint alone to 2
    # epochs: the uninterrupted run, bit for bit
    ck1 = os.path.join(io_dir, "ckpt_epoch1")
    if pid == 0:
        shutil.copytree(os.path.join(ck, "step_2"),
                        os.path.join(ck1, "step_2"))
    barrier()
    del model
    model = fresh()
    out["rss"].append(("fresh2", peak_rss() / 2 ** 30))
    hist = model.fit(xs, ys, epochs=2, batch_size=4, shuffle=False,
                     verbose=0, checkpoint_dir=ck1, resume=True)
    out["resume_loss"] = hist["loss"]
    out["resume"] = digest(model.module)
    out["max_rss_bytes"] = peak_rss()
    with open(os.path.join(io_dir, f"fit_{pid}.json"), "w") as f:
        json.dump(out, f)


def _collective_axes(records, mesh):
    return [dict(kind=r.kind, dim=r.dim, numel=r.numel,
                 axis=("model" if r.group is mesh.model_group else
                       "data" if r.group is mesh.data_group else "other"))
            for r in records]


def run_tp(pid, io_dir):
    from tf2_yolo_tpu_torch.engine import Model
    from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v2
    from tf2_yolo_tpu_torch.parallel import (make_optimizer,
                                             process_batch_slice,
                                             restore_checkpoint)
    from tf2_yolo_tpu_torch.parallel.checkpoint import _optimizer_tree
    from tf2_yolo_tpu_torch.parallel.collectives import (Shard, recording,
                                                         sharded_dims)
    from tf2_yolo_tpu_torch.parallel.multihost import barrier
    from tf2_yolo_tpu_torch.parallel.train import TrainState

    data = torch.load(os.path.join(io_dir, "tp.pt"), weights_only=True)
    x, y = data["x"].numpy(), data["y"].numpy()
    loss = wrap_yolo_loss_v2((2, 2), 2, 2, TINY_ANCHORS)

    def fresh(n_model):
        m = Model(TinyDetector(), (64, 64, 3), device="cpu")
        m.set_variables(data["weights"])
        m.compile("sgd", loss=loss, learning_rate=1e-2, n_model=n_model,
                  tp_min_channels=16)
        return m

    out = dict(pid=pid)
    model = fresh(2)
    mesh = model.mesh
    sl = process_batch_slice(x.shape[0], mesh)
    out["mesh"] = dict(data_index=mesh.data_index,
                       model_index=mesh.model_index, rows=(sl.start, sl.stop))

    class FirstStep:
        """The first step's collectives, loss and gathered variables."""

        def on_epoch_begin(self, epoch, m):
            if epoch == 0:
                self.rec = recording()
                self.records = self.rec.__enter__()

        def on_train_batch_end(self, batch, logs, m):
            if "step1" in out:
                return
            self.rec.__exit__(None, None, None)
            out["collectives"] = _collective_axes(self.records, mesh)
            out["step1_loss"] = float(logs["loss"])
            out["step1"] = {k: v.clone() for k, v in m.variables.items()}

    ck = os.path.join(io_dir, "ck_tp")
    out["loss"] = model.fit(x[sl], y[sl], epochs=2, batch_size=4,
                            shuffle=False, verbose=0,
                            callbacks=[FirstStep()], checkpoint_dir=ck,
                            checkpoint_every=1)["loss"]
    out["final"] = {k: v.clone() for k, v in model.variables.items()}
    out["final_moments"] = _optimizer_tree(model._state, Shard.gather)
    dims = sharded_dims(model.module)
    out["sharded"] = dims
    out["local_shapes"] = {k: tuple(v.shape)
                           for k, v in model.module.state_dict().items()}
    out["count_params"] = model.count_params()
    # the whole leaves and their moments, as this process holds them
    moments = model._state.optimizer.state_dict()["state"]
    out["replicated"] = {k: v.clone() for k, v in
                         model.module.state_dict().items() if k not in dims}
    names = [n for n, _ in model.module.named_parameters()]
    out["replicated_moments"] = {
        names[i]: {k: v.clone() for k, v in st.items()}
        for i, st in moments.items() if names[i] not in dims}

    # the last checkpoint restored into an unsliced model (process 0)
    if pid == 0:
        whole = TinyDetector()
        state = TrainState(whole, make_optimizer("sgd", 1e-2)(whole))
        restore_checkpoint(os.path.join(ck, "step_2"), state)
        out["restored"] = {k: v.clone() for k, v in
                           whole.state_dict().items()}
        out["restored_moments"] = state.optimizer.state_dict()
    # a sliced resume from the first checkpoint alone
    ck1 = os.path.join(io_dir, "ck_tp_epoch1")
    if pid == 0:
        shutil.copytree(os.path.join(ck, "step_1"),
                        os.path.join(ck1, "step_1"))
    barrier()
    resumed = fresh(2)
    out["resume_loss"] = resumed.fit(x[sl], y[sl], epochs=2, batch_size=4,
                                     shuffle=False, verbose=0,
                                     checkpoint_dir=ck1,
                                     resume=True)["loss"]
    out["resumed"] = {k: v.clone() for k, v in resumed.variables.items()}

    # the same fit at n_model=1: four processes on the data axis
    dp = fresh(1)
    sl1 = process_batch_slice(x.shape[0])
    out["dp_loss"] = dp.fit(x[sl1], y[sl1], epochs=2, batch_size=2,
                            shuffle=False, verbose=0)["loss"]
    out["families"] = tp_families(mesh)
    torch.save(out, os.path.join(io_dir, f"tp_{pid}.pt"))


TP_FAMILIES = ("v4_resnet50", "v2_mobilenet", "v2_unet", "classifier")
TP_CHAOTIC = ("v4_resnet50", "v2_mobilenet", "classifier")


class PreactBody(torch.nn.Module):
    """Two ConvBNs to 128 channels, then a ResNet v2 bottleneck: its
    ``pre_bn`` a lone BatchNorm and its ``conv3`` and projection convs
    without one, all 128 wide."""

    def __init__(self):
        super().__init__()
        from tf2_yolo_tpu_torch.models.layers import ConvBN
        from tf2_yolo_tpu_torch.models.resnet import BottleneckV2
        self.a = ConvBN(3, 128, 3, 1, act="mish", device="cpu")
        self.b = ConvBN(128, 128, 3, 2, act="leaky", device="cpu")
        self.block = BottleneckV2(128, 32, project=True, device="cpu")

    def forward(self, x):
        return self.block(self.b(self.a(x)))


def tp_family_model(name):
    """:func:`family_model`, or ``"classifier"``: a ``Classifier`` whose
    Dense (128 -> 256) the plan slices, on :class:`PreactBody`."""
    if name != "classifier":
        return family_model(name)
    from tf2_yolo_tpu_torch.models import Classifier
    torch.manual_seed(0)
    return Classifier(PreactBody(), 256, features=128, device="cpu")


def tp_families(mesh):
    """One train step (SGD at learning rate 0, the linear loss) of each
    of TP_FAMILIES at 32^2 on the (data 2, model 2) grid, batch 4: sliced
    at n_model 2 (``tensor_parallel_shardings`` at its default gate of
    128), unsliced (n_model 1: the statistics and gradients over the same
    data group), and, for TP_CHAOTIC, unsliced on the images moved by
    1e-6 (the probe of the train-mode chaos; 0 for the others); before
    the whole and the sliced step, from running statistics of
    :func:`_layer_statistics`, the eval forward and its backward.
    Returns {name: {"loss": {run: loss}, "leaves": {name:
    (rel L2 sliced, rel L2 probe, the leaf's norm, the norm of its
    layer's kernel or scale)}, "eval_leaves": {name: rel L2 of the
    sliced eval gradient to the whole one}, "sliced": [names]}}, the
    gradients and running statistics gathered (gradients ``sampled``)."""
    from tf2_yolo_tpu_torch.models.layers import (set_bn_group,
                                                  set_tensor_parallel)
    from tf2_yolo_tpu_torch.parallel import (make_optimizer,
                                             make_train_step,
                                             tensor_parallel_shardings)
    from tf2_yolo_tpu_torch.parallel.collectives import gather_state_dict
    from tf2_yolo_tpu_torch.parallel.train import TrainState

    from tf2_yolo_tpu_torch.parallel import process_batch_slice

    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32))
    sl = process_batch_slice(4, mesh)
    out = {}
    for name in TP_FAMILIES:
        model = tp_family_model(name)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            heads = _as_list(model.eval()(x[:1]))
        cts = [torch.from_numpy(rng.randn(4, *h.shape[1:]).astype(
            np.float32))[sl] for h in heads]
        runs, evals = {}, {}
        calibrated = _layer_statistics(model, x[sl])
        # the probe only where the train-mode step is chaotic
        probe = (("probe", 1e-6),) if name in TP_CHAOTIC else ()
        for run, eps in (("whole", 0.0), *probe, ("sliced", 0.0)):
            model.load_state_dict(init)
            model.load_state_dict(calibrated, strict=False)
            set_bn_group(model, mesh.data_group)
            if run == "sliced":
                set_tensor_parallel(model, mesh,
                                    tensor_parallel_shardings(model, mesh))
            # the eval forward on the layers' statistics and its
            # backward: no train-mode chaos (the probe needs none)
            model.zero_grad(set_to_none=True)
            if run != "probe":
                sum(linear_loss(ct, h) for ct, h in zip(
                    cts, _as_list(model.eval()(x[sl])))).backward()
                evals[run] = sampled(gather_state_dict(
                    model, {k: p.grad for k, p in model.named_parameters()}))
            state = TrainState(model, make_optimizer("sgd", 0.0)(model))
            step = make_train_step([linear_loss] * len(cts),
                                   group=mesh.data_group)
            _, logs = step(state, x[sl] + eps, tuple(cts))
            grads = {k: p.grad for k, p in model.named_parameters()}
            stats = {k: v.clone() for k, v in model.named_buffers()
                     if k.endswith(("mean", "var"))}
            runs[run] = (float(logs["loss"]),
                         sampled(gather_state_dict(model, grads)),
                         gather_state_dict(model, stats))
        out[name] = dict(loss={k: v[0] for k, v in runs.items()},
                         sliced=sorted(model.tensor_parallel[1]),
                         leaves=_compare(runs),
                         eval_leaves={k: float((evals["sliced"][k] - w).norm()
                                               / max(float(w.norm()), 1e-30))
                                      for k, w in evals["whole"].items()})
        del model, state
        gc.collect()
    return out


def _layer_statistics(model, x):
    """Running statistics for an eval forward without chaos: each BN's
    mean and variance set to those of its whole input on ``x``, over
    every channel (one value a layer), so that no channel's few values
    scale it up and no activation vanishes with depth."""
    from tf2_yolo_tpu_torch.models.layers import BNState

    def hook(bn, args):
        y = args[0].float()
        bn.mean.fill_(float(y.mean()))
        bn.var.fill_(float(y.var(unbiased=False)))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BNState)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in handles:
            h.remove()
    return {k: v.clone() for k, v in model.named_buffers()
            if k.endswith(("mean", "var"))}


def _compare(runs):
    """{leaf: (rel L2 of sliced to whole, of probe to whole, the whole
    leaf's norm, the norm of its layer's kernel or scale gradient)} over
    the gradients and running statistics of ``runs``."""
    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    out = {}
    for i in (1, 2):
        whole, sliced = runs["whole"][i], runs["sliced"][i]
        probe = runs["probe"][i] if "probe" in runs else whole
        for k, w in whole.items():
            base = k[:-len("bias")] if k.endswith("bias") else None
            other = whole.get(f"{base}kernel", whole.get(f"{base}scale")) \
                if base is not None else None
            out[k] = (rel(sliced[k], w), rel(probe[k], w), float(w.norm()),
                      None if other is None else float(other.norm()))
    return out


def _space_records(records, mesh):
    return [dict(kind=r.kind, dim=r.dim, numel=r.numel, rows=r.rows,
                 axis=("space" if r.group is mesh.space_group else
                       "grid" if r.group is mesh.group else "other"))
            for r in records]


def run_space(pid, io_dir):
    from tf2_yolo_tpu_torch.models.layers import set_spatial_parallel
    from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v2
    from tf2_yolo_tpu_torch.parallel import (make_mesh_spatial,
                                             make_optimizer, make_train_step,
                                             process_batch_slice,
                                             spatial_sharding)
    from tf2_yolo_tpu_torch.parallel.collectives import recording
    from tf2_yolo_tpu_torch.parallel.train import TrainState

    data = torch.load(os.path.join(io_dir, "space.pt"), weights_only=True)
    meshes = {"1x4": make_mesh_spatial(1, 4), "2x2": make_mesh_spatial(2, 2)}
    out = dict(pid=pid, mesh={
        k: dict(shape=m.shape, data_index=m.data_index,
                space_index=m.space_index, space_ranks=m.space_ranks,
                same=make_mesh_spatial(m.shape["data"], m.shape["space"])
                is m)
        for k, m in meshes.items()})

    # tests/test_sharding.py's TinyDetector step on both grids
    tiny = data["tiny"]
    loss = wrap_yolo_loss_v2((2, 2), 2, 2, TINY_ANCHORS)
    for key, mesh in meshes.items():
        model = TinyDetector()
        model.load_state_dict(tiny["weights"])
        set_spatial_parallel(model, mesh, (64, 64))
        state = TrainState(model, make_optimizer("sgd", 1e-2)(model))
        step = make_train_step([loss], mesh=mesh)
        xs = spatial_sharding(mesh)(tiny["x"])
        ys = tiny["y"][process_batch_slice(tiny["y"].shape[0], mesh)]
        with recording() as records:
            _, logs = step(state, xs, (ys,))
        out[f"tiny_{key}"] = dict(
            loss=float(logs["loss"]), rows=tuple(xs.shape),
            records=_space_records(records, mesh),
            variables={k: v.clone() for k, v in model.state_dict().items()})

    # the families on the (2, 2) grid: an eval forward and a step
    mesh = meshes["2x2"]
    for name, fam in data["families"].items():
        model = family_model(name)
        model.load_state_dict(fam["eval_stats"], strict=False)
        set_spatial_parallel(model, mesh, tuple(fam["x"].shape[1:3]))
        sl = process_batch_slice(fam["x"].shape[0], mesh)
        cts = tuple(ct[sl] for ct in fam["cts"])
        # the eval forward on running statistics of _layer_statistics,
        # and the gradients of the input and of every leaf: each windowed
        # layer's backward and the row exchanges' without the chaos of
        # BatchNorm statistics over a few values
        xs = spatial_sharding(mesh)(fam["x"]).clone().requires_grad_()
        heads = _as_list(model.eval()(xs))
        sum(linear_loss(ct, h) for ct, h in zip(cts, heads)).backward()
        eval_grads = sampled({k: p.grad for k, p in
                              model.named_parameters()})
        model.zero_grad(set_to_none=True)
        model.load_state_dict(fam["bn_stats"], strict=False)
        state = TrainState(model, make_optimizer("sgd", 0.0)(model))
        step = make_train_step([linear_loss] * len(heads), mesh=mesh)
        with recording() as records:
            _, logs = step(state, xs.detach(), cts)
        out[name] = dict(
            heads=[h.detach().clone() for h in heads], dx=xs.grad.clone(),
            eval_grads=eval_grads, loss=float(logs["loss"]),
            fetched=max(r.rows for r in records if r.kind == "row_fetch"),
            grads=sampled({k: p.grad for k, p in model.named_parameters()}),
            norms={k: float(p.grad.norm())
                   for k, p in model.named_parameters()},
            stats={k: v.clone() for k, v in model.named_buffers()
                   if k.endswith(("mean", "var"))})
        if mesh.space_index != 0:
            out[name].pop("heads")
        if pid != 0:
            for k in ("grads", "norms", "stats"):
                out[name].pop(k)
        del model, state
        gc.collect()
    out["max_rss_bytes"] = peak_rss()
    torch.save(out, os.path.join(io_dir, f"space_{pid}.pt"))


def run_pipe(pid, io_dir):
    from tf2_yolo_tpu_torch.parallel import (PipelineExecutor, make_mesh,
                                             make_optimizer)

    data = torch.load(os.path.join(io_dir, "pipe.pt"), weights_only=True)
    meshes = [make_mesh(ranks=[0, 1]), make_mesh(ranks=[2, 3])]
    out = dict(pid=pid)

    def mse(o, yb):
        return ((o - yb) ** 2).mean()

    def pipeline(bn):
        mods = [Stage(3, 8, 1, bn, False), Stage(8, 4, 2, bn, True)]
        key = "bn" if bn else "plain"
        for m, w in zip(mods, data[f"{key}_weights"]):
            m.load_state_dict(w, strict=True)
        return PipelineExecutor([stage_fn(False)] * 2, mods, meshes=meshes,
                                train_stages=[stage_fn(True)] * 2)

    x, y = data["x"], data["y"]
    pipe = pipeline(False)
    out["stage"] = pipe.stage
    out["run"] = pipe.run(x, microbatch=4)
    loss, grads = pipe.value_and_grad(mse, train=False)(x, y, microbatch=4)
    out["loss"], out["grads"] = float(loss), grads
    tx = make_optimizer("sgd", 0.1)
    opt = pipe.init_opt(tx)
    step = pipe.value_and_grad(mse, train=False)
    losses = []
    for _ in range(3):
        loss, g = step(x, torch.zeros_like(y), microbatch=4)
        pipe.apply_grads(tx, opt, g)
        losses.append(float(loss))
    out["sgd_losses"] = losses
    out["merged"] = pipe.merged_variables()
    # train-mode BatchNorm, the whole batch a microbatch: the statistics
    # over the stage's two processes
    bn = pipeline(True)
    xb, yb = data["bn_x"], data["bn_y"]
    loss, grads = bn.value_and_grad(mse)(xb, yb)
    out["bn_loss"], out["bn_grads"] = float(loss), grads
    out["bn_stats"] = {k: v.clone() for k, v in
                       bn.params[bn.stage].state_dict().items()
                       if k.endswith(("mean", "var"))}
    torch.save(out, os.path.join(io_dir, f"pipe_{pid}.pt"))


def main():
    mode, pid, nprocs, store, io_dir = sys.argv[1:6]
    pid, nprocs = int(pid), int(nprocs)
    torch.set_num_threads(1)
    from tf2_yolo_tpu_torch.parallel import (distributed_initialize,
                                             distributed_shutdown,
                                             process_count)
    distributed_initialize(num_processes=nprocs, process_id=pid,
                           device="cpu", store=store, timeout_s=60)
    try:
        assert process_count() == nprocs
        if mode == "stacks":
            run_stacks(pid, io_dir)
        elif mode == "fit":
            run_fit(pid, io_dir)
        elif mode == "tp":
            run_tp(pid, io_dir)
        elif mode == "pipe":
            run_pipe(pid, io_dir)
        elif mode == "space":
            run_space(pid, io_dir)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        distributed_shutdown()


if __name__ == "__main__":
    main()
