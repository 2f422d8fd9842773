"""Worker process for tests/test_torch_multiprocess.py.

One process of a 2-process data-parallel run of the PyTorch port on the
CPU: gloo, a FileStore rendezvous, this process's half of the rows. It
imports torch, numpy and the port only, never JAX: the parent test holds
what the workers write against the JAX package on the concatenated data.

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
"""

import gc
import hashlib
import json
import os
import shutil
import sys

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
    step = make_train_step(
        [lambda ct, out: (out * ct).sum() / out.shape[0]],
        group=default_group())
    result = {}
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
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        distributed_shutdown()


if __name__ == "__main__":
    main()
