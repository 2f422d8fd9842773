"""Pipeline parallelism: microbatches streamed through stages on devices.

Port of tf2_yolo_tpu/parallel/pipeline.py. A stage is a callable
``stage(module, x) -> y`` with its own ``nn.Module`` (its parameters and
BatchNorm statistics), placed on its own device; activations move from
stage to stage with ``.to(device)``. The stages run one after another on
the host's one thread (one CUDA stream per stage is a later matter), and
a device may repeat: several stages can share one card.

Backward is exact: the forward keeps only each stage's INPUT per
microbatch, and the backward runs the stage again with autograd on and
hands its input's cotangent to the stage before (GPipe's
rematerialization). Gradients accumulate over the microbatches as their
mean (gradient accumulation), so a pipeline step equals the same batch's
single-program step up to float rounding.

Both BatchNorm modes:

- frozen statistics (``train=False``, the default without
  ``train_stages``): the stages run in eval mode, the running statistics
  normalise and are constants of the backward (the fine-tuning
  contract);
- train-mode BN (``train_stages`` from ``split_detector(...,
  with_train=True)``): each microbatch normalises with its own batch
  statistics, differentiated exactly, and updates the running statistics
  in place after each microbatch, as a single-program train step does.
  The backward's recompute takes the same batch statistics and leaves
  the running statistics as the forward left them. With ``microbatch ==
  batch`` a pipeline step is the single train step; with smaller
  microbatches it is the train steps of the microbatches in turn with
  their gradients accumulated (GPipe's BN semantics).

PP x DP (``meshes=``, one ``parallel.mesh.Mesh`` per stage over disjoint
processes of the process group): each process runs the stage whose mesh
holds it, on its share of each microbatch's rows (the data index's
``microbatch / data size`` rows), and the activations and cotangents
move between the processes of the same data index in consecutive stages
(``torch.distributed`` send / recv: of host copies under gloo, whose
send takes no CUDA tensor, and of the card's tensors under nccl). A
stage's gradients are averaged over its mesh's data group, and its
train-mode BatchNorm takes its statistics over that group
(``layers.set_bn_group``), so a step equals the single program's on
the whole batch, as a data-parallel step does.
"""

import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import (tree_flatten, tree_map, tree_unflatten,
                                 treespec_dumps, treespec_loads)

from .multihost import (barrier, host_device, process_device,
                        process_index)
from .train import average_grads, broadcast_tensors


class PipelineExecutor:
    """Run ``stages`` (a list of ``stage(module, x) -> y`` callables, each
    with its module in ``params``) as a chain over ``devices``.

    ``devices``: one per stage (default the first ``len(stages)`` cards);
    one device may repeat. Each stage's module is moved to its device at
    construction; :func:`split_detector` and :func:`split_yolov4` give
    modules that are VIEWS of one model's submodules (the same tensors,
    so placing a stage moves that part of the model), not copies.

    ``meshes``: instead, one ``parallel.mesh.Mesh`` per stage over
    disjoint processes, each of model axis 1 and all of one data size
    (PP x DP, see the module docstring): every process calls every
    method with the whole batch; ``run`` and the loss come back whole on
    every process, the gradients, ``init_opt``'s chains and
    ``apply_grads`` are this process's stage's (None for the others).
    Each microbatch must divide by the data size.

    Forward:  ``run(x, microbatch)`` -> the last stage's outputs, rows
              aligned with ``x``.
    Training: ``value_and_grad(loss_fn)(x, *aux, microbatch=)`` ->
              ``(mean loss, [grads per stage])``, each ``{name: tensor}``
              over the stage module's parameters, the mean over the
              microbatches; :meth:`init_opt` and :meth:`apply_grads`
              update the stages with the port's optimizer chain.
    """

    def __init__(self, stages: Sequence[Callable],
                 params: Sequence[nn.Module],
                 devices: Optional[Sequence] = None,
                 meshes: Optional[Sequence] = None,
                 train_stages: Optional[Sequence[Callable]] = None):
        if len(stages) != len(params):
            raise ValueError(
                f"{len(stages)} stages but {len(params)} params trees")
        if train_stages is not None and len(train_stages) != len(stages):
            raise ValueError(
                f"{len(stages)} stages but {len(train_stages)} "
                f"train_stages")
        self.stages = list(stages)
        self.train_stages = (list(train_stages)
                             if train_stages is not None else None)
        self.meshes = None
        if meshes is not None:
            self._init_meshes(params, list(meshes))
            return
        if devices is None:
            devices = [f"cuda:{i}"
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if len(devices) < len(stages):
            raise ValueError(
                f"{len(stages)} stages need {len(stages)} devices, "
                f"got {len(devices)} (a device may repeat)")
        self.devices = devices[:len(stages)]
        self.params = [m.to(d) for m, d in zip(params, self.devices)]

    def _init_meshes(self, params, meshes):
        """PP x DP: this process's stage, its mesh, its peers in the
        stages before and after, its stage module on its device (the
        device of ``distributed_initialize``, else the card) with the
        BatchNorm statistics over the mesh's data group."""
        from ..models.layers import set_bn_group
        n = len(self.stages)
        if len(meshes) < n:
            raise ValueError(f"{n} stages need {n} meshes, got "
                             f"{len(meshes)}")
        meshes = meshes[:n]
        if any(m.shape["model"] != 1 for m in meshes):
            raise ValueError("a stage mesh's model axis must be 1 (PP x DP)")
        if len({m.shape["data"] for m in meshes}) != 1:
            raise ValueError("every stage mesh needs the same data size, "
                             f"got {[m.shape['data'] for m in meshes]}")
        ranks = [r for m in meshes for r in m.ranks]
        if len(set(ranks)) != len(ranks):
            raise ValueError("the stage meshes must be disjoint")
        me = process_index()
        owner = [s for s, m in enumerate(meshes) if me in m]
        if not owner:
            raise ValueError(f"process {me} is in no stage mesh")
        s = self.stage = owner[0]
        self.meshes, self.mesh = meshes, meshes[s]
        pos = self.mesh.ranks.index(me)
        self._prev = meshes[s - 1].ranks[pos] if s > 0 else None
        self._next = meshes[s + 1].ranks[pos] if s + 1 < n else None
        device = process_device() or torch.device("cuda")
        self.devices = [device] * n
        self.params = list(params)
        self.params[s] = params[s].to(device)
        set_bn_group(self.params[s], self.mesh.data_group)

    # -- forward ------------------------------------------------------
    @torch.no_grad()
    def run(self, x, microbatch: Optional[int] = None):
        """Eval-mode forward; returns the last stage's outputs
        concatenated over microbatches (same structure as one). Under
        ``meshes``: every process passes the whole ``x`` and gets the
        whole output, on its device (collective)."""
        if self.meshes is not None:
            return self._run_meshes(x, microbatch)
        outs = []
        for mb in self._split(x, microbatch):
            y = mb
            for s, stage in enumerate(self.stages):
                y = stage(self.params[s], self._put(y, s))
            outs.append(y)
        return self._cat(outs)

    # -- training -----------------------------------------------------
    def value_and_grad(self, loss_fn: Callable,
                       train: Optional[bool] = None):
        """``loss_fn(final stage output, *aux) -> scalar`` per
        microbatch. Returns ``step(x, *aux, microbatch=None) -> (loss,
        grads)``: ``loss`` the mean of the microbatches' losses, ``grads``
        per stage ``{name: tensor}`` over the stage module's parameters,
        averaged over the microbatches (also left in each parameter's
        ``.grad``). ``aux`` (e.g. labels) is split over microbatches like
        ``x`` and moved to the last stage's device.

        ``train`` (default: whether ``train_stages`` were given): False
        runs the frozen-statistics forward (the stages in eval mode);
        True runs train-mode BatchNorm, updating the running statistics
        in the stage modules after each microbatch."""
        use_train = (self.train_stages is not None) if train is None \
            else train
        if use_train and self.train_stages is None:
            raise ValueError(
                "train=True requires train_stages (split with "
                "with_train=True)")
        fns = self.train_stages if use_train else self.stages
        n_stages = len(fns)
        if self.meshes is not None:
            return self._step_meshes(fns, loss_fn, use_train)

        def step(x, *aux, microbatch: Optional[int] = None):
            mbs = self._split(x, microbatch)
            aux_mbs = [self._split(a, microbatch) for a in aux]
            n = len(mbs)
            for m in self.params:
                m.zero_grad(set_to_none=True)
            # fill: every microbatch through the stages without autograd,
            # keeping each stage's input; the loss and its cotangent (the
            # mean over microbatches: seeded with 1 / n) on the last
            # stage's device
            xs = [[None] * n for _ in range(n_stages)]
            losses, dys = [], []
            for i, mb in enumerate(mbs):
                y = mb
                with torch.no_grad():
                    for s in range(n_stages):
                        y = xs[s][i] = self._put(y, s)
                        y = fns[s](self.params[s], y)
                am = tuple(self._put(a[i], n_stages - 1) for a in aux_mbs)
                leaves, spec = tree_flatten(y)
                leaves = [t.detach().requires_grad_() for t in leaves]
                with torch.enable_grad():
                    loss = loss_fn(tree_unflatten(leaves, spec), *am)
                    dy = torch.autograd.grad(loss / n, leaves,
                                             allow_unused=True)
                losses.append(loss.detach())
                dys.append([torch.zeros_like(t) if g is None else g
                            for t, g in zip(leaves, dy)])
            # drain: cotangents backward, newest microbatch first; each
            # stage runs again with autograd on (train mode: the same
            # batch statistics, and the running statistics put back as
            # the fill left them), and adds its parameters' gradients
            for i in reversed(range(n)):
                dy = dys[i]
                for s in reversed(range(n_stages)):
                    dy = [self._put(g, s) for g in dy]
                    dy = self._backward(fns[s], s, xs[s][i], dy, use_train)
                    xs[s][i] = None          # free the stored input
            loss = sum(l.to(losses[0].device) for l in losses) / n
            return loss, [
                {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in m.named_parameters()} for m in self.params]

        return step

    def _backward(self, fn, s, x, dy, train):
        """Run stage ``s`` again on its stored input with autograd on,
        backpropagate ``dy`` (the output leaves' cotangents) into its
        parameters' ``.grad``; return its input leaves' cotangents (none
        for the first stage, whose input is the batch)."""
        module = self.params[s]
        leaves, spec = tree_flatten(x)
        leaves = [t.detach().requires_grad_(s > 0) for t in leaves]
        saved = ({k: v.clone() for k, v in module.named_buffers()}
                 if train else None)
        with torch.enable_grad():
            y_leaves = tree_flatten(fn(module, tree_unflatten(leaves,
                                                              spec)))[0]
            pairs = [(y, g) for y, g in zip(y_leaves, dy)
                     if y.requires_grad]
            torch.autograd.backward([y for y, _ in pairs],
                                    [g for _, g in pairs])
        if saved is not None:
            with torch.no_grad():
                for k, v in module.named_buffers():
                    v.copy_(saved[k])
        if s == 0:
            return []
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for t in leaves]

    def init_opt(self, tx):
        """One optimizer chain per stage over its module's parameters
        (``tx`` from ``parallel.train.make_optimizer``; its ``frozen``
        predicate sees the model's parameter names); under ``meshes``
        only this process's stage has one (None for the others)."""
        return [tx(m) if self._runs(s) else None
                for s, m in enumerate(self.params)]

    def apply_grads(self, tx, opt_states, grads):
        """Update each stage's parameters in place with its optimizer
        chain from ``grads`` (as :meth:`value_and_grad` returns them);
        BatchNorm statistics pass through. Returns ``opt_states``."""
        del tx                            # the chains carry it
        for m, opt, g in zip(self.params, opt_states, grads):
            if opt is None:
                continue
            for k, p in m.named_parameters():
                p.grad = g[k]
            opt.step()
        return opt_states

    # -- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        """``torch.save`` of every stage's ``state_dict`` (CPU tensors),
        the pipeline's counterpart of ``Model.save_weights``; under
        ``meshes`` every process first takes each stage from its mesh's
        first process, process 0 writes and all wait for it
        (collective)."""
        self._sync_stages()
        if self.meshes is None or process_index() == 0:
            torch.save({str(i): {k: v.detach().cpu()
                                 for k, v in m.state_dict().items()}
                        for i, m in enumerate(self.params)}, path)
        if self.meshes is not None:
            barrier()

    def load(self, path: str) -> None:
        """Load a :meth:`save` file into the stage modules, on their
        devices."""
        tree = torch.load(path, map_location="cpu", weights_only=True)
        for i, m in enumerate(self.params):
            m.load_state_dict(tree[str(i)])

    def merged_variables(self):
        """One ``state_dict`` (CPU tensors) of every stage's variables,
        the inverse of :func:`split_detector` / :func:`split_yolov4`: the
        whole model's ``load_state_dict`` takes it, so a pipeline-trained
        model goes on to the single-program paths. Collective under
        ``meshes`` (each stage from its mesh's first process)."""
        self._sync_stages()
        merged = {}
        for m in self.params:
            merged.update({k: v.detach().cpu()
                           for k, v in m.state_dict().items()})
        return merged

    # -- PP x DP ------------------------------------------------------
    def _runs(self, s):
        """Whether this process runs stage ``s``."""
        return self.meshes is None or s == self.stage

    def _sync_stages(self):
        """Under ``meshes``: every stage's tensors in every process from
        the first process of the stage's mesh (every process holds
        views of one whole model)."""
        if self.meshes is None:
            return
        for m, mesh in zip(self.params, self.meshes):
            broadcast_tensors(list(m.state_dict().values()),
                              dist.group.WORLD, src=mesh.ranks[0])

    def _rows(self, tree):
        """This process's rows of a microbatch (its data index's)."""
        d = self.mesh.shape["data"]
        leaves, spec = tree_flatten(tree)
        total = leaves[0].shape[0]
        if total % d:
            raise ValueError(f"microbatch {total} must divide by the "
                             f"stage meshes' data size {d}")
        r, i = total // d, self.mesh.data_index
        return tree_unflatten([t[i * r:(i + 1) * r] for t in leaves], spec)

    def _send(self, tree, dst):
        """``tree`` to process ``dst``: its structure, shapes and dtypes,
        then each leaf."""
        leaves, spec = tree_flatten(tree)
        _send_bytes(_meta(spec, leaves), dst)
        dev = host_device()
        for t in leaves:
            dist.send(t.detach().to(dev).contiguous(), dst)

    def _recv(self, src):
        """A tree of :meth:`_send` from process ``src``, on this
        process's device."""
        spec, metas = _unmeta(_recv_bytes(src))
        dev = host_device()
        leaves = []
        for shape, dtype in metas:
            t = torch.empty(shape, dtype=dtype, device=dev)
            dist.recv(t, src)
            leaves.append(t.to(self.devices[self.stage]))
        return tree_unflatten(leaves, spec)

    def _mb_split(self, x, microbatch):
        mbs = self._split(x, microbatch)
        self._rows(mbs[0])                 # the division check
        return mbs

    def _run_meshes(self, x, microbatch):
        s, last = self.stage, len(self.stages) - 1
        mbs = self._mb_split(x, microbatch)
        outs = []
        for mb in mbs:
            y = (self._recv(self._prev) if s > 0
                 else self._put(self._rows(mb), s))
            y = self.stages[s](self.params[s], y)
            if s < last:
                self._send(y, self._next)
            else:
                outs.append(y)
        return self._gather_rows(self._cat(outs) if s == last else None,
                                 len(mbs))

    def _gather_rows(self, local, n_mb):
        """The last stage's rows of every microbatch (``local``, on its
        processes; None on the others) as the whole output on every
        process, rows aligned with ``x``: the structure from the last
        stage's first process, then each leaf summed over every process
        into zeros (exact: each row has one writer)."""
        src = self.meshes[-1].ranks[0]
        if process_index() == src:
            leaves, spec = tree_flatten(local)
            _bcast_bytes(_meta(spec, leaves), src)
        else:
            spec, metas = _unmeta(_bcast_bytes(None, src))
        if local is not None:
            leaves = tree_flatten(local)[0]
            metas = [(tuple(t.shape), t.dtype) for t in leaves]
        d = self.mesh.shape["data"]
        dev = host_device()
        out = []
        for k, (shape, dtype) in enumerate(metas):
            per = shape[0] // n_mb              # this rank's rows a mb
            full = torch.zeros((shape[0] * d, *shape[1:]), dtype=dtype,
                               device=dev)
            if local is not None:
                i = self.mesh.data_index
                view = full.view(n_mb, d, per, *shape[1:])
                view[:, i] = leaves[k].to(dev).view(n_mb, per, *shape[1:])
            dist.all_reduce(full)
            out.append(full.to(self.devices[self.stage]))
        return tree_unflatten(out, spec)

    def _step_meshes(self, fns, loss_fn, use_train):
        s, last = self.stage, len(self.stages) - 1
        module = self.params[s]

        def step(x, *aux, microbatch: Optional[int] = None):
            mbs = self._mb_split(x, microbatch)
            aux_mbs = [self._split(a, microbatch) for a in aux]
            n = len(mbs)
            module.zero_grad(set_to_none=True)
            xs, dys, total = [None] * n, [None] * n, 0.0
            # fill: this stage's forward of each microbatch's rows,
            # keeping its input; the last stage seeds the cotangents
            for i, mb in enumerate(mbs):
                y = (self._recv(self._prev) if s > 0
                     else self._put(self._rows(mb), s))
                xs[i] = y
                with torch.no_grad():
                    y = fns[s](module, y)
                if s < last:
                    self._send(y, self._next)
                    continue
                am = tuple(self._put(self._rows(a[i]), s) for a in aux_mbs)
                leaves, spec = tree_flatten(y)
                leaves = [t.detach().requires_grad_() for t in leaves]
                with torch.enable_grad():
                    loss = loss_fn(tree_unflatten(leaves, spec), *am)
                    dy = torch.autograd.grad(loss / n, leaves,
                                             allow_unused=True)
                total = total + loss.detach().float() / n
                dys[i] = [torch.zeros_like(t) if g is None else g
                          for t, g in zip(leaves, dy)]
            # drain, newest microbatch first
            for i in reversed(range(n)):
                dy = (self._recv(self._next) if s < last else dys[i])
                dy = tree_flatten(dy)[0]
                dx = self._backward(fns[s], s, xs[i], dy, use_train)
                xs[i] = None
                if s > 0:
                    self._send(dx, self._prev)
            if self.mesh.data_group is not None:
                average_grads([p for _, p in sorted(
                    module.named_parameters(), key=lambda kv: kv[0])],
                    self.mesh.data_group)
            # the mean loss, from the last stage's processes to all
            d = self.mesh.shape["data"]
            mean = torch.zeros(1, device=host_device())
            if s == last:
                mean += total.to(mean.device) / d
            dist.all_reduce(mean)
            grads = [None] * len(self.stages)
            grads[s] = {k: (p.grad if p.grad is not None
                            else torch.zeros_like(p))
                        for k, p in module.named_parameters()}
            return mean[0].to(self.devices[s]), grads

        return step

    # -- helpers ------------------------------------------------------
    def _put(self, tree, s):
        """A pytree of tensors on stage ``s``'s device."""
        dev = self.devices[s]
        return tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t,
                        tree)

    @staticmethod
    def _cat(outs):
        leaves = [tree_flatten(o)[0] for o in outs]
        spec = tree_flatten(outs[0])[1]
        return tree_unflatten([torch.cat(ls, dim=0)
                               for ls in zip(*leaves)], spec)

    @staticmethod
    def _split(x, microbatch):
        leaves, spec = tree_flatten(x)
        total = leaves[0].shape[0]
        mb = microbatch or total
        if total % mb:
            raise ValueError(f"batch {total} not divisible by "
                             f"microbatch {mb}")
        return [tree_unflatten([t[i * mb:(i + 1) * mb] for t in leaves],
                               spec) for i in range(total // mb)]


def _meta(spec, leaves):
    """A tree's structure, leaf shapes and dtypes as bytes."""
    return json.dumps([treespec_dumps(spec),
                       [[list(t.shape), str(t.dtype).split(".")[-1]]
                        for t in leaves]]).encode()


def _unmeta(data):
    spec, metas = json.loads(data.decode())
    return treespec_loads(spec), [(tuple(shape), getattr(torch, dtype))
                                  for shape, dtype in metas]


def _send_bytes(data, dst):
    dev = host_device()
    dist.send(torch.tensor([len(data)], dtype=torch.int64, device=dev), dst)
    dist.send(torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev),
              dst)


def _recv_bytes(src):
    dev = host_device()
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.recv(n, src)
    buf = torch.empty(int(n[0]), dtype=torch.uint8, device=dev)
    dist.recv(buf, src)
    return buf.cpu().numpy().tobytes()


def _bcast_bytes(data, src):
    """``data`` (bytes, on process ``src``) on every process."""
    dev = host_device()
    n = torch.tensor([0 if data is None else len(data)], dtype=torch.int64,
                     device=dev)
    dist.broadcast(n, src)
    buf = (torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
           if data is not None else
           torch.empty(int(n[0]), dtype=torch.uint8, device=dev))
    dist.broadcast(buf, src)
    return buf.cpu().numpy().tobytes()


class _View(nn.Module):
    """A module that holds some of another module's submodules under
    their own dotted names, without copying them: its ``state_dict``
    keys are the model's."""

    def __init__(self, parts):
        super().__init__()
        for name, sub in parts.items():
            view = self
            *heads, last = name.split(".")
            for head in heads:
                if head not in view._modules:
                    view.add_module(head, _View({}))
                view = view._modules[head]
            view.add_module(last, sub)


def _stage_fn(model, stage_name, train=False):
    """``fn(view, x)``: the model's forward cut at ``stage_name``, in
    train or eval mode (the view holds the submodules it runs)."""
    def fn(view, x):
        del view                  # its submodules are the model's own
        model.train(train)
        return model(x, pipeline_stage=stage_name)
    return fn


def _children(model, names):
    return _View({n: model.get_submodule(n) for n in names})


def split_detector(model, with_train: bool = False):
    """Stage-split any detector (YoloV1/V2/V3/V4 of ``models``) for a
    2-stage pipeline: stage 0 = the backbone (-> its taps), stage 1 = the
    neck and the head(s). Returns ``(stages, params)`` for
    :class:`PipelineExecutor`, ``params`` two views of ``model``'s
    submodules (not copies: the model trains with them); with
    ``with_train=True`` ``(stages, params, train_stages)``, whose stages
    run train-mode BatchNorm. The default ``stages`` use the running
    statistics (eval mode)."""
    names = [n for n, _ in model.named_children()]
    if "backbone" not in names:
        raise ValueError("split_detector needs a 'backbone' param "
                         "scope in the variable tree")
    params = [_children(model, ["backbone"]),
              _children(model, [n for n in names if n != "backbone"])]
    cuts = ["backbone", "neck"]
    stages = [_stage_fn(model, c) for c in cuts]
    if with_train:
        return stages, params, [_stage_fn(model, c, True) for c in cuts]
    return stages, params


_EARLY = ("stem", "stage1", "stage2", "stage3")
_LATE = ("stage4", "stage5")


def split_yolov4(model, n_stages: int = 2, with_train: bool = False):
    """Stage-split a YoloV4 for pipelining.

    ``n_stages=2``: the backbone | the SPP/FPN/PAN neck and the heads
    (:func:`split_detector`). ``n_stages=3`` also cuts the stock
    CSPDarknet-53 after stage 3: stem + stages 1-3 | stages 4-5 | neck +
    heads (``backbone_early`` / ``backbone_late``), the boundaries
    carrying c3, then (c3, c4, c5). Returns ``(stages, params)``
    (``(stages, params, train_stages)`` with ``with_train=True``), the
    params views of ``model``'s submodules as in :func:`split_detector`;
    the train-mode stages of a ``packed`` model take its fused routes."""
    if n_stages == 2:
        return split_detector(model, with_train=with_train)
    if n_stages != 3:
        raise ValueError(f"n_stages must be 2 or 3, got {n_stages}")
    names = [n for n, _ in model.named_children()]
    if "backbone" not in names:
        raise ValueError("split_yolov4 needs a 'backbone' param scope")
    body = [n for n, _ in model.backbone.named_children()]
    unknown = set(body) - set(_EARLY) - set(_LATE)
    if unknown:
        raise ValueError(
            "3-stage split requires the stock csp_darknet backbone "
            f"(unexpected backbone scopes: {sorted(unknown)})")
    params = [_children(model, [f"backbone.{n}" for n in _EARLY]),
              _children(model, [f"backbone.{n}" for n in _LATE]),
              _children(model, [n for n in names if n != "backbone"])]
    cuts = ["backbone_early", "backbone_late", "neck"]
    stages = [_stage_fn(model, c) for c in cuts]
    if with_train:
        return stages, params, [_stage_fn(model, c, True) for c in cuts]
    return stages, params
