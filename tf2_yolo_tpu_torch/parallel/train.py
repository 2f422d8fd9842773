"""Train and eval step factories and the optimizer chain.

Port of tf2_yolo_tpu/parallel/train.py. One step is the forward with
BatchNorm in batch mode, the multi-level loss, the backward pass, the
optimizer update and the metrics. JAX's state is immutable and its step
returns a new one; here the state owns the model and the optimizer, and a
step updates parameters, running statistics and optimizer moments in
place and returns the same state object.

The optimizer is optax's chain as the JAX ``make_optimizer`` builds it,
written out on tensors (``torch._foreach_*``) in optax's order of
operations: inner (adam, adamw, sgd or rmsprop, then the learning rate)
-> ema of the updates -> frozen mask -> MultiSteps -> learning-rate
multiplier. ``torch.optim``'s classes differ from optax's in rmsprop
(decay 0.99, eps outside the root), adamw (weight decay 1e-2) and where
their bias corrections round, so none is used.

Data parallelism (``make_train_step(group=...)``) is the explicit form of
what GSPMD derives for the JAX step over a global batch: statistics sums
and gradients reduced over the process group. Under tensor parallelism
the group is the mesh's data group (``parallel.mesh``): a sliced leaf
keeps its own slice's gradient and moments, and a whole one is computed
alike, bit for bit, in every process of its model group.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .collectives import all_reduce_

_INNER = ("adam", "adamw", "sgd", "rmsprop")
_B1, _B2 = 0.9, 0.999          # adam's decays, optax's defaults
_EPS = 1e-7                    # tf.keras's epsilon, as the JAX package
_MOMENTUM = 0.9                # optax.sgd(lr, momentum=0.9)
_RMS_DECAY = 0.9               # optax.rmsprop's default decay
_WEIGHT_DECAY = 1e-4           # optax.adamw's default


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer
    (moments, step count, learning-rate multiplier) and the number of
    steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _bias_correction(decay, count):
    """``1 - decay ** count`` as optax computes it: in f32 with the decay
    rounded to f32 first. Rounding b^t to f32 before the subtraction
    matters: near 1 the subtraction cancels, and 1 - 0.999^t from f64
    differs from optax's by up to 1e-5 relative. Returned as the Python
    float of that f32 value."""
    d = float(np.float32(decay))
    return float(np.float32(1.0) - np.float32(d ** count))


class OptimizerChain(torch.optim.Optimizer):
    """optax's ``make_optimizer`` chain over the parameters it is given
    (the frozen ones are left out: they take no update and have no
    moments). ``step()`` reads each parameter's ``.grad`` (zeros where
    it has none) and updates the parameters in place.

    The counters live in the first parameter group, so ``state_dict()``
    carries them with the moments: ``count`` (inner updates applied: the
    schedule's, adam's and the ema's step), ``mini_step`` (MultiSteps'
    position) and ``lr_multiplier``. No step reads a value back from the
    device."""

    def __init__(self, params, optimizer, learning_rate,
                 accumulate_steps=1, ema_decay=None):
        if optimizer not in _INNER:
            raise ValueError(f"Unknown optimizer: {optimizer}")
        super().__init__(params, {})
        self.kind = optimizer
        self.learning_rate = learning_rate
        self.accumulate_steps = int(accumulate_steps)
        self.ema_decay = ema_decay
        group = self.param_groups[0]
        group.update(count=0, mini_step=0, lr_multiplier=1.0)

    def _moments(self, params, *names):
        out = []
        for name in names:
            buf = []
            for p in params:
                st = self.state[p]
                if name not in st:
                    st[name] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                buf.append(st[name])
            out.append(buf)
        return out

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptimizerChain.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        k = self.accumulate_steps
        if k > 1:
            # optax.MultiSteps: a running mean of the mini-batch
            # gradients, acc + (g - acc) / (n + 1); the update is zero
            # until the k-th, and the inner state does not move
            (accs,) = self._moments(params, "acc")
            mini = group["mini_step"]
            torch._foreach_lerp_(accs, grads, 1.0 / (mini + 1))
            group["mini_step"] = (mini + 1) % k
            if mini != k - 1:
                return None
            grads = accs
        count = group["count"]
        u, den, scale = self._inner(params, grads, count)
        lr = self.learning_rate
        scale *= -float(lr(count) if callable(lr) else lr)
        mult = group["lr_multiplier"]
        if self.ema_decay is None:
            _add_scaled(params, u, den, scale * mult)
        else:
            # optax.ema(decay, debias=True) of the updates
            d = self.ema_decay
            (emas,) = self._moments(params, "ema")
            torch._foreach_mul_(emas, d)
            _add_scaled(emas, u, den, scale * (1 - d))
            torch._foreach_add_(
                params, emas, alpha=mult / _bias_correction(d, count + 1))
        if k > 1:
            torch._foreach_zero_(accs)
        group["count"] = count + 1
        return None

    def _inner(self, params, grads, count):
        """Advance the inner optimizer's moments. Its update before the
        learning rate is ``scale * u / den`` (``scale * u`` where ``den``
        is None), left unformed so that the caller adds it to the
        parameters in one pass."""
        kind = self.kind
        if kind in ("adam", "adamw"):
            mus, nus = self._moments(params, "mu", "nu")
            # optax's update_moment: (1 - b) g^k + b m
            torch._foreach_lerp_(mus, grads, 1 - _B1)
            torch._foreach_mul_(nus, _B2)
            torch._foreach_addcmul_(nus, grads, grads, 1 - _B2)
            # m/c1 / (sqrt(v/c2) + eps)
            #   = (sqrt(c2)/c1) m / (sqrt(v) + eps sqrt(c2))
            root_c2 = math.sqrt(_bias_correction(_B2, count + 1))
            den = torch._foreach_sqrt(nus)
            torch._foreach_add_(den, _EPS * root_c2)
            scale = root_c2 / _bias_correction(_B1, count + 1)
            if kind == "adam":
                return mus, den, scale
            # adamw: the decoupled weight decay joins before the lr
            u = torch._foreach_div(mus, den)
            torch._foreach_mul_(u, scale)
            torch._foreach_add_(u, params, alpha=_WEIGHT_DECAY)
            return u, None, 1.0
        if kind == "sgd":
            # optax.trace: t = g + momentum * t, no dampening
            (traces,) = self._moments(params, "trace")
            torch._foreach_mul_(traces, _MOMENTUM)
            torch._foreach_add_(traces, grads)
            return traces, None, 1.0
        # optax.scale_by_rms: g / sqrt(nu + eps), eps inside the root
        (nus,) = self._moments(params, "nu")
        torch._foreach_mul_(nus, _RMS_DECAY)
        torch._foreach_addcmul_(nus, grads, grads, 1 - _RMS_DECAY)
        den = torch._foreach_add(nus, _EPS)
        torch._foreach_sqrt_(den)
        return grads, den, 1.0


def _add_scaled(dst, u, den, alpha):
    """dst += alpha * u / den (alpha * u where ``den`` is None), in
    place."""
    if den is None:
        torch._foreach_add_(dst, u, alpha=alpha)
    else:
        torch._foreach_addcdiv_(dst, u, den, alpha)


def make_optimizer(optimizer="adam", learning_rate=1e-4, frozen=None,
                   accumulate_steps=1, ema_decay=None):
    """Return ``tx(model) -> OptimizerChain`` from a keras-style spec.

    Args:
        optimizer: "adam" | "adamw" | "sgd" | "rmsprop", as optax builds
            them in the JAX package: adam and adamw with eps 1e-7 outside
            the root and bias-corrected moments (adamw's decoupled weight
            decay 1e-4, added before the learning rate); sgd with
            momentum 0.9 (the trace first, no dampening, no Nesterov);
            rmsprop with decay 0.9 and eps 1e-7 inside the root.
        learning_rate: float, or a callable ``schedule(count) -> float``
            of the number of inner updates applied so far (optax's
            schedule count; under ``accumulate_steps`` it advances once
            every k steps).
        frozen: optional predicate (name, parameter) -> bool marking
            parameters that take no update (e.g. the v4 head anchors
            when they are not trainable). ``name`` is the dotted
            ``named_parameters`` name.
        accumulate_steps: > 1 averages that many gradients and applies
            them once every k steps (optax.MultiSteps).
        ema_decay: if set, the update is the debiased exponential moving
            average of the inner updates (optax.ema), not the weights.

    The learning-rate multiplier (initially 1) scales the final update;
    see :func:`set_lr_multiplier`.
    """
    if optimizer not in _INNER:
        raise ValueError(f"Unknown optimizer: {optimizer}")

    def tx(model):
        params = [p for name, p in model.named_parameters()
                  if frozen is None or not frozen(name, p)]
        return OptimizerChain(params, optimizer, learning_rate,
                              accumulate_steps, ema_decay)

    return tx


def get_lr_multiplier(optimizer):
    """Read the mutable learning-rate multiplier (1.0 for an optimizer
    built without one)."""
    return optimizer.param_groups[0].get("lr_multiplier", 1.0)


def set_lr_multiplier(optimizer, value):
    """Scale every later update by ``value`` without touching the
    optimizer's moments (keras ReduceLROnPlateau semantics). The
    multiplier lives in the optimizer's state_dict."""
    group = optimizer.param_groups[0]
    if "lr_multiplier" not in group:
        raise ValueError("optimizer was not built by make_optimizer")
    group["lr_multiplier"] = float(value)
    return optimizer


def create_train_state(model, tx, device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU) and build its optimizer with ``tx`` from
    :func:`make_optimizer`."""
    model = model.to(device)
    return TrainState(model=model, optimizer=tx(model), step=0)


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _cast_input(x, input_rescale):
    """uint8 batches normalize on the device (x * rescale in f32), so
    the host ships 1 byte a pixel; float inputs pass through."""
    if x.dtype == torch.uint8:
        return x.float() * input_rescale
    return x


def _forward(model, loss_fns, metric_fns, metric_names, x, ys,
             input_rescale):
    """Total loss and the logs of one batch: ``loss`` and each metric
    as 0-d tensors on the model's device."""
    device = next(model.parameters()).device
    x = _cast_input(x.to(device), input_rescale)
    outs = _as_tuple(model(x))
    ys = tuple(y.to(device) for y in _as_tuple(ys))
    total = 0.0
    for lf, y_i, o_i in zip(loss_fns, ys, outs):
        total = total + lf(y_i, o_i)
    logs = {}
    if metric_fns is not None:
        with torch.no_grad():
            for fns, names, y_i, o_i in zip(metric_fns, metric_names, ys,
                                            outs):
                for fn, name in zip(fns, names):
                    logs[name] = fn(y_i, o_i.detach())
    return total, logs


_BUCKET = 1 << 23              # elements of one gradient all-reduce


def _buckets(grads):
    """Consecutive runs of ``grads`` of one dtype and at most _BUCKET
    elements (or one larger tensor)."""
    run, size = [], 0
    for g in grads:
        if run and (g.dtype != run[0].dtype or size + g.numel() > _BUCKET):
            yield run
            run, size = [], 0
        run.append(g)
        size += g.numel()
    if run:
        yield run


def _reduce_grads(state, group):
    """Average the gradients of the optimizer's parameters over the
    processes of ``group``, in place (:func:`average_grads`)."""
    own = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    average_grads([p for _, p in sorted(state.model.named_parameters(),
                                        key=lambda kv: kv[0])
                   if id(p) in own], group)


def average_grads(params, group):
    """Average the ``.grad`` of ``params`` over the processes of
    ``group``, in place, in the order given: the same list on every
    process, whatever gradients this process has (a parameter without
    one adds zeros, so that no process waits on a reduce that another
    skips). One all-reduce a bucket of concatenated gradients
    (:data:`_BUCKET` elements)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    world = dist.get_world_size(group)
    for grads in _buckets([p.grad for p in params]):
        flat = all_reduce_(_flatten_dense_tensors(grads), group)
        flat.div_(world)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


@torch.no_grad()
def broadcast_tensors(tensors, group, src=0):
    """Overwrite ``tensors`` in place with process ``src``'s, one
    broadcast a bucket of concatenated tensors (:data:`_BUCKET`
    elements)."""
    for run in _buckets(list(tensors)):
        flat = _flatten_dense_tensors(run)
        dist.broadcast(flat, src=src, group=group)
        for t, r in zip(run, _unflatten_dense_tensors(flat, run)):
            t.copy_(r)


def _mean_logs(logs, group):
    """``{name: 0-d tensor}`` averaged over the processes of ``group``
    (one all-reduce)."""
    keys = list(logs)
    vals = all_reduce_(torch.stack([logs[k].detach().float()
                                    for k in keys]), group)
    vals = vals / dist.get_world_size(group)
    return dict(zip(keys, vals.unbind()))


def make_train_step(loss_fns, metric_fns=None, metric_names=None,
                    input_rescale=1 / 255, group=None):
    """Build ``train_step(state, x, y_tuple) -> (state, logs)``.

    loss_fns: one loss per model output (summed).
    metric_fns/metric_names: per-output lists of metric closures and
        their log names, computed on the step's outputs.
    input_rescale: on-device normalization factor for uint8 image
        batches (see ``_cast_input``).
    group: a ``torch.distributed`` process group for the data-parallel
        step: every process passes its own rows, the model's BatchNorm
        statistics are taken over the group (``layers.set_bn_group``,
        whose backward sums their cotangents over it), and after the
        backward the gradients are averaged over the group before the
        update. The losses are means over each process's batch, so with
        equal batches this is the gradient of the global batch's mean
        loss: the step of one process on the concatenated batch (the
        JAX package's one GSPMD program). The logs are averaged over the
        group too.
    ``logs`` holds ``loss`` and each metric as 0-d tensors on the
    model's device (reading one waits for the step).
    """
    loss_fns = list(loss_fns)

    def train_step(state, x, ys):
        state.model.train()
        state.model.zero_grad(set_to_none=True)
        loss, metrics = _forward(state.model, loss_fns, metric_fns,
                                 metric_names, x, ys, input_rescale)
        loss.backward()
        logs = {"loss": loss.detach(), **metrics}
        if group is not None:
            _reduce_grads(state, group)
            logs = _mean_logs(logs, group)
        state.optimizer.step()
        state.step += 1
        return state, logs

    return train_step


def make_eval_step(loss_fns, metric_fns=None, metric_names=None,
                   input_rescale=1 / 255):
    """Build ``eval_step(state, x, y_tuple) -> logs`` (eval-mode BN)."""
    loss_fns = list(loss_fns)

    @torch.no_grad()
    def eval_step(state, x, ys):
        state.model.eval()
        loss, metrics = _forward(state.model, loss_fns, metric_fns,
                                 metric_names, x, ys, input_rescale)
        return {"loss": loss, **metrics}

    return eval_step
