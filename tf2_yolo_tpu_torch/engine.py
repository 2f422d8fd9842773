"""Keras-like Model engine over the port's train and eval steps.

Port of tf2_yolo_tpu/engine.py: ``model.compile(...)`` + ``model.fit(...)``
over a ``torch.nn.Module`` (forward + loss + backward + optimizer chain +
metrics a step, :mod:`tf2_yolo_tpu_torch.parallel.train`), on the card
unless the caller asks for the CPU. Weights save/load is ``torch.save`` of
the module's ``state_dict`` (the JAX engine's are flax msgpack files);
full training-state checkpoints (parameters + optimizer chain + step +
fit position) live in :mod:`tf2_yolo_tpu_torch.parallel.checkpoint`.

A step's logs stay tensors on the device: ``fit`` reads them to the host
once an epoch (and ``evaluate`` once a call), unless a batch-end callback
reads them, so the host queues the next steps while the card runs.

Multi-process data parallelism: after
``parallel.distributed_initialize`` in every process, ``compile`` takes
the process group (BatchNorm statistics over it, gradients averaged over
it, :func:`~tf2_yolo_tpu_torch.parallel.train.make_train_step`) and
every process calls ``fit`` / ``evaluate`` with its own shard and the
per-process ``batch_size``. Tensor parallelism (``compile(n_model=k)``):
the processes form a ``(world / k, k)`` grid (``parallel.mesh``), the
wide ConvBNs and head convs are sliced over its model axis
(``models.layers.set_tensor_parallel``), and the statistics, gradients and
logs are reduced over its data axis; the processes of one model group
pass the same rows (``parallel.process_batch_slice(n, model.mesh)``).
(XLA options are not ported; ``compile`` raises for them.)
"""

import itertools
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from .data.pipeline import prefetch_to_device, threaded_prefetch, to_device
from .models.layers import (set_bn_group, set_bn_stats_sg,
                            set_tensor_parallel)
from .parallel.collectives import (gather_state_dict, sharded_dims,
                                   slice_state_dict)
from .parallel.mesh import make_mesh, tensor_parallel_shardings
from .parallel.multihost import default_group, host_device, process_count
from .parallel.train import (TrainState, _cast_input, broadcast_tensors,
                             get_lr_multiplier, make_eval_step,
                             make_optimizer, make_train_step,
                             set_lr_multiplier)


def _metric_name(fn, prefix=""):
    name = getattr(fn, "__name__", "metric")
    return f"{prefix}{name}"


def _resolve_mode(mode, monitor):
    """'min'/'max', or 'auto': maximize for accuracy-like monitors
    (acc/recall/iou/map/precision/f1 in the name), minimize otherwise —
    tf.keras's inference rule."""
    if mode in ("min", "max"):
        return mode
    if mode != "auto":
        raise ValueError(f"mode must be 'min'/'max'/'auto', got {mode!r}")
    name = monitor.lower()
    if any(t in name for t in ("acc", "recall", "iou", "map",
                               "precision", "f1", "auc")):
        return "max"
    return "min"


class EarlyStopping:
    """Stop training when a monitored quantity stops improving
    (tf.keras-style; pass via ``Model.fit(callbacks=[...])``).

    Args:
        monitor: history key to watch ("loss", "val_loss",
            "val_out1_recall", ...).
        patience: epochs without improvement before stopping.
        min_delta: minimum change counting as improvement.
        mode: "min", "max", or "auto" (inferred from the monitor name,
            e.g. recall/iou/acc monitors maximize).
    """

    def __init__(self, monitor="loss", patience=3, min_delta=0.0,
                 mode="auto"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.mode = _resolve_mode(mode, monitor)
        self.best = float("inf") if self.mode == "min" else float("-inf")
        self.wait = 0

    def _improved(self, value):
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs, model):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                model.stop_training = True


class ModelCheckpoint:
    """Save weights each epoch, optionally only on improvement
    (tf.keras ModelCheckpoint's save_best_only semantics; weights go
    through ``Model.save_weights`` — ``torch.save``).

    Args:
        path: weights file path (may contain ``{epoch}``).
        monitor: history key to watch.
        save_best_only: if True, save only when ``monitor`` improves.
        mode: "min", "max", or "auto" (see EarlyStopping).
    """

    def __init__(self, path, monitor="loss", save_best_only=True,
                 mode="auto"):
        self.path = str(path)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.mode = _resolve_mode(mode, monitor)
        self.best = float("inf") if self.mode == "min" else float("-inf")

    def on_epoch_end(self, epoch, logs, model):
        if self.save_best_only:
            value = logs.get(self.monitor)
            better = (value is not None
                      and (value < self.best if self.mode == "min"
                           else value > self.best))
            if not better:
                return
            self.best = value
        model.save_weights(self.path.format(epoch=epoch + 1))


class ReduceLROnPlateau:
    """Shrink the learning rate when a monitored quantity plateaus
    (tf.keras ReduceLROnPlateau semantics). Works by scaling the
    optimizer's mutable LR multiplier (``Model.lr_multiplier``) —
    optimizer moments preserved.

    Args:
        monitor: history key to watch.
        factor: multiplier applied on plateau (< 1).
        patience: epochs without improvement before reducing.
        min_delta: minimum change counting as improvement.
        mode: "min", "max", or "auto" (see EarlyStopping).
        min_mult: floor for the cumulative multiplier.
        cooldown: epochs to wait after a reduction before counting
            non-improvements again.
    """

    def __init__(self, monitor="loss", factor=0.5, patience=3,
                 min_delta=0.0, mode="auto", min_mult=1e-4,
                 cooldown=0, verbose=0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.mode = _resolve_mode(mode, monitor)
        self.min_mult = min_mult
        self.cooldown = cooldown
        self.verbose = verbose
        self.best = float("inf") if self.mode == "min" else float("-inf")
        self.wait = 0
        self.cooldown_left = 0

    def _improved(self, value):
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs, model):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.wait = 0
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        if self.cooldown_left > 0:
            return
        self.wait += 1
        if self.wait >= self.patience:
            old = model.lr_multiplier
            new = max(old * self.factor, self.min_mult)
            if new < old:
                model.lr_multiplier = new
                if self.verbose:
                    print(f"Epoch {epoch + 1}: ReduceLROnPlateau "
                          f"lr multiplier {old:.2e} -> {new:.2e}")
            self.wait = 0
            self.cooldown_left = self.cooldown


class TerminateOnNaN:
    """Stop training when the loss goes NaN/Inf (tf.keras
    TerminateOnNaN). By default checks the epoch-mean loss (free — the
    engine reads it anyway); ``on_batch=True`` checks every train
    batch like keras does, at the cost of one wait for the card a step
    (the host can no longer queue steps ahead — only use while
    debugging)."""

    def __init__(self, on_batch=False):
        self.on_batch = on_batch

    def _fail(self, where, model):
        print(f"TerminateOnNaN: non-finite loss at {where}; "
              f"stopping training")
        model.stop_training = True

    def on_train_batch_end(self, batch, logs, model):
        if self.on_batch and not np.isfinite(float(logs["loss"])):
            self._fail(f"batch {batch}", model)

    def on_epoch_end(self, epoch, logs, model):
        value = logs.get("loss")
        if value is not None and not np.isfinite(value):
            self._fail(f"epoch {epoch + 1}", model)


class LearningRateScheduler:
    """Set the learning rate from a schedule function at each epoch
    start (tf.keras LearningRateScheduler). ``schedule`` is called as
    ``schedule(epoch, lr)`` (or ``schedule(epoch)`` if it takes one
    argument) and returns the new absolute learning rate; it is applied
    by rewriting ``Model.lr_multiplier`` relative to the learning rate
    passed to ``compile()`` — moments preserved.

    Requires a float ``learning_rate`` at compile time (with a schedule
    there is no single base rate to scale)."""

    def __init__(self, schedule, verbose=0):
        self.schedule = schedule
        self.verbose = verbose

    def on_epoch_begin(self, epoch, model):
        base = getattr(model, "_base_lr", None)
        if base is None:
            raise ValueError(
                "LearningRateScheduler needs a float learning_rate at "
                "compile time (a schedule already varies the rate per "
                "step)")
        current = base * model.lr_multiplier
        try:
            new_lr = self.schedule(epoch, current)
        except TypeError:
            new_lr = self.schedule(epoch)
        new_lr = float(new_lr)
        if new_lr < 0:
            raise ValueError(f"schedule returned a negative learning "
                             f"rate {new_lr} at epoch {epoch}")
        model.lr_multiplier = new_lr / base
        if self.verbose:
            print(f"Epoch {epoch + 1}: LearningRateScheduler set "
                  f"learning rate to {new_lr:.4e}")


class CSVLogger:
    """Append per-epoch history rows to a CSV file (tf.keras
    CSVLogger). The header is written from the first epoch's log keys
    (epoch first, then sorted); opened per epoch so an interrupted run
    keeps every completed row.

    Args:
        path: CSV file path.
        separator: field separator.
        append: if False (default), truncate any existing file when
            training starts.
    """

    def __init__(self, path, separator=",", append=False):
        self.path = str(path)
        self.sep = separator
        self.append = append
        self._keys = None

    def on_epoch_end(self, epoch, logs, model):
        if self._keys is None:
            self._keys = sorted(logs)
            mode = "a" if (self.append and os.path.exists(self.path)) \
                else "w"
            with open(self.path, mode) as f:
                if mode == "w" or os.path.getsize(self.path) == 0:
                    f.write(self.sep.join(["epoch"] + self._keys) + "\n")
        with open(self.path, "a") as f:
            row = [str(epoch + 1)] + [
                repr(float(logs[k])) if k in logs else ""
                for k in self._keys]
            f.write(self.sep.join(row) + "\n")



def _is_sequence(x, y):
    return (hasattr(x, "__getitem__") and y is None
            and not isinstance(x, np.ndarray))


def _host_batch(xb, yb):
    """One batch as numpy: the images uint8 (normalized on the device,
    see ``input_rescale``) or f32, the labels a tuple of f32 arrays."""
    xb = np.asarray(xb)
    if xb.dtype != np.uint8:
        xb = xb.astype(np.float32, copy=False)
    yb = tuple(yb) if isinstance(yb, (list, tuple)) else (yb,)
    return xb, tuple(np.asarray(v, np.float32) for v in yb)


def _epoch_means(logs_acc):
    """Mean of each log over the batches, read from the device once:
    ``{name: float}``, summed in batch order in f64."""
    if not logs_acc:
        return {}
    keys = list(logs_acc[0])
    rows = torch.stack([torch.stack([logs[k].float() for k in keys])
                        for logs in logs_acc]).tolist()
    return {k: sum(col) / len(rows) for k, col in zip(keys, zip(*rows))}


class Model:
    """A trainable model: a ``torch.nn.Module`` + compile/fit/predict.

    Args:
        module: an ``nn.Module`` taking NHWC images and returning one
            output tensor or a list (multi-level heads); ``train()`` /
            ``eval()`` select its BatchNorm mode.
        input_shape: (H, W, C) of one image.
        input_rescale: uint8 image batches normalize on the device with
            this factor (x.float() * input_rescale) in fit, evaluate and
            predict; float inputs are taken as already preprocessed.
        device: where the module lives and runs: the card unless the
            caller asks for the CPU.
    """

    def __init__(self, module, input_shape, input_rescale=1 / 255,
                 device="cuda"):
        self.device = torch.device(device)
        self.module = module.to(self.device)
        self.input_shape = tuple(input_shape)
        self.input_rescale = float(input_rescale)
        # the output shapes, from one eval-mode forward of a zero image
        training = module.training
        module.eval()
        with torch.no_grad():
            out = module(torch.zeros((1, *self.input_shape),
                                     device=self.device))
        module.train(training)
        multi = isinstance(out, (list, tuple))
        self.output_shapes = ([tuple(o.shape) for o in out] if multi
                              else tuple(out.shape))
        self.n_outputs = len(out) if multi else 1

        self.default_frozen = None   # facade hook (e.g. v4 anchors)
        self._tx = None
        self._base_lr = None
        self._loss_fns = None
        self._metric_fns = None
        self._metric_names = None
        self._train_step = None
        self._eval_step = None
        self._state = None
        self._group = None           # the data group of compile
        self._world = None           # every process of compile's mesh
        self.mesh = None             # compile's ("data", "model") grid
        self._interrupted = False
        self.stop_training = False   # callbacks set True to end fit

    # ------------------------------------------------------------------
    @property
    def params(self):
        """``{name: parameter}`` (``named_parameters``), live tensors."""
        return dict(self.module.named_parameters())

    @params.setter
    def params(self, new_params):
        """Copy ``{name: array or tensor}`` (full, unsharded values) into
        the named parameters in place; the optimizer chain's state is
        kept."""
        own = self.params
        unknown = sorted(set(new_params) - set(own))
        if unknown:
            raise KeyError(f"no such parameters: {unknown[:5]}")
        new_params = slice_state_dict(self.module, {
            k: torch.as_tensor(np.asarray(v)) for k, v in new_params.items()})
        with torch.no_grad():
            for name, value in new_params.items():
                own[name].copy_(value)

    @property
    def variables(self):
        """The module's ``state_dict`` (parameters and BatchNorm
        statistics), the full tree: under tensor parallelism the sliced
        entries are gathered over the model group (collective: every
        process of the group reads it)."""
        return gather_state_dict(self.module)

    def set_variables(self, variables):
        """Load a full ``state_dict`` (e.g. ``bridge.from_flax`` of a JAX
        ``Model.variables``), resetting the optimizer state; a sliced
        model takes its slices."""
        self.module.load_state_dict(slice_state_dict(self.module,
                                                     variables), strict=True)
        self._state = None

    @property
    def lr_multiplier(self):
        """Mutable learning-rate multiplier (initially 1.0) that scales
        the optimizer chain's final update. Setting it takes effect at
        the next train step, keeps the optimizer's moments, and is saved
        in checkpoints — the hook ReduceLROnPlateau uses."""
        self._ensure_state()
        return get_lr_multiplier(self._state.optimizer)

    @lr_multiplier.setter
    def lr_multiplier(self, value):
        self._ensure_state()
        set_lr_multiplier(self._state.optimizer, value)

    @property
    def batch_stats(self):
        """``{name: BatchNorm running statistic}`` (``named_buffers``)."""
        return dict(self.module.named_buffers())

    def count_params(self):
        """The parameters of the full model (a sliced one counts its
        whole layers)."""
        dims = sharded_dims(self.module)
        n = self.module.tensor_parallel[0].n if dims else 1
        return sum(p.numel() * (n if name in dims else 1)
                   for name, p in self.module.named_parameters())

    # ------------------------------------------------------------------
    def compile(self, optimizer="adam", loss=None, metrics=None,
                learning_rate=1e-4, frozen=None,
                accumulate_steps=1, ema_decay=None, xla_options=None,
                n_model=1, tp_min_channels=128,
                bn_stats_sg_scope=None):
        """Configure training.

        Args:
            optimizer: "adam" / "adamw" / "sgd" / "rmsprop" (optax's, see
                ``parallel.train.make_optimizer``).
            loss: loss closure or list of closures (one per output).
            metrics: metric closure list, or list-of-lists per output
                (the v3/v4 facade convention).
            learning_rate: float or ``schedule(count) -> float``.
            frozen: predicate (name, parameter) -> bool for parameters
                that take no update; default ``self.default_frozen``.
            accumulate_steps: gradient accumulation factor (> 1 averages
                that many gradients and applies them once).
            ema_decay: optional EMA smoothing of the parameter updates.
            bn_stats_sg_scope: the frozen-statistics BatchNorm backward
                (``models.layers.set_bn_stats_sg``) on this model's
                ConvBNs: ``True`` on all of them, a name (or a sequence
                of names) on those whose qualified name has that
                component, e.g. ``"backbone"``; ``None`` and other falsy
                values keep exact BatchNorm gradients. The forward, the
                loss and the running statistics are unchanged; only the
                backward drops the batch statistics' term. Each compile
                sets it anew.
            n_model: size of the model axis (default 1: data parallelism
                only). > 1 needs a process group whose size it divides:
                the processes form the ``(world / n_model, n_model)``
                grid (``parallel.make_mesh``), every process takes
                process 0's variables, and the ConvBNs and head convs
                that ``parallel.tensor_parallel_shardings`` plans are
                sliced over the model axis
                (``models.layers.set_tensor_parallel``; a ``packed``
                model raises ValueError). The first such compile slices
                the module; a later one must keep ``n_model``.
            tp_min_channels: the smallest output-channel count that is
                sliced (read only when n_model > 1).
            xla_options: the JAX engine's XLA options; not ported, and
                anything but None raises NotImplementedError.

        With a process group up (``parallel.distributed_initialize``),
        the model's BatchNorm statistics are taken over the mesh's data
        axis (``models.layers.set_bn_group``) and the train step averages
        the gradients and the logs over it: the data-parallel step over
        the global batch.
        """
        n_model = int(n_model)
        world = process_count()
        if n_model < 1 or world % n_model:
            raise ValueError(f"n_model={n_model} must divide the {world} "
                             "processes")
        sliced = getattr(self.module, "tensor_parallel", None)
        if sliced is not None and sliced[0].n != n_model:
            raise ValueError(
                f"the module is sliced over {sliced[0].n} processes; "
                f"compile(n_model={n_model}) needs a new Model")
        if xla_options is not None:
            raise NotImplementedError(
                "xla_options: XLA compiler options have no counterpart in "
                "the port (ROADMAP.md, 'Not ported')")
        # falsy (None/False/""/()) means off; anything else must be
        # True, a name or a non-empty sequence of names
        if bn_stats_sg_scope and not (
                bn_stats_sg_scope is True
                or isinstance(bn_stats_sg_scope, str)
                or (isinstance(bn_stats_sg_scope, (list, tuple))
                    and all(isinstance(s, str) for s in bn_stats_sg_scope))):
            raise ValueError(
                "bn_stats_sg_scope must be None/False (off), True "
                "(everywhere), or a module-name str / sequence of "
                f"strs; got {bn_stats_sg_scope!r}")
        if loss is None:
            raise ValueError("compile() requires a loss")
        if frozen is None:
            frozen = self.default_frozen
        loss_fns = list(loss) if isinstance(loss, (list, tuple)) \
            else [loss] * self.n_outputs
        if len(loss_fns) != self.n_outputs:
            raise ValueError(
                f"Got {len(loss_fns)} losses for {self.n_outputs} outputs")

        metric_fns = None
        metric_names = None
        if metrics is not None:
            if len(metrics) > 0 and isinstance(metrics[0], (list, tuple)):
                metric_fns = [list(m) for m in metrics]
            else:
                metric_fns = [list(metrics)] * self.n_outputs
            if len(metric_fns) != self.n_outputs:
                raise ValueError(
                    f"Got {len(metric_fns)} metric lists for "
                    f"{self.n_outputs} outputs")
            metric_names = []
            for i, fns in enumerate(metric_fns):
                prefix = f"out{i + 1}_" if self.n_outputs > 1 else ""
                metric_names.append(
                    [_metric_name(f, prefix) for f in fns])

        self._tx = make_optimizer(optimizer, learning_rate, frozen,
                                  accumulate_steps=accumulate_steps,
                                  ema_decay=ema_decay)
        # base rate for callbacks that set an ABSOLUTE lr
        # (LearningRateScheduler); None when a schedule drives it
        self._base_lr = (float(learning_rate)
                         if isinstance(learning_rate, (int, float))
                         else None)
        self._loss_fns = loss_fns
        self._metric_fns = metric_fns
        self._metric_names = metric_names
        set_bn_stats_sg(
            self.module, bool(bn_stats_sg_scope),
            None if bn_stats_sg_scope is True or not bn_stats_sg_scope
            else bn_stats_sg_scope)
        self.mesh = make_mesh(n_model=n_model)
        if n_model > 1 and sliced is None:
            # every process slices the same tree: process 0's
            broadcast_tensors(self.module.state_dict().values(),
                              self.mesh.group)
            set_tensor_parallel(
                self.module, self.mesh, tensor_parallel_shardings(
                    self.module, self.mesh, int(tp_min_channels)))
        self._world = default_group()
        self._group = (self._world if n_model == 1
                       else self.mesh.data_group)
        set_bn_group(self.module, self._group)
        self._train_step = make_train_step(
            loss_fns, metric_fns, metric_names,
            input_rescale=self.input_rescale, group=self._group)
        self._eval_step = make_eval_step(
            loss_fns, metric_fns, metric_names,
            input_rescale=self.input_rescale)
        self._state = None        # reset optimizer state

    # ------------------------------------------------------------------
    def _check_shards(self, n_rows):
        """Multi-process: every process must pass as many rows (or
        batches of a sequence), or the global batch is not what each
        process's step assumes and the processes fall out of step."""
        if self._world is None:
            return
        t = torch.tensor([n_rows, -n_rows], dtype=torch.float64,
                         device=host_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._world)
        hi, lo = int(t[0]), -int(t[1])
        if hi != lo:
            n = dist.get_world_size(self._world)
            raise ValueError(
                f"global batch of {n_rows} rows x {n} processes: every "
                f"process must pass as many rows (between {lo} and {hi} "
                "here); make every process's shard length the same "
                "multiple of batch_size (parallel.process_batch_slice, "
                "YoloDataSequence.shard)")

    def _broadcast_variables(self):
        """Multi-process: every process starts ``fit`` from process 0's
        parameters and statistics (equal already where every process
        built its model from one seed); under tensor parallelism, from
        those of the first process of its data group, which holds the
        same slice."""
        if self._group is not None:
            broadcast_tensors(self.module.state_dict().values(),
                              self._group, src=self.mesh.data_ranks[0])

    def _any_process(self, flag):
        """Multi-process: whether ``flag`` is set in any process (a
        signal reaches the processes at different steps)."""
        if self._world is None:
            return flag
        t = torch.tensor([float(flag)], device=host_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._world)
        return bool(t[0] > 0)

    def _mean_over_processes(self, means):
        """Multi-process: each host mean averaged over the processes
        (equal batches make it the mean over the global batches)."""
        if self._group is None or not means:
            return means
        keys = sorted(means)
        t = torch.tensor([means[k] for k in keys], dtype=torch.float64,
                         device=host_device())
        dist.all_reduce(t, group=self._group)
        n = dist.get_world_size(self._group)
        return {k: float(v) / n for k, v in zip(keys, t.tolist())}

    def _ensure_state(self):
        if self._state is None:
            if self._tx is None:
                raise ValueError("Call compile() before fit()")
            self._state = TrainState(model=self.module,
                                     optimizer=self._tx(self.module))

    def _check_uint8_seq(self, seq):
        """Refuse a uint8 sequence whose declared rescale disagrees
        with this model's on-device ``input_rescale`` — uint8 batches
        skip the host-side rescale, so a mismatch silently trains/
        evaluates on mis-normalized inputs."""
        if not getattr(seq, "uint8", False):
            return
        seq_rescale = getattr(seq, "rescale", None)
        if seq_rescale is not None and not np.isclose(
                float(seq_rescale), self.input_rescale):
            raise ValueError(
                f"uint8 sequence declares rescale={seq_rescale} "
                f"but this Model normalizes on device with "
                f"input_rescale={self.input_rescale}; pass "
                "create_model(input_rescale=...) / "
                "Model(input_rescale=...) to match (uint8 batches "
                "skip the host-side rescale).")

    @staticmethod
    def _batches(x, y, batch_size, shuffle, rng):
        n = x.shape[0]
        idx = np.arange(n)
        if shuffle:
            rng.shuffle(idx)
        for lo in range(0, n, batch_size):
            sel = idx[lo:lo + batch_size]
            yb = ([yi[sel] for yi in y] if isinstance(y, (list, tuple))
                  else y[sel])
            yield x[sel], yb

    def _iterate(self, x, y, batch_size, shuffle, rng):
        """Host batches of one pass: a sequence's own (with background
        prefetch where it has ``as_iterator``), or slices of arrays."""
        if _is_sequence(x, y):
            return (x.as_iterator() if hasattr(x, "as_iterator")
                    else (x[i] for i in range(len(x))))
        return self._batches(np.asarray(x), y, batch_size, shuffle, rng)

    def _feed(self, pairs, prefetch=0):
        """Host batches -> (x, y tuple) tensors on the model's device.
        ``prefetch`` > 0: the numpy work on a background thread, and that
        many batches' copies in flight (pinned memory, a side stream)."""
        host = (_host_batch(xb, yb) for xb, yb in pairs)
        if prefetch:
            return prefetch_to_device(
                threaded_prefetch(lambda: host, int(prefetch)),
                int(prefetch), self.device)
        return ((to_device(xb, self.device),
                 tuple(to_device(v, self.device) for v in yb))
                for xb, yb in host)

    def fit(self, x, y=None, epochs=1, batch_size=20, shuffle=True,
            seed=None, verbose=1, validation_data=None,
            profile_dir=None, checkpoint_dir=None,
            checkpoint_every=None, checkpoint_async=False,
            checkpoint_keep=3, resume=False,
            checkpoint_on_interrupt=False, callbacks=None,
            prefetch=0):
        """Train. ``x`` is an ndarray (with ``y`` labels, a list for
        multi-output models) or a sequence yielding (img, labels).

        Args:
            profile_dir: if set, a ``torch.profiler`` trace of the first
                epoch is written there (``trace.json``, Chrome format).
            checkpoint_dir/checkpoint_every: save the full training
                state (parameters + optimizer chain + step + fit
                position) every N epochs.
            checkpoint_async: periodic checkpoints snapshot the state
                to host memory at once and write on a background thread;
                fit() fences the writes before it returns. The interrupt
                checkpoint always blocks.
            checkpoint_keep: retain only the newest N step_* dirs.
            resume: restore the latest checkpoint under
                ``checkpoint_dir`` before training and continue at its
                fit position: ``epochs`` is the TOTAL target, the epochs
                done are skipped, and a checkpoint taken mid-epoch skips
                the epoch's batches already trained (with ``seed`` set,
                the shuffle RNG is fast-forwarded, so the run reproduces
                the uninterrupted one). No checkpoint yet means a fresh
                start.
            checkpoint_on_interrupt: (requires ``checkpoint_dir``)
                SIGTERM/SIGINT handlers for the duration of fit(): on
                delivery the current train step finishes, the full state
                is checkpointed, and fit() returns. Pair with
                ``resume=True`` on restart.
            callbacks: keras-style objects with optional
                ``on_epoch_begin(epoch, model)``,
                ``on_epoch_end(epoch, logs, model)`` and
                ``on_train_batch_end(batch, logs, model)``. Batch-end
                ``logs`` values are 0-d device tensors: reading one
                waits for the step. ``model.stop_training = True`` ends
                training after the current epoch.
            validation_data: an ``(x, y)`` ndarray pair or a sequence of
                ``(img, labels)`` batches, evaluated each epoch into
                ``val_*`` history keys.
            prefetch: look-ahead depth (batches) of the device feed; 0
                converts and copies each batch inline.

        Multi-process runs (``parallel.distributed_initialize`` before
        ``compile``): every process calls fit() with its OWN disjoint
        shard of the data (``parallel.process_batch_slice`` or
        ``YoloDataSequence.shard``) and the per-process ``batch_size``,
        as many rows in each; the optimizer sees the global batch
        (``batch_size`` x the process count), as one process over the
        concatenated shards would. The processes start from process 0's
        variables. Checkpoints: every process passes the same
        ``checkpoint_dir`` (a directory all of them see); process 0
        writes, all of them wait for it and all of them resume from it
        (``parallel.checkpoint``). An interrupt in any process stops
        every process at the same step.
        """
        from .parallel.checkpoint import (latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint, wait_for_saves)
        self._ensure_state()
        self.stop_training = False
        callbacks = list(callbacks or [])
        rng = np.random.RandomState(seed)

        is_sequence = _is_sequence(x, y)
        if is_sequence:
            self._check_uint8_seq(x)
            steps_per_epoch = len(x)
            self._check_shards(steps_per_epoch)
        else:
            n_rows = np.asarray(x).shape[0]
            steps_per_epoch = -(-n_rows // batch_size)
            self._check_shards(n_rows)
        self._broadcast_variables()
        initial_epoch = 0
        skip_batches = 0
        if resume:
            if checkpoint_dir is None:
                raise ValueError("resume=True requires checkpoint_dir")
            latest = latest_checkpoint(checkpoint_dir)
            if latest is not None:
                _, (initial_epoch, skip_batches) = restore_checkpoint(
                    latest, self._state)
                initial_epoch = min(initial_epoch, epochs)
                if initial_epoch >= epochs:
                    skip_batches = 0
                if shuffle and not is_sequence:
                    # consume the RNG stream of the skipped epochs so the
                    # resumed batch order matches the uninterrupted run
                    idx_ff = np.arange(n_rows)
                    for _ in range(initial_epoch):
                        rng.shuffle(idx_ff)
                if verbose and initial_epoch >= epochs:
                    print(f"Resuming from {latest}: already trained to "
                          f"the {epochs}-epoch target, nothing to do")
                elif verbose:
                    print(f"Resuming from {latest} "
                          f"(step {self._state.step}, "
                          f"epoch {initial_epoch + 1}/{epochs})")

        self._interrupted = False
        sig_prev = []
        if checkpoint_on_interrupt:
            if checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_on_interrupt=True requires checkpoint_dir")
            def on_signal(signum, frame):
                self._interrupted = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    sig_prev.append((sig, signal.signal(sig, on_signal)))
                except ValueError:  # fit() called off the main thread
                    break

        history = {"loss": []}
        profiler = None
        if profile_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        try:
            for epoch in range(initial_epoch, epochs):
                t0 = time.time()
                for cb in callbacks:
                    if hasattr(cb, "on_epoch_begin"):
                        cb.on_epoch_begin(epoch, self)
                logs_acc = []   # device scalars; host read at epoch end
                iterator = self._iterate(x, y, batch_size, shuffle, rng)
                # mid-epoch resume: replay the epoch's batch order but
                # skip (without copying) the already-trained steps
                skip_now, skip_batches = skip_batches, 0
                if skip_now:
                    iterator = itertools.islice(iterator, skip_now, None)
                batch_i = skip_now - 1
                for batch_i, (xb, yb) in enumerate(
                        self._feed(iterator, prefetch), start=skip_now):
                    self._state, logs = self._train_step(self._state, xb,
                                                         yb)
                    logs_acc.append(logs)
                    for cb in callbacks:
                        if hasattr(cb, "on_train_batch_end"):
                            cb.on_train_batch_end(batch_i, logs, self)
                    if checkpoint_on_interrupt:
                        self._interrupted = self._any_process(
                            self._interrupted)
                    if self._interrupted or self.stop_training:
                        break

                if self._interrupted:
                    done = batch_i + 1
                    position = ((epoch + 1, 0) if done >= steps_per_epoch
                                else (epoch, done))
                    ckpt = save_checkpoint(checkpoint_dir, self._state,
                                           keep=checkpoint_keep,
                                           position=position)
                    if verbose:
                        print(f"Interrupted at step {self._state.step} — "
                              f"state saved to {ckpt}; re-run with "
                              "resume=True to continue")
                    break

                means = _epoch_means(logs_acc)   # the epoch's host read
                if validation_data is not None:
                    if isinstance(validation_data, (tuple, list)):
                        val_logs = self.evaluate(*validation_data,
                                                 batch_size=batch_size,
                                                 verbose=0)
                    else:               # a sequence of (img, labels)
                        val_logs = self.evaluate(validation_data,
                                                 batch_size=batch_size,
                                                 verbose=0)
                    means.update({f"val_{k}": v
                                  for k, v in val_logs.items()})
                for k, v in means.items():
                    history.setdefault(k, []).append(v)
                history.setdefault("epoch_time", []).append(
                    time.time() - t0)
                if verbose:
                    stats = " - ".join(f"{k}: {v:.4f}"
                                       for k, v in means.items())
                    print(f"Epoch {epoch + 1}/{epochs} - "
                          f"{time.time() - t0:.1f}s - {stats}")
                if profiler is not None:
                    profiler.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(
                        os.path.join(profile_dir, "trace.json"))
                    profiler = None
                if (checkpoint_dir is not None and checkpoint_every
                        and (epoch + 1) % checkpoint_every == 0):
                    save_checkpoint(checkpoint_dir, self._state,
                                    keep=checkpoint_keep,
                                    block=not checkpoint_async,
                                    position=(epoch + 1, 0))
                for cb in callbacks:
                    if hasattr(cb, "on_epoch_end"):
                        cb.on_epoch_end(epoch, dict(means), self)
                if self.stop_training:
                    break
        finally:
            for sig, handler in sig_prev:
                signal.signal(sig, handler)
            if profiler is not None:
                profiler.stop()
            if checkpoint_async:
                wait_for_saves()
        return history

    # ------------------------------------------------------------------
    def evaluate(self, x, y=None, batch_size=20, verbose=1):
        """Eval-mode loss/metrics, mean over the batches. ``x`` is an
        ndarray with ``y`` labels, or a sequence yielding (img, labels)
        batches with ``y=None``. Multi-process: each process passes its
        own shard, as in fit, and every process gets the mean over all
        of them."""
        self._ensure_state()
        if _is_sequence(x, y):
            self._check_uint8_seq(x)
        iterator = self._iterate(x, y, batch_size, False,
                                 np.random.RandomState(0))
        logs_acc = [self._eval_step(self._state, xb, yb)
                    for xb, yb in self._feed(iterator)]
        means = self._mean_over_processes(_epoch_means(logs_acc))
        if verbose:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in means.items()))
        return means

    # ------------------------------------------------------------------
    def predict(self, x, batch_size=32, verbose=0):
        """Eval-mode forward in batches of ``batch_size``; returns an
        ndarray, or a list of ndarrays (multi-output), f32, rows aligned
        with ``x``. uint8 images normalize on the device. Multi-process:
        each process predicts its own rows, with no collective."""
        x = np.asarray(x)
        if x.dtype != np.uint8:
            x = x.astype(np.float32, copy=False)
        shapes = (self.output_shapes if self.n_outputs > 1
                  else [self.output_shapes])
        if x.shape[0] == 0:
            empty = [np.zeros((0, *s[1:]), np.float32) for s in shapes]
            return empty if self.n_outputs > 1 else empty[0]
        self.module.eval()
        outs_acc = [[] for _ in shapes]
        with torch.inference_mode():
            for lo in range(0, x.shape[0], batch_size):
                xb = to_device(x[lo:lo + batch_size], self.device)
                out = self.module(_cast_input(xb, self.input_rescale))
                outs = out if isinstance(out, (list, tuple)) else [out]
                for acc, o in zip(outs_acc, outs):
                    acc.append(o.float())
            # one read of the host at the end
            result = [torch.cat(acc).cpu().numpy() for acc in outs_acc]
        return result if self.n_outputs > 1 else result[0]

    # ------------------------------------------------------------------
    def save_weights(self, path):
        """``torch.save`` of the module's full ``state_dict``
        (:attr:`variables`: parameters and BatchNorm statistics) as CPU
        tensors. Not a flax msgpack file: the JAX package's weight files
        do not load here, nor these there."""
        torch.save({k: v.detach().cpu()
                    for k, v in self.variables.items()}, path)

    def load_weights(self, path):
        """Load a :meth:`save_weights` file onto the model's device,
        resetting the optimizer state."""
        self.set_variables(torch.load(path, map_location=self.device,
                                      weights_only=True))

    def summary(self):
        shapes = self.output_shapes
        print(f"Model: {type(self.module).__name__}")
        print(f"  input:  (N, {', '.join(map(str, self.input_shape))})")
        print(f"  output: {shapes}")
        print(f"  params: {self.count_params():,}")
