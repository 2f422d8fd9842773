"""Train and eval step factories.

Port of ``TrainState``, ``create_train_state``, ``_cast_input``,
``make_train_step``, ``make_eval_step`` and ``make_optimizer`` (Adam) in
tf2_yolo_tpu/parallel/train.py. One step is the forward with BatchNorm in
batch mode, the multi-level loss, the backward pass and the optimizer
update. JAX's state is immutable and its step returns a new one; here the
state owns the model and the optimizer, and a step updates parameters,
running statistics and optimizer moments in place and returns the same
state object. (sgd, rmsprop, adamw, gradient accumulation, the EMA and
metrics in the step come later.)
"""

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer
    (moments, step count, learning-rate multiplier) and the number of
    steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(optimizer="adam", learning_rate=1e-4, frozen=None):
    """Return ``tx(model) -> torch.optim.Optimizer`` from a keras-style
    spec.

    Args:
        optimizer: "adam". eps is tf.keras's 1e-7; the update is
            lr * m_hat / (sqrt(v_hat) + eps) with bias-corrected moments
            and eps outside the root, which is optax's.
        learning_rate: float.
        frozen: optional predicate (name, parameter) -> bool marking
            parameters that take no update (e.g. the v4 head anchors
            when they are not trainable). ``name`` is the dotted
            ``named_parameters`` name.

    The optimizer's first param group holds ``base_lr`` and
    ``lr_multiplier`` (initially 1); see :func:`set_lr_multiplier`.
    """
    if optimizer != "adam":
        raise NotImplementedError(
            f"optimizer {optimizer!r}: only adam is ported yet "
            "(ROADMAP.md, modules to port, train step)")

    def tx(model):
        params = [p for name, p in model.named_parameters()
                  if frozen is None or not frozen(name, p)]
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-7)
        group = opt.param_groups[0]
        group["base_lr"] = float(learning_rate)
        group["lr_multiplier"] = 1.0
        return opt

    return tx


def get_lr_multiplier(optimizer):
    """Read the mutable learning-rate multiplier (1.0 for an optimizer
    built without one)."""
    return optimizer.param_groups[0].get("lr_multiplier", 1.0)


def set_lr_multiplier(optimizer, value):
    """Scale the effective learning rate to ``base_lr * value`` without
    touching Adam's moments (keras ReduceLROnPlateau semantics). The
    multiplier lives in the optimizer's state_dict."""
    group = optimizer.param_groups[0]
    if "base_lr" not in group:
        raise ValueError("optimizer was not built by make_optimizer")
    group["lr_multiplier"] = float(value)
    group["lr"] = group["base_lr"] * float(value)
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


def _total_loss(model, loss_fns, x, ys, input_rescale):
    device = next(model.parameters()).device
    x = _cast_input(x.to(device), input_rescale)
    outs = _as_tuple(model(x))
    total = 0.0
    for lf, y_i, o_i in zip(loss_fns, _as_tuple(ys), outs):
        total = total + lf(y_i.to(device), o_i)
    return total


def make_train_step(loss_fns, input_rescale=1 / 255):
    """Build ``train_step(state, x, y_tuple) -> (state, logs)``.

    loss_fns: one loss per model output (summed).
    input_rescale: on-device normalization factor for uint8 image
        batches (see ``_cast_input``).
    ``logs["loss"]`` is a 0-d tensor on the model's device (reading it
    waits for the step).
    """
    loss_fns = list(loss_fns)

    def train_step(state, x, ys):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = _total_loss(state.model, loss_fns, x, ys, input_rescale)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_eval_step(loss_fns, input_rescale=1 / 255):
    """Build ``eval_step(state, x, y_tuple) -> logs`` (eval-mode BN)."""
    loss_fns = list(loss_fns)

    @torch.no_grad()
    def eval_step(state, x, ys):
        state.model.eval()
        return {"loss": _total_loss(state.model, loss_fns, x, ys,
                                    input_rescale)}

    return eval_step
