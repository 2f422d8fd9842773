"""Weights between a flax variables tree and a torch ``state_dict``.

The port names its submodules after the flax paths and keeps the flax
layouts, so the mapping is by name alone: the flax leaf
``params/backbone/stage3/block2/expand/conv/kernel`` is the state_dict
entry ``backbone.stage3.block2.expand.conv.kernel``, and
``batch_stats/.../bn/{mean,var}`` are the BN buffers ``...bn.{mean,var}``.
No tensor is transposed: conv kernels stay HWIO (k, k, Ci, Co), which is
also the layout the port's conv kernel reads.
"""

import numpy as np
import torch

_STATS = ("mean", "var")


def _flatten(tree, prefix=()):
    for name, node in tree.items():
        if hasattr(node, "items"):             # dict or flax FrozenDict
            yield from _flatten(node, prefix + (name,))
        else:
            yield prefix + (name,), node


def from_flax(variables):
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays (or
    anything ``np.asarray`` takes), or a JAX ``TrainState`` (anything
    with ``params`` and ``batch_stats`` attributes), -> ``state_dict`` of
    CPU tensors. The v4 head ``anchors`` are parameters on both sides.

    The int8 scales tree of the JAX package's ``calibrate_int8``,
    ``{"quant": ...}``, comes across as the same tree of 0-dim f32 CPU
    tensors, which ``export.make_serving_fn(quant=...)`` takes. It is
    converted on its own: a ``quant`` collection beside ``params`` raises
    ValueError."""
    if not hasattr(variables, "params") and "quant" in variables:
        if set(variables) != {"quant"}:
            raise ValueError("convert the quant collection on its own: "
                             "from_flax({'quant': ...})")
        return {"quant": _tree_to_torch(variables["quant"])}
    return {name: torch.from_numpy(np.array(leaf))
            for name, leaf in state_dict_names(variables).items()}


def state_dict_names(variables):
    """``{state_dict name: leaf}`` of a flax ``{"params": ...,
    "batch_stats": ...}`` tree (or a JAX ``TrainState``) whose leaves may
    be anything (arrays, shardings, shapes): the names
    :func:`from_flax` gives them, the leaves as they are."""
    if hasattr(variables, "params"):
        variables = {"params": variables.params,
                     "batch_stats": variables.batch_stats}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            out[".".join(path)] = leaf
    return out


def _tree_to_torch(tree):
    return {name: (_tree_to_torch(node) if hasattr(node, "items")
                   else torch.from_numpy(np.array(node, np.float32)))
            for name, node in tree.items()}


def to_flax(state_dict):
    """Inverse of :func:`from_flax`: BN ``mean``/``var`` go to
    ``batch_stats``, every other entry to ``params``; numpy leaves."""
    params, stats = {}, {}
    for key, tensor in state_dict.items():
        path = key.split(".")
        node = stats if path[-1] in _STATS else params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = tensor.detach().cpu().numpy()
    return {"params": params, "batch_stats": stats}


def flax_leaves(model, grad=False):
    """``{flax path: tensor}`` of a module's parameters and BN
    statistics, e.g. ``params/backbone/stem/conv/kernel`` and
    ``batch_stats/backbone/stem/bn/mean``, for a leaf-by-leaf comparison
    with a flax tree. ``grad=True`` gives each parameter's ``.grad``
    instead (``None`` where it has none) and no statistics."""
    out = {}
    for name, p in model.named_parameters():
        out["params/" + name.replace(".", "/")] = p.grad if grad else p
    if not grad:
        # the buffers of the state_dict: a non-persistent one (the v2/v3
        # heads' constant anchors) has no flax leaf
        persistent = model.state_dict(keep_vars=True)
        for name, b in model.named_buffers():
            if name in persistent:
                out["batch_stats/" + name.replace(".", "/")] = b
    return out
