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
    anything ``np.asarray`` takes) -> ``state_dict`` of CPU tensors."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            out[".".join(path)] = torch.from_numpy(np.array(leaf))
    return out


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
