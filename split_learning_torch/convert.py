"""Carry weights between the JAX package's flax trees and the port.

Both sides are keyed by absolute layer name (``layer1`` .. ``layerN``).
A flax tree ``{"layer2": {"attention": {"q_proj": {"kernel": a}}}}``
becomes the port's state tree ``{"layer2": {"attention.q_proj.weight":
t}}``:

* ``Dense.kernel`` (in, out) <-> ``weight`` (out, in) (a transpose);
* ``Embed.embedding`` <-> ``weight``;
* ``RMSNorm.scale`` <-> ``weight``.

The inverse needs the model to tell which flax name each ``weight``
had: every parametric leaf module of the port names it in its
``jax_param`` attribute.  A round trip is exact (a transpose and a copy
of float32 values).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from split_learning_torch.models.split import SplitModel

_LEAVES = ("kernel", "embedding", "scale")


def _walk(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_params(tree: dict) -> dict:
    """flax params tree of numpy arrays -> the port's state tree of
    CPU tensors."""
    out: dict = {}
    for path, leaf in _walk(tree):
        layer, *inner, leaf_name = path
        if leaf_name not in _LEAVES:
            raise KeyError(f"no torch counterpart for flax leaf "
                           f"{'/'.join(path)}")
        arr = np.asarray(leaf)
        if leaf_name == "kernel":
            arr = arr.T
        key = ".".join([*inner, "weight"])
        out.setdefault(layer, {})[key] = torch.from_numpy(np.array(arr))
    return out


def to_jax_params(state: dict, model: SplitModel) -> dict:
    """The port's state tree -> flax params tree of numpy arrays;
    ``model`` (any shard owning the tree's layers) names each leaf."""
    out: dict = {}
    for layer, sd in state.items():
        owners = dict(model.layers[layer].named_modules())
        for key, t in sd.items():
            *inner, pname = key.split(".")
            if pname != "weight":
                raise KeyError(f"unexpected parameter {layer}.{key}")
            leaf_name = owners[".".join(inner)].jax_param
            arr = t.detach().cpu().numpy()
            if leaf_name == "kernel":
                arr = arr.T
            node = out.setdefault(layer, {})
            for part in inner:
                node = node.setdefault(part, {})
            node[leaf_name] = np.ascontiguousarray(arr)
    return out


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
