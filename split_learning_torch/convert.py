"""Carry weights between the JAX package's flax trees and the port.

Both sides are keyed by absolute layer name (``layer1`` .. ``layerN``).
A flax tree ``{"layer2": {"attention": {"q_proj": {"kernel": a}}}}``
becomes the port's state tree ``{"layer2": {"attention.q_proj.weight":
t}}``:

* ``Dense.kernel`` (in, out) <-> ``weight`` (out, in) (a transpose);
* ``Conv.kernel`` HWIO <-> ``weight`` OIHW;
* ``Embed.embedding`` <-> ``weight``;
* ``RMSNorm.scale`` and ``BatchNorm.scale`` <-> ``weight``;
* a Conv, Dense or BatchNorm ``bias`` <-> ``bias``.

The inverse needs the model to tell which flax name each ``weight``
had: every parametric leaf module of the port names it in its
``jax_param`` attribute.  BatchNorm running statistics travel in their
own tree, keyed alike on both sides (``{"layer2": {"mean", "var"}}``,
flax's ``batch_stats`` collection): :func:`from_jax_stats` and
:func:`to_jax_stats`.  A round trip is exact (a permutation and a copy
of float32 values).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from split_learning_torch.models.split import SplitModel

_LEAVES = ("kernel", "embedding", "scale", "bias")
_STATS = ("mean", "var")


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """Dense (in, out) -> (out, in); Conv HWIO -> OIHW."""
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def _kernel_to_jax(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T


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
            arr = _kernel_to_torch(arr)
        pname = "bias" if leaf_name == "bias" else "weight"
        key = ".".join([*inner, pname])
        out.setdefault(layer, {})[key] = torch.from_numpy(
            np.array(arr, order="C"))
    return out


def to_jax_params(state: dict, model: SplitModel) -> dict:
    """The port's state tree -> flax params tree of numpy arrays;
    ``model`` (any shard owning the tree's layers) names each leaf."""
    out: dict = {}
    for layer, sd in state.items():
        owners = dict(model.layers[layer].named_modules())
        for key, t in sd.items():
            *inner, pname = key.split(".")
            if pname not in ("weight", "bias"):
                raise KeyError(f"unexpected parameter {layer}.{key}")
            leaf_name = (owners[".".join(inner)].jax_param
                         if pname == "weight" else "bias")
            arr = t.detach().cpu().numpy()
            if leaf_name == "kernel":
                arr = _kernel_to_jax(arr)
            node = out.setdefault(layer, {})
            for part in inner:
                node = node.setdefault(part, {})
            node[leaf_name] = np.ascontiguousarray(arr)
    return out


def from_jax_stats(tree: dict) -> dict:
    """flax ``batch_stats`` tree of numpy arrays -> the port's statistics
    tree of CPU tensors (the same keys)."""
    out: dict = {}
    for layer, leaves in tree.items():
        if set(leaves) - set(_STATS):
            raise KeyError(f"no torch counterpart for batch_stats of "
                           f"{layer}: {sorted(leaves)}")
        out[layer] = {k: torch.from_numpy(np.array(v))
                      for k, v in leaves.items()}
    return out


def to_jax_stats(stats: dict) -> dict:
    """The port's statistics tree -> flax ``batch_stats`` tree of numpy
    arrays."""
    return {layer: {k: t.detach().cpu().numpy().copy()
                    for k, t in leaves.items()}
            for layer, leaves in stats.items()}


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
