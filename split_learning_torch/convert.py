"""Carry weights between the JAX package's flax trees and the port.

Both sides are keyed by absolute layer name (``layer1`` .. ``layerN``).
A flax tree ``{"layer2": {"attention": {"q_proj": {"kernel": a}}}}``
becomes the port's state tree ``{"layer2": {"attention.q_proj.weight":
t}}``:

* ``Dense.kernel`` (in, out) <-> ``weight`` (out, in) (a transpose);
* ``Conv.kernel`` HWIO <-> ``weight`` OIHW;
* a ``DenseGeneral.kernel`` of attention (query, key and value (embed,
  heads, head_dim), out (heads, head_dim, embed)) <-> ``weight`` in the
  same layout;
* ``Embed.embedding`` <-> ``weight``;
* ``RMSNorm``, ``LayerNorm`` and ``BatchNorm`` ``scale`` <-> ``weight``;
* a ``bias`` <-> ``bias``, and the ViT's ``cls`` and ``pos`` <-> the
  parameters of the same names.

The inverse needs the model to tell which flax name each ``weight``
had: every parametric leaf module of the port names it in its
``jax_param`` attribute.  BatchNorm running statistics travel in their
own tree (flax's ``batch_stats`` collection): :func:`from_jax_stats`
and :func:`to_jax_stats`.  A layer that is a BatchNorm holds ``{"mean",
"var"}`` on both sides; the BatchNorms nested in a layer are nested
dicts in flax (``{"layer4": {"bn1": {"mean", "var"}}}``) and dotted
paths in the port (``{"layer4": {"bn1.mean", "bn1.var"}}``).  A round
trip is exact (a permutation and a copy of float32 values).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from split_learning_torch.models.split import SplitModel

_LEAVES = ("kernel", "embedding", "scale", "bias")
#: parameters that keep their flax name in the port
_NAMED = ("cls", "pos")
_STATS = ("mean", "var")


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """Dense (in, out) -> (out, in); Conv HWIO -> OIHW; a 3-D
    DenseGeneral kernel as it is."""
    if arr.ndim == 3:
        return arr
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def _kernel_to_jax(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 3:
        return arr
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
        if leaf_name not in _LEAVES + _NAMED:
            raise KeyError(f"no torch counterpart for flax leaf "
                           f"{'/'.join(path)}")
        arr = np.asarray(leaf)
        if leaf_name == "kernel":
            arr = _kernel_to_torch(arr)
        pname = (leaf_name if leaf_name in ("bias",) + _NAMED
                 else "weight")
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
            if pname not in ("weight", "bias") + _NAMED:
                raise KeyError(f"unexpected parameter {layer}.{key}")
            leaf_name = (owners[".".join(inner)].jax_param
                         if pname == "weight" else pname)
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
    tree of CPU tensors (a nested BatchNorm's leaves keyed by their
    dotted path inside the layer)."""
    out: dict = {}
    for path, leaf in _walk(tree):
        layer, *inner, stat = path
        if stat not in _STATS:
            raise KeyError(f"no torch counterpart for batch_stats leaf "
                           f"{'/'.join(path)}")
        out.setdefault(layer, {})[".".join([*inner, stat])] = (
            torch.from_numpy(np.array(leaf)))
    return out


def to_jax_stats(stats: dict) -> dict:
    """The port's statistics tree -> flax ``batch_stats`` tree of numpy
    arrays (dotted paths become nested dicts)."""
    out: dict = {}
    for layer, leaves in stats.items():
        for key, t in leaves.items():
            *inner, stat = key.split(".")
            node = out.setdefault(layer, {})
            for part in inner:
                node = node.setdefault(part, {})
            node[stat] = t.detach().cpu().numpy().copy()
    return out


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
