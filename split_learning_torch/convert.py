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
* a ``bias`` <-> ``bias``, and the ViT's ``cls`` and ``pos`` and KWT's
  ``cls_token`` and ``pos_embed`` <-> the parameters of the same names.

BERT's layers are nested modules of these (its embeddings' three
``Embed`` tables and ``LayerNorm``, each block's ``attention``,
``attention_norm``, ``intermediate``, ``output`` and ``output_norm``,
the pooler's ``dense``, the head's ``classifier``), named as in flax.

LoRA adapter trees (:mod:`split_learning_torch.ops.lora`) cross with
:func:`from_jax_lora` / :func:`to_jax_lora`: the JAX package keeps
``{"a": (in, r), "b": (r, out)}`` under a kernel's path, the port keeps
``{"a": (r, in), "b": (out, r)}`` under the weight's dotted key — each
factor transposed.  An auxiliary head's parameters (async mode) cross
with :func:`from_jax_aux` / :func:`to_jax_aux`.

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
_NAMED = ("cls", "pos", "cls_token", "pos_embed")
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


def from_jax_lora(tree: dict) -> dict:
    """JAX adapter tree (``{layer: {...: {"kernel": {"a", "b"}}}}`` of
    numpy arrays) -> the port's (``{layer: {"dotted.weight": {"a",
    "b"}}}`` of CPU tensors, each factor transposed)."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            layer, *inner, leaf = path
            if leaf != "kernel":
                raise KeyError(f"adapter on a non-kernel leaf "
                               f"{'/'.join(path)}")
            out.setdefault(layer, {})[".".join([*inner, "weight"])] = {
                n: torch.from_numpy(np.array(np.asarray(node[n]).T,
                                             order="C"))
                for n in ("a", "b")}
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return out


def to_jax_lora(lora: dict) -> dict:
    """The port's adapter tree -> the JAX package's layout (numpy)."""
    out: dict = {}
    for layer, entries in lora.items():
        for key, entry in entries.items():
            *inner, _ = key.split(".")
            node = out.setdefault(layer, {})
            for part in inner:
                node = node.setdefault(part, {})
            node["kernel"] = {n: np.ascontiguousarray(
                entry[n].detach().cpu().numpy().T) for n in ("a", "b")}
    return out


def from_jax_aux(tree: dict) -> dict:
    """An auxiliary head's flax params (``{"proj": {"kernel", "bias"},
    "probe": {...}}``, :mod:`split_learning_torch.ops.auxiliary`) ->
    the :class:`~split_learning_torch.ops.auxiliary.AuxHead`'s state
    dict of CPU tensors (each Dense kernel transposed)."""
    return {f"{layer}.{'weight' if name == 'kernel' else name}":
            torch.from_numpy(np.array(
                _kernel_to_torch(np.asarray(leaf)) if name == "kernel"
                else leaf, order="C"))
            for layer, leaves in tree.items()
            for name, leaf in leaves.items()}


def to_jax_aux(state: dict) -> dict:
    """An AuxHead's state dict -> the JAX package's flax params tree
    (numpy)."""
    out: dict = {}
    for key, t in state.items():
        layer, pname = key.split(".")
        arr = t.detach().cpu().numpy()
        name = "kernel" if pname == "weight" else pname
        out.setdefault(layer, {})[name] = np.ascontiguousarray(
            _kernel_to_jax(arr) if name == "kernel" else arr)
    return out


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
