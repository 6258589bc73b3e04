"""Weighted FedAvg over parameter trees of tensors.

Port of the JAX package's ``ops/fedavg.py`` host fold, with the same
semantics as the reference aggregator:

* weighted average with weights normalized by the *total* weight (absent
  contributors still dilute);
* union of keys across contributors (a key missing from a client simply
  contributes nothing);
* NaNs zero-filled before averaging;
* integer/bool leaves are averaged in float32 then rounded (half to
  even) back to the original dtype.

Leaves are ``torch.Tensor``s (numpy arrays are accepted and converted).
The fold runs on whatever device the leaves live on; on the CPU it is
bit-identical to the JAX package's fold: the float32 operations and
their order are the same.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def is_int_dtype(dtype: torch.dtype) -> bool:
    """True for integer/bool dtypes: these average in float then round
    back."""
    return not (dtype.is_floating_point or dtype.is_complex)


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
        np.asarray(leaf))


def _contrib(leaf: torch.Tensor, w: float) -> torch.Tensor:
    return torch.nan_to_num(leaf.to(torch.float32)) * w


def _finish(avg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if is_int_dtype(dtype):
        return torch.round(avg).to(dtype)
    return avg.to(dtype)


def _avg_leaves(leaves: Sequence, weights: Sequence[float],
                total_w: float) -> torch.Tensor:
    leaves = [_as_tensor(x) for x in leaves]
    acc = None
    for leaf, w in zip(leaves, weights):
        t = _contrib(leaf, w)
        acc = t if acc is None else acc + t
    return _finish(acc / total_w, leaves[0].dtype)


def fedavg_trees(trees: Sequence[Any],
                 weights: Sequence[float] | None = None) -> Any:
    """Weighted FedAvg over a list of trees (flat or nested dicts).

    Dict nodes are merged by key union; non-dict leaves are averaged.
    Shapes of shared leaves must match."""
    if not trees:
        raise ValueError("fedavg_trees: empty input")
    if weights is None:
        weights = [1.0] * len(trees)
    total_w = float(sum(weights))

    def merge(nodes_weights):
        nodes = [n for n, _ in nodes_weights]
        if isinstance(nodes[0], dict):
            keys = set().union(*(n.keys() for n in nodes))
            return {
                k: merge([(n[k], w) for n, w in nodes_weights if k in n])
                for k in sorted(keys)
            }
        ws = [w for _, w in nodes_weights]
        return _avg_leaves(nodes, ws, total_w)

    return merge(list(zip(trees, weights)))


def walk_items(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs under ``fedavg_trees`` dict semantics: dicts
    are internal nodes, everything else is a leaf."""
    if isinstance(tree, dict):
        for k in tree:
            yield from walk_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def unflatten_items(flat: dict) -> dict:
    """Inverse of :func:`walk_items` over a {path tuple: leaf} map;
    keys are emitted in sorted path order."""
    out: dict = {}
    for path in sorted(flat, key=lambda p: tuple(map(str, p))):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = flat[path]
    return out


class TreeFold:
    """Streaming weighted FedAvg over dict trees: contributions fold one
    at a time into per-path running float32 sums, with one divide by the
    total weight at :meth:`finalize`.  Bit-identical to
    :func:`fedavg_trees` over the same contribution order, and holds no
    more than one contributor's tree plus the accumulator."""

    def __init__(self):
        self._acc: dict = {}
        self._dtype: dict = {}
        self.total_w: float = 0.0

    def add(self, tree: Any, weight: float = 1.0) -> None:
        self.total_w += float(weight)
        for path, leaf in walk_items(tree):
            leaf = _as_tensor(leaf)
            t = _contrib(leaf, weight)
            if path in self._acc:
                self._acc[path] = self._acc[path] + t
            else:
                self._acc[path] = t
                self._dtype[path] = leaf.dtype

    def finalize(self) -> dict:
        if not self._acc:
            return {}
        return unflatten_items({
            p: _finish(self._acc[p] / self.total_w, self._dtype[p])
            for p in self._acc})
