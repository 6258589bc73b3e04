"""Per-stage auxiliary heads for decoupled (async) split learning.

Port of the JAX package's ``ops/auxiliary.py`` (*Decoupled Split
Learning via Auxiliary Loss*, arxiv 2601.19261).  A non-final stage
attaches a small local head to its cut boundary, computes a local
classification loss against the batch's labels (they ride every
Activation frame) and steps right after its forward: the gradient plane
goes dormant, and the wire carries the forward activations and the
round's UPDATE only.

Two heads, selected by ``learning.aux-head``:

* ``pooled-linear`` — every float leaf of the boundary tree is
  mean-pooled in float32 over its axes between batch and feature, the
  leaves concatenated along the feature axis, then one
  ``Dense(num_classes)``;
* ``projection-mlp`` — the same pooling into ``Dense(aux-hidden) ->
  gelu -> Dense(num_classes)`` (flax's ``nn.gelu``, the tanh
  approximation).

A bool or int leaf of the boundary (BERT's padding mask) is skipped.
The head's input width comes from the boundary the shard's forward
produced, so any model and cut works without per-model code.  The head
and its optimizer state are client-local: they never ride an UPDATE,
and they reset when the boundary's shape signature changes (a re-plan
moved the cut, so the old head would probe another tensor).  Parameters
carry to and from the JAX package's ``{"proj": ..., "probe": {"kernel",
"bias"}}`` tree through :mod:`split_learning_torch.convert`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_torch.models.split import Dense

#: classes per dataset — the JAX package's table, kept here
_DATASET_CLASSES = {
    "CIFAR10": 10, "CIFAR100": 100, "MNIST": 10,
    "AGNEWS": 4, "EMOTION": 6, "SPEECHCOMMANDS": 10,
}


def num_classes_for(model_key: str) -> int:
    """Label-space size for a ``{MODEL}_{DATASET}`` registry key.

    Raises for a dataset without a classification label space (a token
    dataset, whose "labels" are token ids): async mode needs one."""
    dataset = model_key.split("_", 1)[1] if "_" in model_key else ""
    try:
        return _DATASET_CLASSES[dataset]
    except KeyError:
        raise ValueError(
            f"learning.mode: async needs a classification label space, "
            f"but dataset {dataset!r} (model key {model_key!r}) has no "
            "registered class count — stay on sync for this workload "
            "or register it in ops/auxiliary._DATASET_CLASSES") from None


def _leaves(boundary) -> list:
    if isinstance(boundary, (list, tuple)):
        return [leaf for b in boundary for leaf in _leaves(b)]
    return [boundary]


def _pool(a: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B, F): mean over every axis between batch and
    feature; a 1-D leaf becomes a (B, 1) column."""
    if a.ndim <= 1:
        return a.reshape(-1, 1)
    if a.ndim == 2:
        return a
    return a.mean(dim=tuple(range(1, a.ndim - 1)))


def _float_leaves(boundary) -> list:
    return [leaf for leaf in _leaves(boundary)
            if leaf.dtype.is_floating_point]


def pooled_width(boundary) -> int:
    """The pooled feature width of a boundary tree (of tensors or
    anything with ``shape`` and ``dtype``)."""
    leaves = _float_leaves(boundary)
    if not leaves:
        raise ValueError(
            "aux head: boundary pytree has no float leaves to probe")
    return sum(1 if len(s.shape) <= 1 else s.shape[-1] for s in leaves)


@dataclasses.dataclass(frozen=True)
class AuxHeadSpec:
    """An aux head's architecture: ``hidden == 0`` is pooled-linear,
    ``hidden > 0`` the projection MLP."""
    num_classes: int
    hidden: int = 0


class AuxHead(nn.Module):
    """Local classification probe on one cut boundary (float32)."""

    def __init__(self, spec: AuxHeadSpec, in_features: int, device=None,
                 generator=None):
        super().__init__()
        self.spec = spec
        self.proj = (Dense(in_features, spec.hidden, device=device,
                           generator=generator) if spec.hidden else None)
        self.probe = Dense(spec.hidden or in_features, spec.num_classes,
                           device=device, generator=generator)

    def forward(self, boundary) -> torch.Tensor:
        feats = [_pool(leaf.float()) for leaf in _float_leaves(boundary)]
        if not feats:
            raise ValueError(
                "aux head: boundary pytree has no float leaves to probe")
        x = feats[0] if len(feats) == 1 else torch.cat(feats, -1)
        if self.proj is not None:
            x = F.gelu(self.proj(x), approximate="tanh")
        return self.probe(x)


def build_aux_head(kind: str, num_classes: int,
                   hidden: int = 64) -> AuxHeadSpec:
    """``learning.aux-head`` -> the head's spec (the vocabulary the
    config validates)."""
    if kind == "pooled-linear":
        return AuxHeadSpec(num_classes=num_classes, hidden=0)
    if kind == "projection-mlp":
        return AuxHeadSpec(num_classes=num_classes, hidden=max(1, hidden))
    raise ValueError(f"unknown aux head kind {kind!r}")


def init_aux_params(spec: AuxHeadSpec, generator: torch.Generator,
                    boundary, device=None) -> AuxHead:
    """A fresh head for ``boundary`` (a tree of tensors, or of anything
    with ``shape`` and ``dtype``), its weights drawn from ``generator``
    (flax ``Dense``'s lecun-normal kernel, zero bias)."""
    return AuxHead(spec, pooled_width(boundary), device=device,
                   generator=generator)


def aux_shapes_signature(boundary) -> tuple:
    """Hashable (shape, dtype) signature of a boundary tree: what the
    client compares to decide whether a re-plan moved the cut (and so
    whether the head and its optimizer state reset)."""
    return tuple((tuple(leaf.shape), str(leaf.dtype))
                 for leaf in _leaves(boundary))
